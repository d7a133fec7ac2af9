"""The ex19 cell (``ex19-cavity-1024-f64.newton``) on the CPU: the faults
that must make ``correct`` false, the frozen block byte models against the
kernel table's bounds, the mix's start at step 0, and the block-path
readers on synthetic traces and against a program without the block
spans and counters."""

import math
from types import SimpleNamespace

import pytest
import torch

import blasted_tpu_torch.solvers as solvers
from benchmark.harness.manifest import Cell, load_manifest
from benchmark.metrics import _block_bytes as bb
from blasted_tpu_torch.ops import _cuda
from blasted_tpu_torch.utils import profiling

from .helpers import rehearse, tiny_cell

CELL = "ex19-cavity-1024-f64.newton"
METRICS = ("block_krylov_iters", "block_apply_ms", "block_factor_ms",
           "bdia_from_bsr_s", "bdia_spmv_roofline", "bdia_sweep_roofline",
           "bdia_factor_roofline", "bdia_inverse_roofline")
#: No device trace on the CPU.
CARD_ONLY = ("block_apply_ms", "bdia_spmv_roofline", "bdia_sweep_roofline",
             "bdia_factor_roofline", "bdia_inverse_roofline")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    _cuda.reset_launches()
    yield
    profiling.reset()
    _cuda.reset_launches()


def _half(x):
    y = x.clone()
    y[x.shape[0] // 2:] = 0
    return y


FAULTS = {
    "state_unchanged": lambda x, x0: x0,
    "half_left_out": lambda x, x0: _half(x),
    "answer_altered": lambda x, x0: x * 1.01,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_answer_is_not_correct(monkeypatch, fault):
    real = solvers.bicgstab

    def broken(amat, prec, b, x0, **kw):
        x, info = real(amat, prec, b, x0, **kw)
        return FAULTS[fault](x, x0), info

    monkeypatch.setattr(solvers, "bicgstab", broken)
    _, out = rehearse(tiny_cell(CELL))
    assert not out["correct"], out["checks"]
    assert out["checks"]["relres_max"][0] > out["checks"]["relres_max"][1]


def test_refactor_that_keeps_the_old_factor(monkeypatch):
    """A re-factor that returns the state unchanged: the applies read
    set-up's factor of step 0 in every later step."""
    from blasted_tpu_torch import api

    calls = {"n": 0}
    real = api.compute_preconditioner

    def stale(ctx):
        calls["n"] += 1
        return real(ctx) if calls["n"] <= 1 else None

    monkeypatch.setattr(api, "compute_preconditioner", stale)
    _, out = rehearse(tiny_cell(CELL))
    assert not out["correct"], out["checks"]
    gap, limit = out["checks"]["factor_gap_max"]
    assert gap > limit


def test_float32_factor_is_not_correct():
    """The program's own lower-precision path, the factor kept in float32
    under float64 vectors, fails the factor gap."""
    cell = tiny_cell(CELL)
    cell.config["options"]["blasted_apply_dtype"] = "float32"
    _, out = rehearse(cell)
    assert not out["correct"]
    gap, limit = out["checks"]["factor_gap_max"]
    assert gap > 10 * limit


def test_block_bytes_are_the_kernel_tables_bounds():
    """PERF.md's kernel table, bs = 4, nb = 2,097,152 block rows, float32
    at 3.35 TB/s, on its 7-point block band (7 block diagonals, 3 lower, 3
    upper, 3 pairs): K5 300.5, K7 lower 150.2, upper 190.3, K6 360.6 and
    the block inverse 80.8 µs."""
    nb, bs, item = 2_097_152, 4, 4

    def us(values):
        return bb.least_seconds(values * item, nb) * 1e6

    assert us(bb.spmv_values(7, bs)) == pytest.approx(300.5, abs=0.05)
    assert us(bb.sweep_values("lower", 3, bs)) \
        == pytest.approx(150.2, abs=0.05)
    assert us(bb.sweep_values("upper", 3, bs)) \
        == pytest.approx(190.3, abs=0.05)
    assert us(bb.factor_values(3, bs)) == pytest.approx(360.6, abs=0.05)
    assert bb.least_seconds(bb.inverse_bytes(bs, item), nb) * 1e6 \
        == pytest.approx(80.8, abs=0.05)
    # ex19's band: 88, 44, 60, 112 values and 32 values of the inverse
    star = bb.STAR5
    assert (bb.spmv_values(star["diags"], bs),
            bb.sweep_values("lower", star["lowers"], bs),
            bb.sweep_values("upper", star["uppers"], bs),
            bb.factor_values(star["pairs"], bs)) == (88, 44, 60, 112)
    assert bb.inverse_bytes(bs, 8) == 32 * 8 + 1


def test_every_seed_starts_at_step_zero():
    cell = tiny_cell(CELL)
    problem = cell.problem()
    pools = [problem.Inputs(cell.config, cell.mix, s, "cpu")
             for s in (1, 2, 3, 2 ** 31 + 5, -3)]
    first = pools[0]
    assert first.slots >= 3
    for p in pools:
        assert [p.slot(i) for i in range(2 * p.slots)] \
            == [i % p.slots for i in range(2 * p.slots)]
        assert all(torch.equal(a, b) for a, b in zip(p.iterates,
                                                     first.iterates))


def test_the_new_metrics_read_from_a_traced_rehearsal():
    cell = tiny_cell(CELL)
    run, out = rehearse(cell, trace=True)
    assert out["correct"]
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    for metric in METRICS:
        got = cell.reader(metric)(run)
        if metric in CARD_ONLY:
            assert got is None, metric
        else:
            assert got is not None and math.isfinite(got) and got > 0, \
                (metric, got)
    recs = profiling.records()
    names = {r.name for r in recs}
    assert {"precond.block_factor", "precond.block_inverse",
            "precond.block_apply"} <= names
    # two applies an iteration, each a span and a count
    solves = [i for i, r in enumerate(recs) if r.name == "krylov.solve"]
    iters = sum(1 for r in recs if r.name == "krylov.iter")
    applies = sum(1 for r in recs if r.name == "precond.block_apply")
    assert len(solves) == run.trace["systems"] and applies == 2 * iters
    assert profiling.counters["precond.block_apply"] >= applies
    assert profiling.counters["setup.bdia_from_bsr"] == 1


def _synthetic(kernels, trace=True):
    return SimpleNamespace(trace={"kernels": kernels, "systems": 1}
                           if trace else None, rows_per_card=1024 * 1024,
                           block_size=4, itemsize=8, iters=[10])


def _name(kernel, args):
    return (f"void (anonymous namespace)::{kernel}<double, 4{args}>("
            "bt::Offsets, double const*, double")[:80]


def test_rooflines_read_their_own_kernels():
    nb, item = 1024 * 1024, 8
    cell = Cell(CELL)
    least = {
        "spmv": bb.least_seconds(88 * item, nb),
        "lower": bb.least_seconds(44 * item, nb),
        "upper": bb.least_seconds(60 * item, nb),
        "factor": bb.least_seconds(112 * item, nb),
        "inverse": bb.least_seconds(32 * item + 1, nb),
    }
    kernels = {
        _name("bdia_spmv_kernel", ""): [4, 4 * 2 * least["spmv"]],
        _name("bdia_sweep_kernel", ", false"): [8, 8 * 2 * least["lower"]],
        _name("bdia_sweep_kernel", ", true"): [8, 8 * 4 * least["upper"]],
        _name("bdia_factor_kernel", ", true"): [7, 7 * 2 * least["factor"]],
        _name("bdia_factor_kernel", ", false"): [1, 2 * least["factor"]],
        _name("bdia_block_inverse_kernel", ""): [2, 2 * 4 * least["inverse"]],
        # the scalar route's kernels are not read
        _name("tri_sweep_kernel", ""): [5, 1.0],
    }
    run = _synthetic(kernels)
    got = {m: cell.reader(m)(run) for m in
           ("bdia_spmv_roofline", "bdia_sweep_roofline",
            "bdia_factor_roofline", "bdia_inverse_roofline")}
    assert got == pytest.approx({"bdia_spmv_roofline": 50.0,
                                 "bdia_sweep_roofline": 37.5,
                                 "bdia_factor_roofline": 50.0,
                                 "bdia_inverse_roofline": 25.0})
    for metric in got:
        assert cell.reader(metric)(_synthetic({})) is None
        assert cell.reader(metric)(_synthetic(kernels, trace=False)) is None


def test_readers_give_none_against_a_program_without_the_block_spans(
        monkeypatch):
    """The benchmark laid over a program older than the block spans and
    counters: those readers give None and none raises."""
    cell = tiny_cell(CELL)
    run, _ = rehearse(cell, trace=True)
    profiling.reset()           # no block records, no counters
    for metric in ("block_apply_ms", "block_factor_ms", "bdia_from_bsr_s"):
        assert cell.reader(metric)(run) is None, metric
    for attr in ("records", "counters"):
        monkeypatch.delattr(profiling, attr)
    for metric in ("block_apply_ms", "block_factor_ms", "bdia_from_bsr_s"):
        assert cell.reader(metric)(run) is None, metric


def test_the_manifest_lists_the_new_metrics_in_the_cell_alone():
    man = load_manifest()
    per_layer = {m["name"]: m for m in man["per_layer"]}
    for metric in METRICS:
        m = per_layer[metric]
        assert m["workloads"] == [CELL]
        assert m["moves"] == ("setup_s" if metric == "bdia_from_bsr_s"
                              else "system_ms")
        if metric.endswith("_roofline"):
            assert (m["unit"], m["source"], m["layer"]) \
                == ("%", "device_trace", "kernels")
    cell = {w["name"]: w for w in man["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) \
        == ("ex19-cavity-1024-f64", "cavity_newton", 1)
