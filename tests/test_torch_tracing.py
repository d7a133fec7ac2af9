"""The port's spans and counters (``blasted_tpu_torch/utils/profiling.py``,
``ops/_cuda.py::launch_ns``) on the CPU.

Spans record only while a ``torch.profiler`` session records; counters are
always on.  Every test resets both first: they accumulate over a process.
"""

import json

import numpy as np
import pytest
import scipy.sparse
import torch
from torch.profiler import ProfilerActivity, profile

from blasted_tpu_torch import api
from blasted_tpu_torch.apps import poisson3d_system
from blasted_tpu_torch.ops import _cuda
from blasted_tpu_torch.sparse.csr import CSRMatrix
from blasted_tpu_torch.sparse.dia import try_dia_from_csr
from blasted_tpu_torch.utils import profiling
from blasted_tpu_torch.utils.timing import PrecTimers

GRID = (6, 6, 6)
METHODS = {"bicgstab": "ilu0", "cg": "jacobi", "gcr": "ilu0",
           "gmres": "ilu0", "richardson": "ilu0"}


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    _cuda.reset_launches()
    yield
    profiling.reset()
    _cuda.reset_launches()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _solve(method: str, **opts):
    A, b, _ = poisson3d_system(GRID)
    options = {"blasted_pc_type": METHODS[method], "ksp_type": method,
               "blasted_async_sweeps": "4,4", "rtol": 1e-6, "restart": 8,
               **opts}
    return api.solve(A, b, options, device="cpu")


def _named(recs, name):
    return [i for i, r in enumerate(recs) if r.name == name]


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_RecordFunction", refuse)
    assert not torch._C._autograd._profiler_enabled()
    span = profiling.annotate("krylov.iter")
    assert span is profiling.annotate("sync.flag")   # one null context
    with span:
        with profiling.annotate("sync.flag"):
            pass
    x, info, _ = _solve("bicgstab")
    assert info.converged and info.iters > 0
    assert profiling.records() == [] and profiling.dropped() == 0


def test_nested_spans_record_parents_and_request_ids():
    with _recording():
        with profiling.annotate("a"):
            with profiling.annotate("b"):
                with profiling.annotate("c"):
                    pass
            with profiling.annotate("d"):
                pass
        with profiling.annotate("e"):
            pass
    recs = profiling.records()
    assert [r.name for r in recs] == ["a", "b", "c", "d", "e"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0, -1]
    assert [r.request for r in recs] == [0, 0, 0, 0, 1]
    for r in recs:
        assert r.end_ns is not None and r.start_ns <= r.end_ns
    a, b, c, d, _ = recs
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns <= d.end_ns <= a.end_ns


def test_a_span_left_by_an_exception_is_closed():
    with _recording():
        with pytest.raises(ValueError):
            with profiling.annotate("outer"):
                raise ValueError("x")
        with profiling.annotate("next"):
            pass
    outer, nxt = profiling.records()
    assert outer.end_ns is not None
    assert nxt.parent == -1 and nxt.request == 1


@pytest.mark.parametrize("method", sorted(METHODS))
def test_one_iteration_span_and_one_flag_read_per_counted_iteration(method):
    with _recording():
        x, info, _ = _solve(method)
    assert info.converged
    recs = profiling.records()
    solves = _named(recs, "krylov.solve")
    iters = _named(recs, "krylov.iter")
    flags = _named(recs, "sync.flag")
    assert len(solves) == 1
    # Richardson's pass that finds convergence is not a counted step
    extra = 1 if method == "richardson" else 0
    assert len(iters) == len(flags) == info.iters + extra
    assert all(recs[i].parent == solves[0] for i in iters)
    assert sorted(recs[i].parent for i in flags) == iters
    result = _named(recs, "sync.result")
    assert [recs[i].parent for i in result] == solves
    # an iteration holds no span but its flag read
    assert all(r.name == "sync.flag" for r in recs
               if r.parent >= 0 and recs[r.parent].name == "krylov.iter")


def test_set_up_and_value_update_spans():
    A, b, _ = poisson3d_system(GRID)
    with _recording():
        x, info, ctx = api.solve(A, b, {"blasted_pc_type": "ilu0",
                                        "rtol": 1e-8}, device="cpu")
        ctx.prec.update_values(ctx.prec.mat.data * 2.0)
        api.compute_preconditioner(ctx)
    names = [r.name for r in profiling.records()]
    assert names.count("precond.compute") == 2
    assert names.count("precond.update") == 1
    # the factor's timers synchronise inside their own spans
    compute = _named(profiling.records(), "precond.compute")
    timers = _named(profiling.records(), "sync.timers")
    assert len(timers) == 4
    assert {profiling.records()[i].parent for i in timers} == set(compute)


def test_timer_spans_name_their_synchronisations():
    t = PrecTimers()
    with _recording():
        with t.time_apply(torch.device("cpu")):
            pass
    assert [r.name for r in profiling.records()] == ["sync.timers"] * 2
    assert t.apply_calls == 1


def test_spans_are_user_annotations_in_the_chrome_trace(tmp_path):
    """Each span is one of the profiler's own events in the Chrome trace
    that ``profiling.trace`` writes: a record function entered from C++,
    which the trace files under ``cpu_op``, not ``user_annotation``."""
    with profiling.trace(str(tmp_path)):
        x, info, _ = _solve("bicgstab")
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = {"krylov.solve", "krylov.iter", "sync.flag", "sync.result",
             "precond.compute", "sync.timers"}
    names = [e["name"] for e in events if e.get("name") in spans]
    assert {e["cat"] for e in events if e.get("name") in spans} == \
        {"cpu_op"}
    assert set(names) == spans
    assert names.count("krylov.iter") == info.iters
    assert len(profiling.records()) == len(names)


def test_reset_clears_records_drops_and_counters(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with _recording():
        for _ in range(5):
            with profiling.annotate("s"):
                pass
    assert len(profiling.records()) == 3 and profiling.dropped() == 2
    profiling.count("setup.precond")
    profiling.reset()
    assert profiling.records() == [] and profiling.dropped() == 0
    assert profiling.counters == {}
    with _recording():
        with profiling.annotate("s"):
            pass
    assert profiling.records()[0].request == 0


def test_set_up_moves_its_counters():
    A, b, _ = poisson3d_system(GRID)
    assert try_dia_from_csr(A, device="cpu") is not None
    assert profiling.counters["setup.dia_from_csr"] == 1
    assert profiling.counters["setup.dia_from_csr_s"] > 0
    assert "setup.precond" not in profiling.counters
    api.solve(A, b, {"blasted_pc_type": "ilu0"}, device="cpu")
    assert profiling.counters["setup.dia_from_csr"] == 2
    assert profiling.counters["setup.precond"] == 1
    assert profiling.counters["setup.precond_s"] > 0


def test_the_first_factor_counts_as_set_up():
    A, _, _ = poisson3d_system(GRID)
    ctx = api.setup_local_preconditioner(A, {"blasted_pc_type": "ilu0"},
                                         device="cpu")
    alone = profiling.counters["setup.precond_s"]
    api.compute_preconditioner(ctx)
    first = profiling.counters["setup.precond_s"]
    assert first > alone
    api.compute_preconditioner(ctx)                 # a re-factor is not
    assert profiling.counters["setup.precond_s"] == first
    assert profiling.counters["setup.precond"] == 1


def test_a_matrix_that_is_not_banded_still_counts():
    rng = np.random.default_rng(3)
    n = 80
    dense = np.eye(n) * 4.0
    dense[rng.integers(0, n, 70), rng.integers(0, n, 70)] = 1.0
    A = CSRMatrix.from_scipy(scipy.sparse.csr_matrix(dense))
    assert try_dia_from_csr(A, device="cpu", max_diags=2) is None
    assert profiling.counters["setup.dia_from_csr"] == 1


class _StubLibrary:
    """Every C entry point returns cudaSuccess."""

    def __getattr__(self, entry):
        return lambda *args: 0


def test_launch_time_is_summed_and_cleared(monkeypatch):
    x, info, _ = _solve("bicgstab")     # the CPU twins launch nothing
    assert set(_cuda.launch_ns.values()) == {0}
    monkeypatch.setattr(_cuda, "kernels_library", lambda: _StubLibrary())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    for _ in range(3):
        _cuda.launch("tri_sweep", "bt_tri_sweep", torch.device("cuda", 0))
    assert _cuda.launches["tri_sweep"] == 3
    assert _cuda.launch_ns["tri_sweep"] > 0
    assert set(_cuda.launch_ns) == set(_cuda.launches)
    _cuda.reset_launches()
    assert set(_cuda.launch_ns.values()) == {0}


def test_trace_cell_charges_each_gap_to_the_innermost_span_open():
    """``scripts/trace_cell.py`` splits the idle time of a Chrome trace by
    the benchmark's span and, within each, by the program's."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts/trace_cell.py"
    spec = importlib.util.spec_from_file_location("trace_cell", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def ev(cat, ts, dur, name="k"):
        return {"cat": cat, "ts": ts, "dur": dur, "name": name}

    events = [ev("kernel", 0, 10), ev("gpu_memset", 20, 10),
              ev("kernel", 50, 5), ev("gpu_memcpy", 70, 5),
              ev("kernel", 120, 5), ev("kernel", 140, 5),
              ev("kernel", 150, 5),
              ev("user_annotation", 0, 100, "bench.krylov"),
              ev("cpu_op", 1, 90, "krylov.solve"),
              ev("cpu_op", 5, 40, "krylov.iter"),
              ev("cpu_op", 25, 15, "sync.flag"),
              ev("cpu_op", 45, 27, "krylov.iter"),
              ev("cpu_op", 56, 2, "aten::mul"),
              ev("user_annotation", 110, 40, "bench.factor"),
              ev("cpu_op", 111, 38, "precond.compute"),
              ev("cpu_op", 144, 5, "sync.timers")]
    got = mod.idle_split(events, {"krylov.solve", "krylov.iter",
                                  "sync.flag", "precond.compute",
                                  "sync.timers"})
    assert got["device_ops"] == 7
    assert got["busy_s"] == pytest.approx(45e-6)
    # gaps 10-20 and 55-70 in krylov.iter (aten::mul is no program span),
    # 30-50 in sync.flag, 75-120 in krylov.solve after its last iteration
    # but in bench.krylov until 100; 125-140 in precond.compute, 145-150
    # in sync.timers
    assert got["idle_by_bench_span"] == pytest.approx(
        {"bench.krylov": 90e-6, "bench.factor": 20e-6})
    assert got["idle_by_program_span"] == {
        "bench.krylov": pytest.approx({"krylov.iter": 25e-6,
                                       "sync.flag": 20e-6,
                                       "krylov.solve": 45e-6}),
        "bench.factor": pytest.approx({"precond.compute": 15e-6,
                                       "sync.timers": 5e-6})}
