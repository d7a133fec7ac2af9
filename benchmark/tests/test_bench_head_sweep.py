"""The reader of ``bdia_head_sweep_roofline`` on synthetic traces: it
reads K13's (``bdia_head_sweep_kernel``) launches alone, at 40 / 56 values
a block row on ex19's band, and ``bdia_sweep_roofline`` and
``block_apply_ms`` read K7's (``bdia_sweep_kernel``) alone."""

from types import SimpleNamespace

import pytest

from benchmark.harness.manifest import Cell, load_manifest
from benchmark.metrics import _block_bytes as bb
from blasted_tpu_torch.utils import profiling

CELL = "ex19-cavity-1024-f64.newton"
NB, ITEM = 1024 * 1024, 8


def _name(kernel, upper):
    """The device trace's name of a kernel's f64, bs = 4 instance, cut to
    80 characters as harness/trace.py keeps them."""
    return (f"void (anonymous namespace)::{kernel}<double, 4, "
            f"{'true' if upper else 'false'}>((anonymous namespace)::Sel, "
            "double const*")[:80]


K13_LOWER, K13_UPPER = (_name("bdia_head_sweep_kernel", u)
                        for u in (False, True))
K7_LOWER, K7_UPPER = (_name("bdia_sweep_kernel", u) for u in (False, True))


def _reader(metric):
    return Cell(CELL).reader(metric)


def _run(kernels, trace=True):
    return SimpleNamespace(trace={"kernels": kernels, "systems": 1}
                           if trace else None, rows_per_card=NB,
                           block_size=4, itemsize=ITEM)


def _least(values):
    return bb.least_seconds(values * ITEM, NB)


def test_none_without_a_trace_or_a_launch():
    read = _reader("bdia_head_sweep_roofline")
    assert read(_run({}, trace=False)) is None
    assert read(_run({})) is None
    # a parent without K13: its K7 launches are not read
    assert read(_run({K7_LOWER: [16, 16e-4], K7_UPPER: [16, 16e-4]})) is None
    # one mode alone is not a share of the apply's head
    assert read(_run({K13_LOWER: [4, 4 * _least(40)]})) is None


def test_reads_the_mean_of_the_modes_at_40_and_56_values():
    read = _reader("bdia_head_sweep_roofline")
    got = read(_run({K13_LOWER: [10, 10 * 2 * _least(40)],
                     K13_UPPER: [10, 10 * 4 * _least(56)]}))
    assert got == pytest.approx(37.5)


def test_ignores_k7_and_the_k7_readers_ignore_k13(monkeypatch):
    head = _reader("bdia_head_sweep_roofline")
    k7 = _reader("bdia_sweep_roofline")
    apply_ms = _reader("block_apply_ms")
    k13s = {K13_LOWER: [4, 4 * _least(40)], K13_UPPER: [4, 4 * _least(56)]}
    k7s = {K7_LOWER: [8, 8 * 2 * _least(44)],
           K7_UPPER: [8, 8 * 2 * _least(60)]}
    both = {**k13s, **k7s}
    assert head(_run(k13s)) == pytest.approx(100.0)
    assert head(_run(both)) == pytest.approx(100.0)
    assert k7(_run(both)) == pytest.approx(50.0)
    assert k7(_run(k13s)) is None
    # four apply spans: block_apply_ms counts the K7 seconds alone
    monkeypatch.setattr(profiling, "records", lambda: [SimpleNamespace(
        name="precond.block_apply", end_ns=1)] * 4)
    k7_s = 8 * 2 * (_least(44) + _least(60))
    assert apply_ms(_run(both)) == pytest.approx(1e3 * k7_s / 4)
    assert apply_ms(_run(k13s)) is None


def test_listed_in_the_ex19_cell_beside_bdia_sweep_roofline():
    per_layer = {m["name"]: m for m in load_manifest()["per_layer"]}
    m = per_layer["bdia_head_sweep_roofline"]
    k7 = per_layer["bdia_sweep_roofline"]
    assert m["workloads"] == [CELL]
    assert (m["unit"], m["source"], m["layer"], m["moves"]) \
        == (k7["unit"], k7["source"], k7["layer"], k7["moves"])
    assert [p["name"] for p in load_manifest()["per_layer"]][-1] \
        == "bdia_head_sweep_roofline"
