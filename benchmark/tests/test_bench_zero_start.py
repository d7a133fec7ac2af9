"""The reader of ``zero_start_sweep_roofline`` on synthetic traces: it
reads K12's (``zero_start_sweep_kernel``) launches alone, at 5.5 streams a
launch, and ``tri_sweep_roofline`` reads K2's alone."""

from types import SimpleNamespace

import pytest

from benchmark.harness.manifest import Cell, load_manifest
from benchmark.metrics._bytes import HBM_BYTES_PER_S

CELLS = ("bratu3d-256-f32.newton", "bratu3d-256-f32.lagged")
N = 256 ** 3
# the device trace's names of the kernels' f32 instances, cut to 80
# characters as harness/trace.py keeps them
K12_LOWER = ("void (anonymous namespace)::zero_start_sweep_kernel<float, "
             "false>(bt::Offsets, f")[:80]
K12_UPPER = ("void (anonymous namespace)::zero_start_sweep_kernel<float, "
             "true>(bt::Offsets, fl")[:80]
K2 = ("void (anonymous namespace)::tri_sweep_kernel<float>(bt::Offsets, "
      "float const*, float")[:80]


def _reader(metric):
    return Cell(CELLS[1]).reader(metric)


def _run(kernels, trace=True):
    return SimpleNamespace(trace={"kernels": kernels} if trace else None,
                           rows_per_card=N, itemsize=4)


def test_none_without_a_trace_or_a_launch():
    read = _reader("zero_start_sweep_roofline")
    assert read(_run({}, trace=False)) is None
    assert read(_run({})) is None
    # a parent without K12: its K2 launches are not read
    assert read(_run({K2: [16, 16 * 200e-6]})) is None


def test_reads_five_and_a_half_streams_a_launch():
    read = _reader("zero_start_sweep_roofline")
    least = 5.5 * N * 4 / HBM_BYTES_PER_S
    # one lower and one upper launch an apply; their mean time is 2·least
    got = read(_run({K12_LOWER: [10, 10 * 1.5 * least],
                     K12_UPPER: [10, 10 * 2.5 * least]}))
    assert got == pytest.approx(50.0)


def test_ignores_k2_and_k2_ignores_k12():
    zs = _reader("zero_start_sweep_roofline")
    k2 = _reader("tri_sweep_roofline")
    least12 = 5.5 * N * 4 / HBM_BYTES_PER_S
    least2 = 6.5 * N * 4 / HBM_BYTES_PER_S
    base = {K12_LOWER: [4, 4 * least12], K12_UPPER: [4, 4 * least12]}
    both = {**base, K2: [8, 8 * 4 * least2]}
    assert zs(_run(base)) == pytest.approx(100.0)
    assert zs(_run(both)) == pytest.approx(100.0)
    assert k2(_run(both)) == pytest.approx(25.0)
    assert k2(_run(base)) is None


def test_listed_in_both_cells_beside_tri_sweep_roofline():
    per_layer = {m["name"]: m for m in load_manifest()["per_layer"]}
    m = per_layer["zero_start_sweep_roofline"]
    k2 = per_layer["tri_sweep_roofline"]
    assert m["workloads"] == list(CELLS)
    assert (m["unit"], m["source"], m["layer"], m["moves"]) \
        == (k2["unit"], k2["source"], k2["layer"], k2["moves"])
