"""The reader of ``krylov_update_roofline`` on synthetic traces: it reads
K14's three passes (``krylov_p_update_kernel``, ``krylov_s_update_kernel``,
``krylov_xr_update_kernel``) at 4 + 3 + 7 streams an iteration, over
``rows_per_card · block_size`` values, and nothing without all three."""

from types import SimpleNamespace

import pytest

from benchmark.harness.manifest import Cell, load_manifest
from benchmark.metrics._bytes import HBM_BYTES_PER_S

# the cells that list the metric: the Bratu cells, whose f32 vectors exceed
# the card's L2
CELLS = ("bratu3d-256-f32.newton", "bratu3d-256-f32.lagged")
EX19 = "ex19-cavity-1024-f64.newton"
# (rows_per_card, block_size, itemsize, C type) of the Bratu and ex19 cells
SHAPES = {1: (256 ** 3, 1, 4, "float"), 4: (1024 ** 2, 4, 8, "double")}


def _name(kernel, ctype, width):
    """The device trace's name of a K14 instance, cut to 80 characters as
    harness/trace.py keeps them."""
    return (f"void (anonymous namespace)::{kernel}<{ctype}, {width}>("
            f"{ctype} const*, {ctype} const*, {ctype} const*")[:80]


def _run(kernels, block_size, trace=True):
    rows, bs, isz, _ = SHAPES[block_size]
    return SimpleNamespace(trace={"kernels": kernels} if trace else None,
                           rows_per_card=rows, block_size=bs, itemsize=isz)


def _least(block_size, streams):
    rows, bs, isz, _ = SHAPES[block_size]
    return streams * rows * bs * isz / HBM_BYTES_PER_S


def _kernels(block_size, share_of):
    """Launches of the three passes, each taking its least time over
    ``share_of[pass]`` (10 launches a pass)."""
    ctype = SHAPES[block_size][3]
    width = 16 // SHAPES[block_size][2]
    return {_name(f"krylov_{k}_update_kernel", ctype, width):
            [10, 10 * _least(block_size, streams) / share_of[k]]
            for k, streams in (("p", 4), ("s", 3), ("xr", 7))}


def _reader():
    return Cell(CELLS[0]).reader("krylov_update_roofline")


@pytest.mark.parametrize("block_size", [1, 4])
def test_reads_fourteen_streams_over_the_three_mean_times(block_size):
    read = _reader()
    full = _kernels(block_size, {"p": 1.0, "s": 1.0, "xr": 1.0})
    assert read(_run(full, block_size)) == pytest.approx(100.0)
    # each pass at half its bound: 50%; the xr pass alone slower by 2x of
    # its 7 streams' time: 14 / (4 + 3 + 14) of the bound
    half = _kernels(block_size, {"p": 0.5, "s": 0.5, "xr": 0.5})
    assert read(_run(half, block_size)) == pytest.approx(50.0)
    slow = _kernels(block_size, {"p": 1.0, "s": 1.0, "xr": 0.5})
    assert read(_run(slow, block_size)) == pytest.approx(100.0 * 14 / 21)


@pytest.mark.parametrize("block_size", [1, 4])
def test_the_unaligned_instances_count_with_the_vector_ones(block_size):
    """A launch on unaligned operands is the same kernel with one value a
    step (``<T, 1>``): its time joins its pass's mean."""
    read = _reader()
    ctype = SHAPES[block_size][3]
    kernels = _kernels(block_size, {"p": 1.0, "s": 1.0, "xr": 1.0})
    slow_p = _name("krylov_p_update_kernel", ctype, 1)
    kernels[slow_p] = [10, 10 * 3 * _least(block_size, 4)]
    # the p pass's mean: (1 + 3) / 2 of its least time
    want = 100.0 * 14 / (4 * 2 + 3 + 7)
    assert read(_run(kernels, block_size)) == pytest.approx(want)


@pytest.mark.parametrize("block_size", [1, 4])
def test_none_without_a_trace_or_any_of_the_three(block_size):
    read = _reader()
    full = _kernels(block_size, {"p": 1.0, "s": 1.0, "xr": 1.0})
    assert read(_run(full, block_size, trace=False)) is None
    assert read(_run({}, block_size)) is None
    for drop in list(full):
        assert read(_run({k: v for k, v in full.items() if k != drop},
                         block_size)) is None
    # a parent without K14: torch's elementwise kernels are not read
    torch_ops = {"void at::native::elementwise_kernel<128, 2, at::native::gpu_"
                 "kernel_impl_nocast": [100, 1e-2],
                 "void at::native::vectorized_elementwise_kernel<4, at::nati"
                 "ve::CUDAFunctor_add": [100, 1e-2]}
    assert read(_run(torch_ops, block_size)) is None


def test_listed_in_the_bratu_cells_beside_krylov_iters():
    """Listed, in the Krylov layer, in the two Bratu cells; not in ex19's,
    whose f64 vectors fit the L2, where the HBM bound does not hold."""
    per_layer = {m["name"]: m for m in load_manifest()["per_layer"]}
    m = per_layer["krylov_update_roofline"]
    assert m["workloads"] == list(CELLS)
    assert (m["unit"], m["source"], m["layer"], m["moves"]) \
        == ("%", "device_trace", per_layer["krylov_iters"]["layer"],
            "system_ms")
    for cell in CELLS:
        assert "krylov_update_roofline" in [
            p["name"] for p in Cell(cell).per_layer]
    assert "krylov_update_roofline" not in [
        p["name"] for p in Cell(EX19).per_layer]
