"""The card check's kernel table (``chip_smoke.py``'s ``KERNELS``) held on
the CPU: one entry per launch name of ``ops/_cuda.py``, each entry's cases
run through the check loop on its family's operands at a tiny size (on a
CPU tensor each wrapper runs its twin, so the cases must agree to the
bit: this holds the operand builders and the calls), its work model and
its library yardstick; and the byte models beside the benchmark's frozen
copies (``benchmark/metrics/_bytes.py``, ``_block_bytes.py``).

The kernels themselves run only on the card, where ``python3
chip_smoke.py`` runs the same loop at the main paths' shapes."""

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark.metrics import _block_bytes, _bytes
from blasted_tpu_torch.apps import poisson3d_system
from blasted_tpu_torch.ops import _cuda

F64 = torch.float64


def _operands(family: str):
    """Each operand set of ``family`` at the test's tiny sizes."""
    if family == "band":
        return [chip_smoke.band_operands(6, F64, "cpu", 1)]
    if family == "block":
        return [chip_smoke.block_operands(4, bs, F64, "cpu", 3)
                for bs in (2, 4)] + [
            chip_smoke.star_operands(6, 4, F64, "cpu", 19)]
    A, _, _ = poisson3d_system((6, 6, 6))
    B, _ = chip_smoke.block_system(4, 2, np.float64, seed=43)
    return [chip_smoke.padded_operands(chip_smoke.padded_prep(M, label),
                                       "cpu", 45)
            for label, M in (("csr", A), ("bsr", B))]


@pytest.mark.parametrize("name", list(_cuda.KERNEL_SOURCES))
def test_each_launch_name_has_one_entry_held_on_the_cpu(name):
    assert list(chip_smoke.KERNELS) == list(_cuda.KERNEL_SOURCES)
    k = chip_smoke.KERNELS[name]
    assert callable(k.library) or (isinstance(k.library, str)
                                   and k.library)
    for op in _operands(k.family):
        (rec,) = chip_smoke.check_family(k.family, op, only=(name,),
                                         say=None).values()
        assert rec["max_abs_err"] == 0.0, rec
        nbytes, flops = k.work(op)
        assert nbytes > 0 and flops > 0
        if k.lower:
            assert min(k.lower(op)) > 0
        if callable(k.library):
            assert callable(k.library(op))


def _band_bytes(kernel: str):
    op = chip_smoke.band_operands(6, F64, "cpu", 1)
    n, isz = 6 ** 3, 8
    k = chip_smoke.KERNELS[kernel.split(".")[0]]
    got = k.lower(op)[0] if kernel == "tri_sweep.lower" else k.work(op)[0]
    return got, _bytes.STREAMS[kernel] * n * isz


def _block_models(name: str, op) -> int:
    """``_block_bytes``' bytes of one launch on ``op``'s block band."""
    k, b2, nb = op["data"].shape
    bs, isz = int(round(b2 ** 0.5)), op["data"].element_size()
    values = {
        "bspmv": _block_bytes.spmv_values(k, bs),
        "bfactor_dinv": _block_bytes.factor_values(len(op["pair_offs"]), bs),
        "bfactor_u0": _block_bytes.factor_values(len(op["pair_offs"]), bs),
        "bdia_lower_sweep": _block_bytes.sweep_values("lower",
                                                      len(op["lo"]), bs),
        "bdia_upper_sweep": _block_bytes.sweep_values("upper",
                                                      len(op["up"]), bs),
    }
    if name == "block_inverse":
        return _block_bytes.inverse_bytes(bs, isz) * nb
    return values[name] * nb * isz


@pytest.mark.parametrize("kernel", ["tri_sweep.upper", "tri_sweep.lower",
                                    "plain_factor_sweep"])
def test_band_byte_models_match_the_benchmark(kernel):
    got, want = _band_bytes(kernel)
    assert got == want


@pytest.mark.parametrize("name", ["bspmv", "bfactor_dinv", "bfactor_u0",
                                  "bdia_lower_sweep", "bdia_upper_sweep",
                                  "block_inverse"])
def test_block_byte_models_match_the_benchmark(name):
    """At ex19's 5-point star (``_block_bytes.STAR5``) and on the 7-point
    block band of the [kernel] records."""
    star = chip_smoke.star_operands(6, 4, F64, "cpu", 19)
    assert (star["data"].shape[0], len(star["lo"]), len(star["up"]),
            len(star["pair_offs"])) == tuple(_block_bytes.STAR5.values())
    for op in (star, chip_smoke.block_operands(4, 4, torch.float32, "cpu",
                                               3)):
        assert chip_smoke.KERNELS[name].work(op)[0] == _block_models(name, op)
