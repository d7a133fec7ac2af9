"""Kernels K7 (the block ILU(0) apply sweep, both modes) and K8 (the plain
scalar Chow–Patel factor sweep) of the PyTorch port, which the JAX package
leaves to XLA: each plain twin (what a CPU tensor runs) against the JAX
function on the same numpy inputs made from a seed, in float64, to 1e-13
of the largest magnitude (the twins run JAX's operations in JAX's order;
the bound leaves room only for the last bits of a different summation
tree, which no case here uses); K12 (the zero-start sweep: K2's first two
sweeps of an ILU(0) apply chain from zero in one launch), whose twin is
K2's from the first sweep's known iterate, and K13, its block counterpart
over K7; the wrappers' contracts; the
pair table built once per preconditioner; and the slice end to end (the
scalar and block ILU(0) preconditioners against JAX's, the scalar apply
through K12).

The CUDA kernels themselves only run on the card; ``chip_smoke.py`` holds
each against its twin there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasted_tpu.config import FactInit as JFactInit
from blasted_tpu.ops.bdia import soa_unit_lower_sweep as jax_lower_sweep
from blasted_tpu.ops.bdia import soa_upper_solve_sweep as jax_upper_sweep
from blasted_tpu.precond.bdia_ilu0 import BlockDiaILU0Preconditioner as JaxBILU
from blasted_tpu.precond.dia_ilu0 import DiaILU0Preconditioner as JaxDiaILU0
from blasted_tpu.precond.dia_ilu0 import dia_factor_sweep as jax_sweep
from blasted_tpu.precond.dia_ilu0 import dia_factor_sweep_tuple as jax_sweep_t
from blasted_tpu.precond.dia_ilu0 import dia_pairs as jax_pairs
from blasted_tpu.sparse.bdia import bdia_from_bsr as jax_bdia_from_bsr
from blasted_tpu.sparse.bsr import BSRMatrix as JaxBSRMatrix
from blasted_tpu.sparse.dia import dia_from_csr as jax_dia_from_csr
from blasted_tpu_torch.apps import poisson3d_system
from blasted_tpu_torch.config import AsyncSolverSettings, FactInit, PrecType
from blasted_tpu_torch.ops import _cuda, bstencil, stencil
from blasted_tpu_torch.ops.bdia import (
    soa_unit_lower_sweep,
    soa_upper_solve_sweep,
)
from blasted_tpu_torch.parallel import make_mesh
from blasted_tpu_torch.parallel.dist_dia import DistDiaSolver
from blasted_tpu_torch.precond import (
    BlockDiaILU0Preconditioner,
    DiaILU0Preconditioner,
)
from blasted_tpu_torch.precond.dia_ilu0 import dia_factor_sweep, dia_pairs
from blasted_tpu_torch.sparse import BSRMatrix, bdia_from_bsr, dia_from_csr
from test_torch_bdia import block_poisson_arrays

RTOL = 1e-13      # max |port − JAX| / max |JAX|, float64

# the 7-point band of a 4³ grid, and an RCM-style band of 11 diagonals
# whose lower diagonals carry fill pairs too (a bandwidth-reduced
# unstructured matrix); its outermost upper has no pair and passes through
BANDS = {"7pt": (-16, -4, -1, 0, 1, 4, 16),
         "rcm": (-9, -7, -4, -3, -1, 0, 1, 2, 3, 5, 9)}
N = 64            # rows (block rows) of every band


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= RTOL * scale, (
        np.abs(got - want).max(), scale)


def _mask(offsets, rng):
    """Structural masks: zero outside [0, N) for each diagonal, and a few
    random holes (band fill outside the pattern)."""
    r = np.arange(N)
    mask = np.stack([(r + o >= 0) & (r + o < N) for o in offsets])
    holes = rng.random(mask.shape) < 0.1
    holes[offsets.index(0)] = False
    return mask & ~holes


# ------------------------------------------------------------------ K7 ----

def _block_operands(offsets, bs, seed):
    rng = np.random.default_rng(seed)
    k = len(offsets)
    mask = _mask(offsets, rng)
    data = 0.3 * rng.standard_normal((k, bs * bs, N)) * mask[:, None, :]
    dinv = 0.5 * rng.standard_normal((bs * bs, N))
    z = rng.standard_normal((bs, N))
    y = rng.standard_normal((bs, N))
    return data, dinv, z, y


def _sel(offsets, side, which):
    if which == "empty":
        return []
    return [d for d, o in enumerate(offsets) if (o < 0 if side == "lower"
                                                 else o > 0)]


def _jcols(a):
    return tuple(jnp.asarray(c) for c in a)


@pytest.mark.parametrize("which", ["band", "empty"])
@pytest.mark.parametrize("band", sorted(BANDS))
@pytest.mark.parametrize("bs", [2, 4, 5])
def test_k7_lower_twin_matches_jax(bs, band, which):
    offsets = BANDS[band]
    data, _, z, y = _block_operands(offsets, bs, seed=bs)
    lower = _sel(offsets, "lower", which)
    got = bstencil.bdia_lower_sweep_stencil(
        torch.from_numpy(data), offsets, lower, torch.from_numpy(z),
        torch.from_numpy(y))
    want = jax_lower_sweep(tuple(_jcols(d) for d in data), offsets, lower,
                           _jcols(z), _jcols(y), bs)
    _close(got.numpy(), np.stack([np.asarray(c) for c in want]))


@pytest.mark.parametrize("which", ["band", "empty"])
@pytest.mark.parametrize("band", sorted(BANDS))
@pytest.mark.parametrize("bs", [2, 4, 5])
def test_k7_upper_twin_matches_jax(bs, band, which):
    offsets = BANDS[band]
    data, dinv, z, y = _block_operands(offsets, bs, seed=10 + bs)
    upper = _sel(offsets, "upper", which)
    got = bstencil.bdia_upper_sweep_stencil(
        torch.from_numpy(data), torch.from_numpy(dinv), offsets, upper,
        torch.from_numpy(y), torch.from_numpy(z))
    want = jax_upper_sweep(tuple(_jcols(d) for d in data), _jcols(dinv),
                           offsets, upper, _jcols(y), _jcols(z), bs)
    _close(got.numpy(), np.stack([np.asarray(c) for c in want]))


# ------------------------------------------------------------------ K8 ----

def _scalar_operands(offsets, seed):
    """A band, its masks, and an iterate with exact zeros on the diagonal
    (the 0 → 1 guard)."""
    rng = np.random.default_rng(seed)
    mask = _mask(offsets, rng)
    d0 = offsets.index(0)
    base = 0.3 * rng.standard_normal((len(offsets), N)) * mask
    base[d0] += 4.0
    ilu = base + 0.05 * rng.standard_normal(base.shape) * mask
    ilu[d0, ::7] = 0.0
    return mask, base, ilu


@pytest.mark.parametrize("masks", ["none_rows", "every_row"])
@pytest.mark.parametrize("band", sorted(BANDS))
def test_k8_tuple_twin_matches_jax(band, masks):
    """JAX's ``dia_factor_sweep_tuple`` against ``dia_factor_sweep`` with a
    pruned plan: pair-free uppers pass through; ``mask_t`` is None for the
    lowers and every third diagonal, or a row everywhere."""
    offsets = BANDS[band]
    mask, base, ilu = _scalar_operands(offsets, seed=len(offsets))
    pairs, d0 = dia_pairs(offsets), offsets.index(0)
    assert pairs == jax_pairs(offsets)
    assert any(not p and o > 0 for p, o in zip(pairs, offsets))
    keep = [masks == "every_row" or (o > 0 and d % 3) for d, o in
            enumerate(offsets)]
    mask_t = [torch.from_numpy(mask[d]) if on else None
              for d, on in enumerate(keep)]
    plan = stencil.PlainSweepPlan(offsets, pairs, d0, mask_t, prune=True,
                                  device="cpu")
    got = dia_factor_sweep(plan, torch.from_numpy(base),
                           torch.from_numpy(ilu))
    want = jax_sweep_t(offsets, pairs, d0,
                       [jnp.asarray(mask[d]) if on else None
                        for d, on in enumerate(keep)],
                       tuple(map(jnp.asarray, base)),
                       tuple(map(jnp.asarray, ilu)))
    _close(got.numpy(), np.stack([np.asarray(v) for v in want]))


@pytest.mark.parametrize("band", sorted(BANDS))
def test_k8_stacked_twin_matches_jax(band):
    """``dia_factor_sweep`` with an unpruned plan (the distributed factor):
    every row re-masked, no pass-through."""
    offsets = BANDS[band]
    mask, base, ilu = _scalar_operands(offsets, seed=20 + len(offsets))
    pairs, d0 = dia_pairs(offsets), offsets.index(0)
    plan = stencil.PlainSweepPlan(offsets, pairs, d0, torch.from_numpy(mask),
                                  prune=False, device="cpu")
    got = dia_factor_sweep(plan, torch.from_numpy(base),
                           torch.from_numpy(ilu))
    want = jax_sweep(offsets, pairs, d0, tuple(map(jnp.asarray, mask)),
                     tuple(map(jnp.asarray, base)),
                     tuple(map(jnp.asarray, ilu)))
    _close(got.numpy(), np.stack([np.asarray(v) for v in want]))


# ----------------------------------------------------------------- K12 ----

def _k12_args(offsets=BANDS["rcm"], mode="upper", dtype=torch.float64,
              seed=7):
    """K12's operands on a band: the strictly lower (or upper) diagonals
    of a factor, a right-hand side and, upper, an inverse diagonal."""
    _, _, ilu = _scalar_operands(offsets, seed)
    rng = np.random.default_rng(seed + 1)
    sel = [d for d, o in enumerate(offsets) if (o < 0) == (mode == "lower")
           and o != 0]
    rhs = rng.standard_normal(N)
    dinv = 1.0 / (4.0 + rng.random(N)) if mode == "upper" else None
    return (tuple(offsets[d] for d in sel),
            torch.from_numpy(np.ascontiguousarray(ilu[sel])).to(dtype),
            torch.from_numpy(rhs).to(dtype),
            None if dinv is None else torch.from_numpy(dinv).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["lower", "upper"])
@pytest.mark.parametrize("band", sorted(BANDS))
def test_k12_twin_is_k2s_second_sweep_from_zero(band, mode, dtype):
    """K12's twin is K2's twin from the iterate K2's first sweep from zero
    yields (the right-hand side, or it times the inverse diagonal), bit
    for bit, and equals K2's two sweeps from zero up to the sign of a
    zero."""
    offs, coeff, rhs, dinv = _k12_args(BANDS[band], mode, dtype)
    got = stencil.zero_start_sweep_ref(offs, coeff, rhs, dinv)
    y1 = rhs if dinv is None else rhs * dinv
    assert torch.equal(got, stencil.tri_sweep_ref(offs, coeff, rhs, y1,
                                                  dinv))
    first = stencil.tri_sweep_ref(offs, coeff, rhs, torch.zeros_like(rhs),
                                  dinv)
    two = stencil.tri_sweep_ref(offs, coeff, rhs, first, dinv)
    assert got.dtype == dtype and torch.equal(got + 0.0, two + 0.0)


# ----------------------------------------------------------------- K13 ----

# the 5-point block star of an 8 × 8 grid (ex19's band) and the 7-point
# block band of a 4³ grid
HEAD_BANDS = {"star5": (-8, -1, 0, 1, 8), "7pt": BANDS["7pt"]}


def _k13_args(offsets=BANDS["7pt"], mode="upper", bs=2,
              dtype=torch.float64, seed=1):
    """K13's operands: a factor's (k, bs², N) blocks, the mode's block
    diagonals, a right-hand side and, upper, an inverse diagonal."""
    data, dinv, z, _ = (torch.from_numpy(a).to(dtype) for a in
                        _block_operands(offsets, bs, seed))
    return (data, offsets, _sel(offsets, mode, "band"), z,
            dinv if mode == "upper" else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", range(1, 9))
@pytest.mark.parametrize("mode", ["lower", "upper"])
@pytest.mark.parametrize("band", sorted(HEAD_BANDS))
def test_k13_twin_is_k7s_second_sweep_from_zero(band, mode, bs, dtype):
    """K13's twin equals K7's twin run twice from a zero iterate, bit for
    bit up to the sign of a zero, in either mode."""
    data, offsets, sel, rhs, dinv = _k13_args(HEAD_BANDS[band], mode, bs,
                                              dtype, seed=bs)
    got = bstencil.bdia_head_sweep_ref(data, offsets, sel, rhs, dinv)
    zero = torch.zeros_like(rhs)
    if mode == "lower":
        first = bstencil.bdia_lower_sweep_ref(data, offsets, sel, rhs, zero)
        two = bstencil.bdia_lower_sweep_ref(data, offsets, sel, rhs, first)
    else:
        first = bstencil.bdia_upper_sweep_ref(data, dinv, offsets, sel, rhs,
                                              zero)
        two = bstencil.bdia_upper_sweep_ref(data, dinv, offsets, sel, rhs,
                                            first)
    assert got.dtype == dtype and torch.equal(got + 0.0, two + 0.0)


# ------------------------------------------------------------ contracts ----

def _k7_args(bs=2, k=7, dtype=torch.float64):
    offsets = BANDS["7pt"] if k == 7 else tuple(range(-(k // 2), k - k // 2))
    data, dinv, z, y = (torch.from_numpy(a).to(dtype) for a in
                        _block_operands(BANDS["7pt"], bs, seed=1))
    if k != 7:
        data = torch.zeros(k, bs * bs, N, dtype=dtype)
    lower = [d for d, o in enumerate(offsets) if o < 0]
    upper = [d for d, o in enumerate(offsets) if o > 0]
    return offsets, data, dinv, z, y, lower, upper


def _k8_args(offsets=BANDS["rcm"]):
    mask, base, ilu = _scalar_operands(offsets, seed=3)
    mask_t = [torch.from_numpy(m) for m in mask]
    plan = stencil.PlainSweepPlan(offsets, dia_pairs(offsets),
                                  offsets.index(0), mask_t, prune=True,
                                  device="cpu")
    return plan, torch.from_numpy(base), torch.from_numpy(ilu)


def _wrapper_and_twin(kernel):
    """One call of the kernel's wrapper and of its twin on the same CPU
    operands, and the operands."""
    if kernel == "k8":
        plan, base, ilu = _k8_args()
        return (stencil.plain_factor_sweep_stencil(plan, base, ilu),
                stencil.plain_factor_sweep_ref(plan, base, ilu),
                (base, ilu, plan.mask))
    if kernel.startswith("k12"):
        offs, coeff, rhs, dinv = _k12_args(mode=kernel[4:])
        return (stencil.zero_start_sweep_stencil(offs, coeff, rhs, dinv),
                stencil.zero_start_sweep_ref(offs, coeff, rhs, dinv),
                tuple(t for t in (coeff, rhs, dinv) if t is not None))
    if kernel.startswith("k13"):
        data, offs, sel, rhs, dinv = _k13_args(mode=kernel[4:])
        return (bstencil.bdia_head_sweep_stencil(data, offs, sel, rhs, dinv),
                bstencil.bdia_head_sweep_ref(data, offs, sel, rhs, dinv),
                tuple(t for t in (data, rhs, dinv) if t is not None))
    offsets, data, dinv, z, y, lower, upper = _k7_args()
    if kernel == "k7_lower":
        return (bstencil.bdia_lower_sweep_stencil(data, offsets, lower, z, y),
                bstencil.bdia_lower_sweep_ref(data, offsets, lower, z, y),
                (data, z, y))
    if kernel == "k7_lower_y_is_z":
        return (bstencil.bdia_lower_sweep_stencil(data, offsets, lower, z, z),
                bstencil.bdia_lower_sweep_ref(data, offsets, lower, z, z),
                (data, z))
    return (bstencil.bdia_upper_sweep_stencil(data, dinv, offsets, upper, y,
                                              z),
            bstencil.bdia_upper_sweep_ref(data, dinv, offsets, upper, y, z),
            (data, dinv, y, z))


KERNELS = ["k7_lower", "k7_upper", "k8", "k12_lower", "k12_upper",
           "k13_lower", "k13_upper"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_cpu_tensor_runs_the_twin_and_counts_no_launch(kernel):
    _cuda.reset_launches()
    got, want, _ = _wrapper_and_twin(kernel)
    assert torch.equal(got, want)
    assert set(_cuda.launches.values()) == {0}


@pytest.mark.parametrize("kernel", KERNELS + ["k7_lower_y_is_z"])
def test_output_is_fresh(kernel):
    """Every wrapper writes a tensor of its own: no output shares memory
    with an operand (the lower mode with y and z one tensor included)."""
    got, _, operands = _wrapper_and_twin(kernel)
    start = got.data_ptr()
    end = start + got.numel() * got.element_size()
    for t in operands:
        t_start = t.data_ptr()
        t_end = t_start + t.numel() * t.element_size()
        assert end <= t_start or t_end <= start


def _raises_k7(case):
    offsets, data, dinv, z, y, lower, upper = _k7_args()
    if case == "mixed_dtypes":
        return bstencil.bdia_lower_sweep_stencil(data, offsets, lower,
                                                 z.float(), y.float())
    if case == "diagonals_over_128":
        o, d, _, z1, y1, lo, _ = _k7_args(k=129)
        return bstencil.bdia_lower_sweep_stencil(d, o, lo, z1, y1)
    if case == "bs_over_8":
        z9 = torch.zeros(9, N, dtype=torch.float64)
        return bstencil.bdia_lower_sweep_stencil(
            torch.zeros(7, 81, N, dtype=torch.float64), offsets, lower, z9,
            z9)
    if case == "non_contiguous":
        zt = torch.zeros(N, 2, dtype=torch.float64).t()
        return bstencil.bdia_lower_sweep_stencil(data, offsets, lower, zt, y)
    if case == "wrong_shape":
        return bstencil.bdia_upper_sweep_stencil(data, dinv[:3], offsets,
                                                 upper, y, z)
    assert case == "bad_index"
    return bstencil.bdia_lower_sweep_stencil(data, offsets, [0, 7], z, y)


def _raises_k8(case):
    plan, base, ilu = _k8_args()
    if case == "mixed_dtypes":
        return stencil.plain_factor_sweep_stencil(plan, base.float(), ilu)
    if case == "diagonals_over_128":
        offsets = tuple(range(-64, 65))
        return stencil.PlainSweepPlan(offsets, dia_pairs(offsets), 64,
                                      [None] * 129, prune=True, device="cpu")
    if case == "non_contiguous":
        return stencil.plain_factor_sweep_stencil(
            plan, base, torch.zeros(N, len(plan.offsets),
                                    dtype=torch.float64).t())
    if case == "wrong_shape":
        return stencil.plain_factor_sweep_stencil(plan, base[:-1], ilu)
    assert case == "plan_on_another_band"
    other, _, _ = _k8_args(BANDS["7pt"])
    return stencil.plain_factor_sweep_stencil(other, base, ilu)


def _raises_k12(case):
    offs, coeff, rhs, dinv = _k12_args()
    if case == "mixed_dtypes":
        return stencil.zero_start_sweep_stencil(offs, coeff, rhs.float(),
                                                dinv)
    if case == "diagonals_over_128":
        return stencil.zero_start_sweep_stencil(
            tuple(range(1, 130)), torch.zeros(129, N, dtype=torch.float64),
            rhs)
    if case == "non_contiguous":
        return stencil.zero_start_sweep_stencil(
            offs, torch.zeros(N, len(offs), dtype=torch.float64).t(), rhs,
            dinv)
    if case == "wrong_shape":
        return stencil.zero_start_sweep_stencil(offs, coeff, rhs, dinv[:-1])
    assert case == "bfloat16"
    return stencil.zero_start_sweep_stencil(offs, coeff.bfloat16(),
                                            rhs.bfloat16())


def _raises_k13(case):
    data, offsets, upper, y, dinv = _k13_args()
    if case == "mixed_dtypes":
        return bstencil.bdia_head_sweep_stencil(data, offsets, upper,
                                                y.float(), dinv)
    if case == "diagonals_over_128":
        o, d, _, z1, _, lo, _ = _k7_args(k=129)
        return bstencil.bdia_head_sweep_stencil(d, o, lo, z1)
    if case == "bs_over_8":
        return bstencil.bdia_head_sweep_stencil(
            torch.zeros(7, 81, N, dtype=torch.float64), offsets, [0, 1],
            torch.zeros(9, N, dtype=torch.float64))
    if case == "non_contiguous":
        yt = torch.zeros(N, 2, dtype=torch.float64).t()
        return bstencil.bdia_head_sweep_stencil(data, offsets, upper, yt,
                                                dinv)
    if case == "wrong_shape":
        return bstencil.bdia_head_sweep_stencil(data, offsets, upper, y,
                                                dinv[:3])
    assert case == "bad_index"
    return bstencil.bdia_head_sweep_stencil(data, offsets, [0, 7], y)


K13_RAISES = {"mixed_dtypes": TypeError, "diagonals_over_128": ValueError,
              "bs_over_8": ValueError, "non_contiguous": ValueError,
              "wrong_shape": ValueError, "bad_index": ValueError}
K12_RAISES = {"mixed_dtypes": TypeError, "diagonals_over_128": ValueError,
              "non_contiguous": ValueError, "wrong_shape": ValueError,
              "bfloat16": TypeError}
K7_RAISES = {"mixed_dtypes": TypeError, "diagonals_over_128": ValueError,
             "bs_over_8": ValueError, "non_contiguous": ValueError,
             "wrong_shape": ValueError, "bad_index": ValueError}
K8_RAISES = {"mixed_dtypes": TypeError, "diagonals_over_128": ValueError,
             "non_contiguous": ValueError, "wrong_shape": ValueError,
             "plan_on_another_band": ValueError}


@pytest.mark.parametrize("case", sorted(K7_RAISES))
def test_k7_wrapper_raises(case):
    with pytest.raises(K7_RAISES[case]):
        _raises_k7(case)


@pytest.mark.parametrize("case", sorted(K8_RAISES))
def test_k8_wrapper_raises(case):
    with pytest.raises(K8_RAISES[case]):
        _raises_k8(case)


@pytest.mark.parametrize("case", sorted(K12_RAISES))
def test_k12_wrapper_raises(case):
    with pytest.raises(K12_RAISES[case]):
        _raises_k12(case)


@pytest.mark.parametrize("case", sorted(K13_RAISES))
def test_k13_wrapper_raises(case):
    """K13's wrapper raises where K7's does (``_raises_k7``)."""
    with pytest.raises(K13_RAISES[case]):
        _raises_k13(case)


def test_mixed_dtype_factor_takes_the_twin():
    """The apply's dtype rule: a factor stored in bfloat16 with float64
    vectors runs the twin's products in ``soa_*_sweep`` (no launch, no
    raise), while the wrapper itself refuses the mix."""
    offsets, data, dinv, z, y, lower, upper = _k7_args()
    low = data.to(torch.bfloat16)
    _cuda.reset_launches()
    got = soa_unit_lower_sweep(low, offsets, lower, z, y, 2)
    assert torch.equal(got, bstencil.bdia_lower_sweep_ref(low, offsets,
                                                          lower, z, y))
    got = soa_upper_solve_sweep(low, dinv, offsets, upper, y, z, 2)
    assert torch.equal(got, bstencil.bdia_upper_sweep_ref(
        low, dinv, offsets, upper, y, z))
    assert got.dtype == torch.float64
    assert set(_cuda.launches.values()) == {0}
    with pytest.raises(TypeError):
        bstencil.bdia_lower_sweep_stencil(low, offsets, lower, z, y)


@pytest.mark.parametrize("where", ["preconditioner", "distributed"])
def test_pair_table_built_once_per_factor_owner(where, monkeypatch):
    """K8's pair table is built once per preconditioner and once per shard,
    across re-factors, never per sweep."""
    built = []
    init = stencil.PlainSweepPlan.__init__

    def counted(self, *args, **kw):
        built.append(self)
        init(self, *args, **kw)

    monkeypatch.setattr(stencil.PlainSweepPlan, "__init__", counted)
    A, _, _ = poisson3d_system((7, 7, 7), "uniform")
    if where == "preconditioner":
        p = DiaILU0Preconditioner(dia_from_csr(A, "cpu"), nbuildsweeps=8)
        p.compute()
        p.compute()
        assert built == [p._plan]
        assert p._plan.table.device.type == "cpu"
    else:
        ds = DistDiaSolver(A, make_mesh(2, devices=["cpu"] * 2),
                           AsyncSolverSettings(prec_type=PrecType.ILU0,
                                               nbuildsweeps=6))
        assert len(built) == 2
        ds._compute()
        assert built == [ds._plans[0], ds._plans[1]]


# ----------------------------------------------------------- the slice ----

def test_scalar_ilu0_through_k8_matches_jax():
    """DIA ILU(0) 8,4 (the main path's options) on a 7³ Poisson system:
    the factor (eight K8 twin sweeps), its inverse diagonal and one apply
    against JAX's preconditioner."""
    from blasted_tpu.apps import poisson3d_system as jax_poisson3d_system

    A, _, _ = poisson3d_system((9, 9, 9), "chebyshev")
    Aj, _, _ = jax_poisson3d_system((9, 9, 9), "chebyshev")
    p = DiaILU0Preconditioner(dia_from_csr(A, "cpu"), nbuildsweeps=8,
                              napplysweeps=4)
    pj = JaxDiaILU0(jax_dia_from_csr(Aj), nbuildsweeps=8, napplysweeps=4)
    p.compute()
    pj.compute()
    _close(p.state.ilu.numpy(), np.stack([np.asarray(v)
                                          for v in pj.state.ilu]))
    r = np.random.default_rng(5).standard_normal(A.nrows)
    _close(p.apply(torch.from_numpy(r)).numpy(),
           np.asarray(pj.apply(jnp.asarray(r))))


@pytest.mark.parametrize("bs", [2, 4])
def test_block_ilu0_apply_through_k7_matches_jax(bs):
    """Block ILU(0) 4,4 on the 7-point block band (the block main path's
    sweep counts): one apply (eight K7 twin sweeps) against JAX's.  The
    factor starts from FactInit.NONE, which both packages factor on the
    plain route on every device, so the applies read the same factor."""
    rowptr, colind, vals = block_poisson_arrays(4, bs, seed=bs)
    D = bdia_from_bsr(BSRMatrix.from_arrays(rowptr, colind, vals, bs), "cpu")
    Dj = jax_bdia_from_bsr(JaxBSRMatrix.from_arrays(rowptr, colind, vals,
                                                    bs))
    p = BlockDiaILU0Preconditioner(D, nbuildsweeps=4, napplysweeps=4,
                                   fact_init=FactInit.NONE)
    pj = JaxBILU(Dj, nbuildsweeps=4, napplysweeps=4,
                 fact_init=JFactInit.NONE)
    p.compute()
    pj.compute()
    r = np.random.default_rng(6).standard_normal((D.nbrows, bs))
    _close(p.apply(torch.from_numpy(r)).numpy(),
           np.asarray(pj.apply(jnp.asarray(r))))
