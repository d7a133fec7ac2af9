"""Kernels K1–K4 of the PyTorch port: each plain twin (what a CPU tensor
runs) against the JAX package's Pallas kernel, run in interpret mode on the
CPU as the JAX package's own tests run it, in float64; the compressed
factor's exact K → 2K characterisation; the zero-denominator guards; the
route rule; and the wrappers' operand checks.

The CUDA kernels themselves only run on the card; ``chip_smoke.py`` checks
each against its twin there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasted_tpu.ops import stencil as jst
from blasted_tpu.precond.dia_ilu0 import dia_factor_sweep_tuple as jax_sweep
from blasted_tpu.sparse.dia import DiaMatrix as JaxDiaMatrix
from blasted_tpu.sparse.dia import shift_read as jax_shift_read
from blasted_tpu_torch.config import SEQUENTIAL, FactInit
from blasted_tpu_torch.ops import _cuda, stencil
from blasted_tpu_torch.ops.sweeps import unit_lower_sweep, upper_solve_sweep
from blasted_tpu_torch.precond.dia_ilu0 import dia_factor_sweep, dia_pairs
from blasted_tpu_torch.sparse import dia_from_numpy

TOL = dict(rtol=1e-12, atol=1e-12)


def _band(g, seed):
    """The 7-point band of a g³ grid with random coefficients and a dominant
    diagonal, as numpy (the construction of tests/test_stencil.py's
    ``_poisson_band``, in float64)."""
    n = g ** 3
    offsets = (-g * g, -g, -1, 0, 1, g, g * g)
    rng = np.random.default_rng(seed)
    idx = np.arange(n)
    i0, j0, k0 = idx % g, (idx // g) % g, idx // (g * g)
    mask = np.stack([k0 > 0, j0 > 0, i0 > 0, np.ones(n, bool),
                     i0 < g - 1, j0 < g - 1, k0 < g - 1])
    data = []
    for d in range(len(offsets)):
        v = 0.25 * rng.standard_normal(n)
        if offsets[d] == 0:
            v = v + 2.0 * len(offsets)
        data.append(np.where(mask[d], v, 0.0))
    return offsets, np.stack(data), mask


def _jax_dia(offsets, data, mask):
    return JaxDiaMatrix(data=tuple(jnp.asarray(v) for v in data),
                        mask=tuple(jnp.asarray(m) for m in mask),
                        offsets=offsets)


def _plan(offsets, n, extra=0):
    T, _ = jst.stencil_plan(offsets, n, extra_streams=extra)
    return T


def test_k1_twin_matches_pallas():
    offsets, data, mask = _band(16, seed=1)
    n = data.shape[1]
    x = np.random.default_rng(11).standard_normal(n)
    T = _plan(offsets, n)
    yj = jst.unpad_vec(jst.dia_spmv_stencil(
        offsets, tuple(jnp.asarray(v) for v in data),
        jst.pad_vec(jnp.asarray(x), T), T), T)
    y = stencil.dia_spmv_stencil(offsets, torch.from_numpy(data),
                                 torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(y.numpy(), _jax_dia(offsets, data, mask)
                               .to_scipy() @ x, **TOL)


def test_k2_twin_matches_pallas_chained():
    """Three chained lower/upper sweep pairs (the apply's shape), through
    the port's DIA sweeps (``ops/sweeps.py``, which call K2)."""
    offsets, data, mask = _band(16, seed=9)
    n = data.shape[1]
    T = _plan(offsets, n)
    z = np.random.default_rng(9).standard_normal(n)
    dinv = 1.0 / data[offsets.index(0)]
    dj = tuple(jnp.asarray(v) for v in data)
    zj, dinvj = jnp.asarray(z), jnp.asarray(dinv)
    yp = jst.pad_vec(jnp.zeros(n), T)
    D = dia_from_numpy(offsets, data, mask, "cpu")
    zt, dinvt = torch.from_numpy(z), torch.from_numpy(dinv)
    y = torch.zeros(n, dtype=torch.float64)
    for _ in range(3):
        y1p = jst.unit_lower_sweep_stencil(offsets, dj, zj, yp, T)
        yp = jst.upper_solve_sweep_stencil(offsets, dj, dinvj, zj, y1p, T)
        y1 = unit_lower_sweep(D, D.data, zt, y)
        y = upper_solve_sweep(D, D.data, dinvt, zt, y1)
        np.testing.assert_allclose(y1.numpy(),
                                   np.asarray(jst.unpad_vec(y1p, T)), **TOL)
        np.testing.assert_allclose(y.numpy(),
                                   np.asarray(jst.unpad_vec(yp, T)), **TOL)


@pytest.mark.parametrize("nsweeps", [1, 3])
@pytest.mark.parametrize("init", ["base", "perturbed"])
def test_k3_k4_twins_match_pallas_driver(nsweeps, init):
    """The compressed factor driver (K3 sweeps, then K4) against the JAX
    driver ``dia_factor_sweeps_stencil``."""
    offsets, data, _ = _band(16, seed=5)
    n = data.shape[1]
    pairs = dia_pairs(offsets)
    d0 = offsets.index(0)
    ilu0 = data if init == "base" else \
        data * (1.0 + 0.1 * np.random.default_rng(2).random(data.shape))
    T = _plan(offsets, n, extra=6)
    want = jst.dia_factor_sweeps_stencil(
        offsets, pairs, d0, tuple(jnp.asarray(v) for v in data),
        tuple(jnp.asarray(v) for v in ilu0), nsweeps, T)
    got = stencil.dia_factor_sweeps_stencil(
        offsets, pairs, d0, torch.from_numpy(data), torch.from_numpy(ilu0),
        nsweeps)
    np.testing.assert_allclose(got.numpy(),
                               np.stack([np.asarray(v) for v in want]), **TOL)


def _u0_with_zeros(data, d0):
    u0 = data[d0].copy()
    u0[::37] = 0.0              # exact zeros: guarded to 1
    u0[5::101] = 1e-300         # tiny but nonzero: NOT guarded (no eps)
    return u0


def test_k3_twin_matches_pallas_guard():
    """One K3 sweep, twin vs ``_factor_u0_call``, with zero denominators."""
    offsets, data, _ = _band(16, seed=3)
    n = data.shape[1]
    d0 = offsets.index(0)
    T = _plan(offsets, n, extra=6)
    pair_offs = offsets[:d0]
    u0 = _u0_with_zeros(data, d0)
    ubs = np.stack([np.asarray(jax_shift_read(data[6 - j], o))
                    for j, o in enumerate(pair_offs)])
    call = jst._factor_u0_call(pair_offs, n, T, "float64")
    pad = lambda a: jst.pad_vec(jnp.asarray(a), T)  # noqa: E731
    want = jst.unpad_vec(call(pad(data[d0]), *[pad(v) for v in data[:d0]],
                              *[pad(v) for v in ubs], pad(u0)), T)
    got = stencil.factor_u0_stencil(
        pair_offs, torch.from_numpy(data[d0].copy()),
        torch.from_numpy(data[:d0].copy()), torch.from_numpy(ubs),
        torch.from_numpy(u0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isfinite(got.numpy()).all()


def test_k4_twin_matches_pallas_guard():
    offsets, data, _ = _band(16, seed=4)
    n = data.shape[1]
    d0 = offsets.index(0)
    T = _plan(offsets, n, extra=6)
    lower_offs = offsets[:d0]
    u0 = _u0_with_zeros(data, d0)
    call = jst._factor_lower_call(lower_offs, n, T, "float64")
    pad = lambda a: jst.pad_vec(jnp.asarray(a), T)  # noqa: E731
    want = call(*[pad(v) for v in data[:d0]], pad(u0))
    got = stencil.factor_lower_stencil(
        lower_offs, torch.from_numpy(data[:d0].copy()), torch.from_numpy(u0))
    np.testing.assert_allclose(
        got.numpy(), np.stack([np.asarray(jst.unpad_vec(w, T)) for w in want]),
        **TOL)


def test_zero_denominator_guard_is_exact():
    """0 → 1 with no eps (C3): a zero u0 divides by exactly 1, a tiny
    nonzero u0 is divided by as it is."""
    u0 = torch.tensor([0.0, 1e-300, 2.0], dtype=torch.float64)
    base_l = torch.tensor([[3.0, 3e-300, 4.0]], dtype=torch.float64)
    got = stencil.factor_lower_stencil((0,), base_l, u0)
    assert got.tolist() == [[3.0, 3.0, 2.0]]
    ubs = torch.ones_like(base_l)
    base0 = torch.full((3,), 10.0, dtype=torch.float64)
    got = stencil.factor_u0_stencil((0,), base0, base_l, ubs, u0)
    assert got.tolist() == [7.0, 7.0, 8.0]


def test_compressed_k_sweeps_equal_plain_2k():
    """After K compressed sweeps u0 equals the plain chain after 2K sweeps
    and the lowers equal it after 2K−1 (cf. tests/test_stencil.py:101),
    with the port on both sides."""
    offsets, data, _ = _band(16, seed=5)
    pairs = dia_pairs(offsets)
    d0 = offsets.index(0)
    base = torch.from_numpy(data)
    nsweeps = 3
    got = stencil.dia_factor_sweeps_stencil(offsets, pairs, d0, base, base,
                                            nsweeps)
    mask_t = [None] * len(offsets)
    plan = stencil.PlainSweepPlan(offsets, pairs, d0, mask_t, prune=True,
                                  device="cpu")
    ref = {0: base}
    for s in range(1, 2 * nsweeps + 1):
        ref[s] = dia_factor_sweep(plan, base, ref[s - 1])
    for d, o in enumerate(offsets):
        want = ref[2 * nsweeps][d] if o >= 0 else ref[2 * nsweeps - 1][d]
        np.testing.assert_allclose(got[d].numpy(), want.numpy(), **TOL)
    # and the plain chain itself equals the JAX plain chain
    jref = tuple(jnp.asarray(v) for v in data)
    for _ in range(2 * nsweeps):
        jref = jax_sweep(offsets, pairs, d0, mask_t,
                         tuple(jnp.asarray(v) for v in data), jref)
    np.testing.assert_allclose(ref[2 * nsweeps].numpy(),
                               np.stack([np.asarray(v) for v in jref]), **TOL)


def test_compressed_fixed_point():
    """Exact ILU factors are a fixed point of the compressed sweep."""
    offsets, data, _ = _band(16, seed=7)
    pairs = dia_pairs(offsets)
    d0 = offsets.index(0)
    base = torch.from_numpy(data)
    plan = stencil.PlainSweepPlan(offsets, pairs, d0, [None] * 7, prune=True,
                                  device="cpu")
    ilu = base
    for _ in range(60):
        ilu = dia_factor_sweep(plan, base, ilu)
    out = stencil.dia_factor_sweeps_stencil(offsets, pairs, d0, base, ilu, 1)
    np.testing.assert_allclose(out.numpy(), ilu.numpy(), **TOL)


def test_dia_products_and_full_sweep_match_jax():
    """The plain DIA products (``ops/dia.py``, ``ops/sweeps.py``) and the
    unpruned factor sweep against their JAX counterparts."""
    from blasted_tpu.ops.dia import dia_gemv3 as jax_gemv3
    from blasted_tpu.ops.sweeps import lower_mv as jax_lower_mv
    from blasted_tpu.ops.sweeps import upper_mv as jax_upper_mv
    from blasted_tpu.precond.dia_ilu0 import dia_factor_sweep as jax_full_sweep
    from blasted_tpu_torch.ops.dia import dia_gemv3
    from blasted_tpu_torch.ops.sweeps import lower_mv, upper_mv

    offsets, data, mask = _band(6, seed=12)
    n = data.shape[1]
    rng = np.random.default_rng(12)
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    D, Dj = dia_from_numpy(offsets, data, mask, "cpu"), \
        _jax_dia(offsets, data, mask)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(dia_gemv3(D, 0.5, xt, -2.0, yt).numpy(),
                               np.asarray(jax_gemv3(Dj, 0.5, x, -2.0, y)),
                               **TOL)
    np.testing.assert_allclose(lower_mv(D, D.data, xt).numpy(),
                               np.asarray(jax_lower_mv(Dj, Dj.data, x)), **TOL)
    np.testing.assert_allclose(upper_mv(D, D.data, xt).numpy(),
                               np.asarray(jax_upper_mv(Dj, Dj.data, x)), **TOL)
    pairs = dia_pairs(offsets)
    d0 = offsets.index(0)
    plan = stencil.PlainSweepPlan(offsets, pairs, d0, D.mask, prune=False,
                                  device="cpu")
    ilu, ilu_j = D.data, Dj.data
    for _ in range(3):
        ilu = dia_factor_sweep(plan, D.data, ilu)
        ilu_j = jax_full_sweep(offsets, pairs, d0, Dj.mask, Dj.data, ilu_j)
    np.testing.assert_allclose(ilu.numpy(),
                               np.stack([np.asarray(v) for v in ilu_j]), **TOL)


_P7 = (-9, -3, -1, 0, 1, 3, 9)
# the 7-point band of a 288³ grid: past JAX's halo threshold in float32
_G288 = (-288 * 288, -288, -1, 0, 1, 288, 288 * 288)
_N288 = 288 ** 3


@pytest.mark.parametrize("offsets,d0_full,nb,init,n,isz,want", [
    (_G288, True, 4, FactInit.ORIGINAL, _N288, 4, True),
    (_G288, True, 4, FactInit.SGS, _N288, 4, True),
    (_G288, True, 0, FactInit.ORIGINAL, _N288, 4, True),
    (_G288, True, 4, FactInit.NONE, _N288, 4, False),   # C2: warm starts plain
    (_G288, True, SEQUENTIAL, FactInit.ORIGINAL, _N288, 4, False),
    (_G288, False, 4, FactInit.ORIGINAL, _N288, 4, False),
    (_G288, True, 4, FactInit.ORIGINAL, _N288, 8, False),   # VMEM term (R4)
    (_P7, True, 4, FactInit.ORIGINAL, 9 ** 3, 8, False),    # halo term (R4)
    ((-1, 0, 1, 2), True, 4, FactInit.ORIGINAL, 1 << 20, 8, False),  # fill
])
def test_route_rule(offsets, d0_full, nb, init, n, isz, want):
    pairs = dia_pairs(offsets)
    assert stencil.factor_takes_compressed_route(offsets, pairs, d0_full,
                                                 nb, init, n, isz) is want
    assert stencil.factor_stencil_eligible(offsets, pairs) == \
        jst.factor_stencil_eligible(offsets, pairs)


@pytest.mark.parametrize("g", [160, 192, 288, 320])
@pytest.mark.parametrize("isz", [4, 8])
def test_route_rule_matches_jax_gate(g, isz):
    """R4: the port goes compressed exactly where JAX's ``stencil_gate``
    passes on a TPU (the halo window past 512 KiB and a tile plan with six
    extra streams; on the CPU JAX's gate always refuses, so its arithmetic
    is read from ``stencil_plan``): only g = 288 in float32 and g = 192 in
    float64 among these grids."""
    offsets = (-g * g, -g, -1, 0, 1, g, g * g)
    n = g ** 3
    jax_gate = (2 * g * g * isz > 512 * 1024
                and jst.stencil_plan(offsets, n, isz, 6) is not None)
    got = stencil.factor_takes_compressed_route(
        offsets, dia_pairs(offsets), True, 4, FactInit.ORIGINAL, n, isz)
    assert got is jax_gate
    assert got is ((g, isz) in ((288, 4), (192, 8)))
    assert stencil.stencil_plan(offsets, n, isz, 6) == \
        jst.stencil_plan(offsets, n, isz, 6)


def test_wrappers_check_operands_and_count_only_launches():
    offsets = (-1, 0, 1)
    data = torch.ones(3, 8, dtype=torch.float64)
    x = torch.ones(8, dtype=torch.float64)
    before = dict(_cuda.launches)
    stencil.dia_spmv_stencil(offsets, data, x)
    stencil.tri_sweep_stencil(offsets[:1], data[:1], x, x)
    assert _cuda.launches == before      # CPU tensors run the twins
    with pytest.raises(TypeError):
        stencil.dia_spmv_stencil(offsets, data.float(), x)
    with pytest.raises(TypeError):
        stencil.dia_spmv_stencil(offsets, data.half(), x.half())
    with pytest.raises(ValueError):
        stencil.dia_spmv_stencil(offsets, data[:2], x)
    with pytest.raises(ValueError):
        stencil.dia_spmv_stencil(offsets, data, torch.ones(16).double()[::2])
    with pytest.raises(ValueError):
        stencil.tri_sweep_stencil(offsets[:1], data[:1], x, x,
                                  torch.ones(9, dtype=torch.float64))
    with pytest.raises(RuntimeError):
        stencil.dia_spmv_stencil(offsets, data.to("meta"), x.to("meta"))
