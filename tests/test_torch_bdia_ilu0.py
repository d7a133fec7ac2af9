"""Block-DIA ILU(0) of the PyTorch port against the JAX package's
``BlockDiaILU0Preconditioner``, in float64 on the CPU: the factor chains,
the preconditioner route for route, the exact SEQUENTIAL path against the
sequential block oracle, and ``solve`` on a BSR matrix.

On the CPU the JAX package always factors on the plain route; the port's
route rule reads only the problem and the options.  Plain-route cases here
use a ``FactInit.NONE`` first compute (the ORIGINAL guess on the plain
route) or a ``SEQUENTIAL`` factor; the compressed route is compared with
the JAX function ``bdia_factor_sweeps_compressed`` called directly (its XLA
u0-state chain on the CPU; the port runs K6's twin where every diagonal
block is stored)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasted_tpu import api as japi
from blasted_tpu.config import ApplyInit as JApplyInit
from blasted_tpu.config import FactInit as JFactInit
from blasted_tpu.precond.bdia_ilu0 import BlockDiaILU0Preconditioner as JaxBILU
from blasted_tpu.precond.bdia_ilu0 import _soa_gj_inverse as jax_gj_inverse
from blasted_tpu.precond.bdia_ilu0 import \
    bdia_factor_sweeps_compressed as jax_compressed
from blasted_tpu.precond.bdia_ilu0 import bdia_factor_sweeps_soa as jax_soa
from blasted_tpu.sparse.bdia import bdia_from_bsr as jax_bdia_from_bsr
from blasted_tpu.sparse.bsr import BSRMatrix as JaxBSRMatrix
from blasted_tpu_torch import api
from blasted_tpu_torch.config import SEQUENTIAL, ApplyInit, FactInit
from blasted_tpu_torch.precond import BlockDiaILU0Preconditioner
from blasted_tpu_torch.precond.bdia_ilu0 import (
    bdia_factor_sweep,
    bdia_factor_sweeps_compressed,
    bdia_factor_sweeps_soa,
)
from blasted_tpu_torch.precond.dia_ilu0 import dia_pairs
from blasted_tpu_torch.sparse import BSRMatrix, bdia_from_bsr
from helpers import exact_block_ilu0_oracle
from test_torch_bdia import block_poisson_arrays

TOL = dict(rtol=1e-11, atol=1e-12)
S = SEQUENTIAL


def _mats(nx=5, bs=4, seed=0):
    rowptr, colind, vals = block_poisson_arrays(nx, bs, seed)
    B = BSRMatrix.from_arrays(rowptr, colind, vals, bs)
    Bj = JaxBSRMatrix.from_arrays(rowptr, colind, vals, bs)
    return B, Bj, bdia_from_bsr(B, "cpu"), jax_bdia_from_bsr(Bj)


def _jax_kw(kw):
    jkw = dict(kw)
    if "fact_init" in kw:
        jkw["fact_init"] = JFactInit(kw["fact_init"].value)
    if "apply_init" in kw:
        jkw["apply_init"] = JApplyInit(kw["apply_init"].value)
    return jkw


def _stack(t):
    return np.stack([np.stack([np.asarray(c) for c in comp]) for comp in t])


def _assert_same(p, ilu_j, dinv_j, apply_j, bs, seed=0):
    np.testing.assert_allclose(p.state.ilu.numpy(), _stack(ilu_j), **TOL)
    np.testing.assert_allclose(p.state.ilu_dinv.numpy(),
                               np.stack([np.asarray(c) for c in dinv_j]),
                               **TOL)
    r = np.random.default_rng(seed).standard_normal((p.mat.nbrows, bs))
    np.testing.assert_allclose(p.apply(torch.from_numpy(r)).numpy(),
                               np.asarray(apply_j(jnp.asarray(r))), **TOL)


def _chain_args(D):
    return D.offsets, dia_pairs(D.offsets), D.d0, D.mask


# ------------------------------------------------------------ the chains ----

@pytest.mark.parametrize("diag_mask_full", [True, False])
def test_compressed_chain_characterisation(diag_mask_full):
    """tests/test_bdia.py:142-168 on the port: K compressed sweeps (K6's
    twin, or the torch u0-state chain) give the plain chain's diagonal at 2K
    and its lowers at 2K−1; uppers pass through."""
    _, _, D, _ = _mats()
    K = 2
    comp = bdia_factor_sweeps_compressed(*_chain_args(D), D.data, D.data, K,
                                         diag_mask_full=diag_mask_full)
    ref = {s: bdia_factor_sweeps_soa(*_chain_args(D), D.data, D.data, s)
           for s in (2 * K - 1, 2 * K)}
    for d, o in enumerate(D.offsets):
        want = ref[2 * K][d] if o >= 0 else ref[2 * K - 1][d]
        np.testing.assert_allclose(comp[d].numpy(), want.numpy(),
                                   rtol=1e-11, atol=1e-12)


def test_plain_chain_matches_jax():
    _, _, D, Dj = _mats(nx=4, bs=3, seed=2)
    offsets, pairs, d0, mask = _chain_args(D)
    got = bdia_factor_sweeps_soa(offsets, pairs, d0, mask, D.data, D.data, 3)
    want = jax_soa(Dj.offsets, pairs, d0, Dj.mask, Dj.data, Dj.data, 3)
    np.testing.assert_allclose(got.numpy(), _stack(want), **TOL)
    one = bdia_factor_sweep(offsets, pairs, d0, mask, D.data, D.data)
    np.testing.assert_allclose(
        one.numpy(), bdia_factor_sweeps_soa(offsets, pairs, d0, mask, D.data,
                                            D.data, 1).numpy(), **TOL)


@pytest.mark.parametrize("diag_mask_full", [True, False])
def test_compressed_chain_matches_jax_function(diag_mask_full):
    _, _, D, Dj = _mats(nx=4, bs=3, seed=3)
    offsets, pairs, d0, mask = _chain_args(D)
    got = bdia_factor_sweeps_compressed(offsets, pairs, d0, mask, D.data,
                                        D.data, 3,
                                        diag_mask_full=diag_mask_full)
    want = jax_compressed(Dj.offsets, pairs, d0, Dj.mask, Dj.data, Dj.data, 3)
    np.testing.assert_allclose(got.numpy(), _stack(want), **TOL)


# ------------------------------------------------------ the preconditioner --

PLAIN_CASES = {
    "init_none_4_4": dict(nbuildsweeps=4, napplysweeps=4,
                          fact_init=FactInit.NONE),
    "seqilu0": dict(nbuildsweeps=S, napplysweeps=S),
    "sgs_init_seq_build": dict(nbuildsweeps=S, napplysweeps=2,
                               fact_init=FactInit.SGS),
    "scaling_jacobi_apply": dict(nbuildsweeps=3, napplysweeps=3,
                                 use_scaling=True, fact_init=FactInit.NONE,
                                 apply_init=ApplyInit.JACOBI),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_route_matches_jax(case):
    kw = PLAIN_CASES[case]
    _, _, D, Dj = _mats()
    p, pj = BlockDiaILU0Preconditioner(D, **kw), JaxBILU(Dj, **_jax_kw(kw))
    p.compute()
    pj.compute()
    _assert_same(p, pj.state.ilu, pj.state.ilu_dinv, pj.apply, D.bs)


COMPRESSED_CASES = {
    "default_4_4": dict(nbuildsweeps=4, napplysweeps=4),
    "sgs_init_scaling": dict(nbuildsweeps=3, napplysweeps=2,
                             use_scaling=True, fact_init=FactInit.SGS),
}


@pytest.mark.parametrize("case", sorted(COMPRESSED_CASES))
def test_compressed_route_matches_jax_compressed_factor(case):
    """The port's preconditioner on the compressed route against the JAX
    class's own base and initial guess, factored by the JAX compressed
    function, and applied by the JAX class."""
    kw = COMPRESSED_CASES[case]
    _, _, D, Dj = _mats()
    p, pj = BlockDiaILU0Preconditioner(D, **kw), JaxBILU(Dj, **_jax_kw(kw))
    p.compute()
    pj.compute()                                  # the plain route: scale
    base = pj._scaled_base(pj.state.scale)
    ilu = jax_compressed(Dj.offsets, pj._pairs, pj._d0, Dj.mask, base,
                         pj._fact_initial(base), kw["nbuildsweeps"],
                         diag_mask_full=True)
    st = pj.state._replace(ilu=ilu, ilu_dinv=jax_gj_inverse(
        ilu[pj._d0], D.bs, Dj.mask[pj._d0]))
    _assert_same(p, ilu, st.ilu_dinv, lambda r: pj.apply_with(Dj, st, r),
                 D.bs, seed=1)


def test_exact_path_matches_oracle():
    """The SEQUENTIAL factor against the sequential block IKJ ILU(0)."""
    B, _, D, _ = _mats(nx=4, bs=3, seed=4)
    p = BlockDiaILU0Preconditioner(D, nbuildsweeps=S, napplysweeps=S)
    p.compute()
    want = bdia_from_bsr(B.with_vals(exact_block_ilu0_oracle(B)), "cpu")
    np.testing.assert_allclose(p.state.ilu.numpy(), want.data.numpy(),
                               rtol=1e-10, atol=1e-11)


def test_warm_start_stays_plain_and_matches_jax():
    """FactInit.NONE re-computes continue from the previous factors (C2)."""
    kw = dict(nbuildsweeps=1, napplysweeps=2, fact_init=FactInit.NONE)
    _, _, D, Dj = _mats(nx=4, bs=2, seed=5)
    p, pj = BlockDiaILU0Preconditioner(D, **kw), JaxBILU(Dj, **_jax_kw(kw))
    for _ in range(3):
        p.compute()
        pj.compute()
    _assert_same(p, pj.state.ilu, pj.state.ilu_dinv, pj.apply, D.bs, seed=2)


def test_load_state_numpy_and_lazy_levels():
    """A JAX state installed with load_state_numpy applies as the JAX class
    applies it; levels are built only when a phase is SEQUENTIAL."""
    kw = dict(nbuildsweeps=2, napplysweeps=S, use_scaling=True)
    _, _, D, Dj = _mats(nx=4, bs=2, seed=6)
    pj = JaxBILU(Dj, **kw)
    pj.compute()
    p = BlockDiaILU0Preconditioner(D, **kw)
    p.load_state_numpy(pj.state.ilu, pj.state.ilu_dinv, pj.state.scale)
    r = np.random.default_rng(3).standard_normal((D.nbrows, 2))
    np.testing.assert_allclose(p.apply(torch.from_numpy(r)).numpy(),
                               np.asarray(pj.apply(jnp.asarray(r))), **TOL)
    assert p._levels is not None                 # the SEQUENTIAL apply
    q = BlockDiaILU0Preconditioner(D, nbuildsweeps=2, napplysweeps=2)
    q.compute()
    q.apply_flat(torch.zeros(D.nrows, dtype=torch.float64))
    assert q._levels is None


def test_unported_options_raise():
    """Every option of the JAX class is ported: ``apply_dtype`` stores the
    factor narrower (float32 here) with the inverse diagonal blocks from
    the unrounded factor, as JAX's plain route does (FactInit.NONE's first
    compute); ``compute_precinfo`` reports; block SGS solves."""
    _, _, D, Dj = _mats(nx=3, bs=2)
    kw = dict(nbuildsweeps=2, napplysweeps=2, fact_init=FactInit.NONE)
    p = BlockDiaILU0Preconditioner(D, apply_dtype=torch.float32, **kw)
    p.compute()
    pj = JaxBILU(Dj, apply_dtype=jnp.float32, **_jax_kw(kw))
    pj.compute()
    assert p.state.ilu.dtype == torch.float32
    assert p.state.ilu_dinv.dtype == torch.float64
    np.testing.assert_array_equal(p.state.ilu.numpy(),
                                  np.asarray(pj.state.ilu, dtype=np.float32))
    np.testing.assert_allclose(p.state.ilu_dinv.numpy(),
                               np.asarray(pj.state.ilu_dinv), **TOL)
    # compute_precinfo and block SGS are ported: diagnostics, a solve
    info = BlockDiaILU0Preconditioner(D, compute_precinfo=True).compute()
    assert all(np.isfinite(v) for v in info) and info.prec_rem_initial_norm > 0
    _, sinfo, ctx = api.solve(_mats(nx=3, bs=2)[0], np.ones(54),
                              {"blasted_pc_type": "sgs"}, device="cpu")
    assert sinfo.converged
    assert type(ctx.prec).__name__ == "BSGSPreconditioner"


# ------------------------------------------------------------------ solve ---

def test_solve_plain_route_matches_jax():
    """``solve(BSRMatrix, …)`` in both packages, both on the plain route:
    the same iteration count and x to 1e-10."""
    opts = {"blasted_pc_type": "ilu0", "blasted_async_sweeps": "3,3",
            "blasted_async_fact_init_type": "init_none",
            "ksp_type": "bicgstab", "rtol": 1e-10, "maxiter": 300}
    B, Bj, _, _ = _mats()
    b = B.to_scipy() @ np.random.default_rng(9).standard_normal(B.nrows)
    x, info, ctx = api.solve(B, b, opts, device="cpu")
    xj, ij, _ = japi.solve(Bj, b, opts)
    assert info.converged and bool(ij.converged)
    assert info.iters == int(ij.iters)
    xj = np.asarray(xj)
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())
    assert ctx.prec.block_size == 4 and ctx.timers.factor_calls == 1


def test_solve_compressed_route_and_default_device():
    """The default options take the compressed route (K6's twin on the CPU)
    to the true residual; without a device the solve goes to the card and,
    where torch sees none, raises instead of running on the CPU."""
    opts = {"blasted_pc_type": "ilu0", "blasted_async_sweeps": "4,4",
            "ksp_type": "bicgstab", "rtol": 1e-10}
    B, _, _, _ = _mats(nx=4, bs=4, seed=8)
    b = B.to_scipy() @ np.random.default_rng(4).standard_normal(B.nrows)
    x, info, _ = api.solve(B, b, opts, device="cpu")
    assert info.converged
    relres = np.linalg.norm(b - B.to_scipy() @ x.numpy()) / np.linalg.norm(b)
    assert relres < 1e-9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.solve(B, b, opts)


# ------------------------------------------- K13: the zero-start chain ----

def _k7_chain_from_zero(p, r):
    """The apply as it was before K13: each triangle's ``napplysweeps``
    K7 sweeps from a zero iterate."""
    from blasted_tpu_torch.ops.bdia import (
        cols_of,
        soa_unit_lower_sweep,
        soa_upper_solve_sweep,
        stack_cols,
    )
    from blasted_tpu_torch.ops.sweeps import run_sweeps

    st, A = p.state, p.mat
    bs, offsets = A.bs, A.offsets
    lower = [d for d, o in enumerate(offsets) if o < 0]
    upper = [d for d, o in enumerate(offsets) if o > 0]
    z = st.scale * r if st.scale is not None else r
    zc = cols_of(z)
    zero = torch.zeros_like(zc)
    yc = run_sweeps(p.napplysweeps,
                    lambda y: soa_unit_lower_sweep(st.ilu, offsets, lower, zc,
                                                   y, bs), zero)
    out = stack_cols(run_sweeps(
        p.napplysweeps,
        lambda zz: soa_upper_solve_sweep(st.ilu, st.ilu_dinv, offsets, upper,
                                         yc, zz, bs), zero))
    return st.scale * out if st.scale is not None else out


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("nsw", [2, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_folded_apply_is_the_k7_chain_from_zero(dtype, nsw, scaling):
    """An apply from zero with two sweeps or more starts each chain with
    K13 and equals the chain of K7 sweeps from zero bit for bit, up to the
    sign of a zero (``+ 0.0`` clears it); counted once an apply."""
    from blasted_tpu_torch.utils import profiling

    rowptr, colind, vals = block_poisson_arrays(4, 3, seed=nsw)
    B = BSRMatrix.from_arrays(rowptr, colind, vals.astype(dtype), 3)
    p = BlockDiaILU0Preconditioner(bdia_from_bsr(B, "cpu"), nbuildsweeps=3,
                                   napplysweeps=nsw, use_scaling=scaling)
    p.compute()
    r = torch.from_numpy(np.random.default_rng(nsw).standard_normal(
        (p.mat.nbrows, 3)).astype(dtype))
    profiling.reset()
    try:
        got = p.apply(r)
        assert profiling.counters == {"precond.block_apply": 1,
                                      "precond.block_zero_start": 1}
    finally:
        profiling.reset()
    want = _k7_chain_from_zero(p, r)
    assert got.dtype == want.dtype and torch.equal(got + 0.0, want + 0.0)


BLOCK_ROUTES = {"zero": {}, "jacobi": {"blasted_async_apply_init_type":
                                       "init_jacobi"},
                "none": {"blasted_async_apply_init_type": "init_none"},
                "sequential": {"blasted_async_sweeps": "3,-1"},
                "one_sweep": {"blasted_async_sweeps": "3,1"},
                "mixed_dtype": {"blasted_apply_dtype": "bfloat16"}}


@pytest.mark.parametrize("route", sorted(BLOCK_ROUTES))
def test_block_zero_start_engages_only_from_zero_with_two_sweeps(route):
    """``precond.block_zero_start`` counts every apply of a block ILU(0)
    solve from zero with two sweeps or more and the factor in the
    vector's dtype; JACOBI, NONE, one sweep, SEQUENTIAL and a bfloat16
    factor keep the K7 chain and leave it at 0."""
    from blasted_tpu_torch.utils import profiling

    opts = {"blasted_pc_type": "ilu0", "blasted_async_sweeps": "3,3",
            "rtol": 1e-6, "maxiter": 200, **BLOCK_ROUTES[route]}
    B, _, _, _ = _mats(nx=4, bs=2, seed=2)
    profiling.reset()
    try:
        _, info, ctx = api.solve(B, np.ones(B.nrows), opts, device="cpu")
        counters = dict(profiling.counters)
    finally:
        profiling.reset()
    assert type(ctx.prec).__name__ == "BlockDiaILU0Preconditioner"
    assert info.iters >= 1
    assert counters["precond.block_apply"] == 2 * info.iters
    assert counters.get("precond.block_zero_start", 0) \
        == (2 * info.iters if route == "zero" else 0)


@pytest.mark.parametrize("nsw", [2, 3, 4])
def test_solve_runs_k13_and_k7_as_chip_smoke_counts(nsw, monkeypatch):
    """A BiCGSTAB solve with block ILU(0) from zero calls K13's wrapper
    once per triangle an apply and K7's ``nsw − 2`` times a triangle:
    ``chip_smoke.py``'s launch rule ``ilu_launches``, which the card's
    launches are held to."""
    import chip_smoke
    from blasted_tpu_torch.ops import bdia, bstencil
    from blasted_tpu_torch.precond import bdia_ilu0

    calls = dict.fromkeys(("bdia_lower_sweep", "bdia_upper_sweep",
                           "bdia_head_lower_sweep", "bdia_head_upper_sweep"),
                          0)

    def counted(key, fn):
        def call(*args, **kw):
            name = key
            if key == "bdia_head":
                upper = len(args) > 4 and args[4] is not None
                name = f"bdia_head_{'upper' if upper else 'lower'}_sweep"
            calls[name] += 1
            return fn(*args, **kw)
        return call

    for name in ("bdia_lower_sweep", "bdia_upper_sweep"):
        monkeypatch.setattr(bdia, f"{name}_stencil",
                            counted(name, getattr(bstencil,
                                                  f"{name}_stencil")))
    monkeypatch.setattr(bdia_ilu0, "bdia_head_sweep_stencil",
                        counted("bdia_head",
                                bstencil.bdia_head_sweep_stencil))
    B, _, _, _ = _mats(nx=5, bs=4, seed=3)
    b = B.to_scipy() @ np.random.default_rng(2).standard_normal(B.nrows)
    _, info, _ = api.solve(B, b, {"blasted_pc_type": "ilu0",
                                  "blasted_async_sweeps": f"4,{nsw}",
                                  "rtol": 1e-8, "maxiter": 200},
                           device="cpu")
    assert info.converged
    want = chip_smoke.ilu_launches("bdia", 4, nsw, info.iters)
    assert calls == {k: want[k] for k in calls}
