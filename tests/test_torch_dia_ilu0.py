"""DIA ILU(0) of the PyTorch port against the JAX package's
``DiaILU0Preconditioner``: factors and applies, in float64, to 1e-12.

On the CPU the JAX package always takes the plain factor route; the port's
route rule reads only the problem and the options and takes JAX-on-TPU's
route (R4), which is plain below JAX's halo gate, so every small band here
factors plain.  The compressed route is compared, on a band past the gate,
with the JAX driver ``dia_factor_sweeps_stencil`` called directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasted_tpu.apps import poisson3d_system as jax_poisson3d_system
from blasted_tpu.config import ApplyInit as JApplyInit
from blasted_tpu.config import FactInit as JFactInit
from blasted_tpu.ops import stencil as jst
from blasted_tpu.precond.dia_ilu0 import DiaILU0Preconditioner as JaxDiaILU0
from blasted_tpu.precond.levels import compute_levels_lower as jax_levels_lower
from blasted_tpu.precond.levels import compute_levels_upper as jax_levels_upper
from blasted_tpu.sparse.dia import dia_from_csr as jax_dia_from_csr
from blasted_tpu_torch.apps import poisson3d_system
from blasted_tpu_torch.config import SEQUENTIAL, ApplyInit, FactInit
from blasted_tpu_torch.ops.sweeps import (
    run_sweeps,
    unit_lower_sweep,
    upper_solve_sweep,
)
from blasted_tpu_torch.precond import DiaILU0Preconditioner
from blasted_tpu_torch.precond.levels import (
    compute_levels_lower,
    compute_levels_upper,
)
from blasted_tpu_torch.sparse import dia_from_csr
from blasted_tpu_torch.utils import profiling

TOL = dict(rtol=1e-12, atol=1e-12)
S = SEQUENTIAL


def _pair(npts, dist="chebyshev", **kw):
    """The same operator and options in both packages."""
    A, _, _ = poisson3d_system(npts, dist)
    Aj, _, _ = jax_poisson3d_system(npts, dist)
    jkw = dict(kw)
    if "fact_init" in kw:
        jkw["fact_init"] = JFactInit(kw["fact_init"].value)
    if "apply_init" in kw:
        jkw["apply_init"] = JApplyInit(kw["apply_init"].value)
    return (DiaILU0Preconditioner(dia_from_csr(A, "cpu"), **kw),
            JaxDiaILU0(jax_dia_from_csr(Aj), **jkw))


def _stack(t):
    return np.stack([np.asarray(v) for v in t])


def _assert_same(p, pj, seed=0):
    np.testing.assert_allclose(p.state.ilu.numpy(), _stack(pj.state.ilu),
                               **TOL)
    np.testing.assert_allclose(p.state.ilu_dinv.numpy(),
                               np.asarray(pj.state.ilu_dinv), **TOL)
    r = np.random.default_rng(seed).standard_normal(p.mat.nrows)
    np.testing.assert_allclose(p.apply(torch.from_numpy(r)).numpy(),
                               np.asarray(pj.apply(jnp.asarray(r))), **TOL)


PLAIN_CASES = {
    "init_none_4_4": dict(nbuildsweeps=4, napplysweeps=4,
                          fact_init=FactInit.NONE),
    "seq_build": dict(nbuildsweeps=S, napplysweeps=3),
    "seq_apply": dict(nbuildsweeps=2, napplysweeps=S,
                      fact_init=FactInit.NONE),
    "seqilu0": dict(nbuildsweeps=S, napplysweeps=S),
    "sgs_init_seq_build": dict(nbuildsweeps=S, napplysweeps=2,
                               fact_init=FactInit.SGS),
    "scaling": dict(nbuildsweeps=3, napplysweeps=3, use_scaling=True,
                    fact_init=FactInit.NONE),
    "jacobi_apply": dict(nbuildsweeps=3, napplysweeps=3,
                         fact_init=FactInit.NONE,
                         apply_init=ApplyInit.JACOBI),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_route_matches_jax(case):
    p, pj = _pair((9, 9, 9), **PLAIN_CASES[case])
    p.compute()
    pj.compute()
    _assert_same(p, pj)


def test_warm_start_stays_plain_and_matches_jax():
    """FactInit.NONE re-computes continue from the previous factors (C2)."""
    p, pj = _pair((9, 9, 9), nbuildsweeps=1, napplysweeps=2,
                  fact_init=FactInit.NONE)
    for _ in range(3):
        p.compute()
        pj.compute()
    _assert_same(p, pj, seed=1)


# past JAX's halo threshold in float64: interior 1024 × 33 × 2, H = 33,792,
# one 33,792-row tile twice (R4, ROADMAP.md §3); on the uniform grid (the
# Chebyshev grid's 1024-point clustering leaves pivots of 1e-5 after
# cancellation, which turns ulp-level differences in the summation path
# into 1e-11)
GATE_NPTS = (1026, 35, 4)
GATE_DIST = "uniform"


@pytest.mark.parametrize("scaling", [False, True])
def test_compressed_route_matches_jax_driver(scaling):
    """A band past JAX's gate (``GATE_NPTS``, n = 67,584): the port's route
    is compressed (K3/K4) there, as JAX's is on a TPU; the JAX driver
    ``dia_factor_sweeps_stencil`` gives the reference factor from the same
    base.  Below the gate the route is plain (``test_plain_route_*``)."""
    p, pj = _pair(GATE_NPTS, GATE_DIST, nbuildsweeps=3, napplysweeps=2,
                  use_scaling=scaling)
    p.compute()
    A = pj.mat
    scale = 1.0 / jnp.sqrt(A.diag_vals) if scaling else None
    base = pj._scaled_base(scale)
    T, _ = jst.stencil_plan(A.offsets, A.nrows, 8, extra_streams=6)
    ilu = jst.dia_factor_sweeps_stencil(A.offsets, pj._pairs, pj._d0, base,
                                        pj._fact_initial(base), 3, T)
    np.testing.assert_allclose(p.state.ilu.numpy(), _stack(ilu), **TOL)
    # the plain route (JAX's on the CPU) gives another factor (C1)
    pj.compute()
    assert np.abs(p.state.ilu.numpy() - _stack(pj.state.ilu)).max() > 1e-8


def test_default_route_below_gate_matches_jax():
    """R4: below JAX's gate (18³ grid points, H = 256) the default
    ORIGINAL 4,4 factor takes the plain route, as JAX's does: factor,
    inverse diagonal and apply to 1e-12."""
    p, pj = _pair((18, 18, 18), nbuildsweeps=4, napplysweeps=4)
    p.compute()
    pj.compute()
    _assert_same(p, pj, seed=3)


def test_load_state_numpy_applies_like_jax():
    p, pj = _pair((9, 9, 9), nbuildsweeps=3, napplysweeps=3,
                  use_scaling=True)
    pj.compute()
    st = pj.state
    p.load_state_numpy([np.asarray(v) for v in st.ilu],
                       np.asarray(st.ilu_dinv), np.asarray(st.scale))
    _assert_same(p, pj, seed=2)


def test_levels_match_jax_and_are_built_only_for_sequential():
    A, _, _ = poisson3d_system((8, 9, 10))
    Aj, _, _ = jax_poisson3d_system((8, 9, 10))
    np.testing.assert_array_equal(compute_levels_lower(A.rowptr, A.colind),
                                  jax_levels_lower(Aj.rowptr, Aj.colind))
    np.testing.assert_array_equal(compute_levels_upper(A.rowptr, A.colind),
                                  jax_levels_upper(Aj.rowptr, Aj.colind))
    D = dia_from_csr(A, "cpu")
    p = DiaILU0Preconditioner(D, nbuildsweeps=2, napplysweeps=2)
    p.compute()
    p.apply(torch.ones(D.nrows, dtype=torch.float64))
    assert p._levels is None
    q = DiaILU0Preconditioner(D, nbuildsweeps=2, napplysweeps=S)
    q.compute()
    assert q._levels is None
    q.apply(torch.ones(D.nrows, dtype=torch.float64))
    assert q._levels is not None


def test_unported_options_raise():
    """Every option of the JAX class is ported: ``apply_dtype`` stores the
    factor in bfloat16 (JAX's bits) and keeps the inverse diagonal, taken
    from the unrounded factor, in float64; ``compute_precinfo`` reports."""
    A, _, _ = poisson3d_system((6, 6, 6))
    Aj, _, _ = jax_poisson3d_system((6, 6, 6))
    D = dia_from_csr(A, "cpu")
    p = DiaILU0Preconditioner(D, nbuildsweeps=2, apply_dtype=torch.bfloat16)
    p.compute()
    pj = JaxDiaILU0(jax_dia_from_csr(Aj), nbuildsweeps=2,
                    apply_dtype=jnp.bfloat16)
    pj.compute()
    assert p.state.ilu.dtype == torch.bfloat16
    assert p.state.ilu_dinv.dtype == torch.float64
    np.testing.assert_array_equal(
        p.state.ilu.float().numpy(),
        np.stack([np.asarray(v, dtype=np.float32) for v in pj.state.ilu]))
    np.testing.assert_allclose(p.state.ilu_dinv.numpy(),
                               np.asarray(pj.state.ilu_dinv), **TOL)
    # compute_precinfo is ported: the factor reports its diagnostics
    info = DiaILU0Preconditioner(D, compute_precinfo=True).compute()
    assert all(np.isfinite(v) for v in info) and info.prec_rem_initial_norm > 0


# ------------------------------------------- K12: the zero-start chain ----

def _band(kind, dtype):
    """A 7-point band (6³ Chebyshev Poisson) or a band RCM makes of the
    same system in a random order, on the CPU in ``dtype``."""
    A, _, _ = poisson3d_system((6, 6, 6), "chebyshev")
    if kind == "7pt":
        return dia_from_csr(A.astype(dtype), "cpu")
    from blasted_tpu_torch.factory import rcm_banded_device_matrix
    from blasted_tpu_torch.sparse import CSRMatrix

    perm = np.random.default_rng(13).permutation(A.nrows)
    sp = A.to_scipy()[perm][:, perm].tocsr()
    sp.sort_indices()
    Ap = CSRMatrix.from_arrays(sp.indptr, sp.indices, sp.data.astype(dtype))
    D, _ = rcm_banded_device_matrix(Ap, device="cpu")
    assert D is not None and len(D.offsets) > 7
    return D


def _k2_chain_from_zero(p, r):
    """The apply as it was before K12: each triangle's ``napplysweeps``
    K2 sweeps from a zero iterate."""
    st, A = p.state, p.mat
    z = st.scale * r if st.scale is not None else r
    y = run_sweeps(p.napplysweeps,
                   lambda yy: unit_lower_sweep(A, st.ilu, z, yy),
                   torch.zeros_like(z))
    out = run_sweeps(p.napplysweeps,
                     lambda zz: upper_solve_sweep(A, st.ilu, st.ilu_dinv, y,
                                                  zz),
                     torch.zeros_like(z))
    return st.scale * out if st.scale is not None else out


@pytest.mark.parametrize("band", ["7pt", "rcm"])
@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("nsw", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_zero_start_apply_is_the_k2_chain_from_zero(dtype, nsw, scaling,
                                                    band):
    """An apply from zero equals the chain of K2 sweeps from zero bit for
    bit, up to the sign of a zero (``+ 0.0`` clears it); from two sweeps
    on it starts with K12, counted once an apply."""
    D = _band(band, dtype)
    p = DiaILU0Preconditioner(D, nbuildsweeps=3, napplysweeps=nsw,
                              use_scaling=scaling)
    p.compute()
    r = torch.from_numpy(np.random.default_rng(nsw).standard_normal(
        D.nrows).astype(dtype))
    profiling.reset()
    got = p.apply(r)
    assert profiling.counters == {"precond.ilu_apply": 1,
                                  **({"precond.zero_start": 1}
                                     if nsw >= 2 else {})}
    want = _k2_chain_from_zero(p, r)
    assert got.dtype == want.dtype and torch.equal(got + 0.0, want + 0.0)


def _counted_solve(route):
    """Solve a small system through ``api.solve`` on ``route``: the
    counters of its applies."""
    from blasted_tpu_torch import solve

    from test_torch_bdia import block_poisson_arrays

    opts = {"blasted_pc_type": "ilu0", "blasted_async_sweeps": "3,3",
            "rtol": 1e-6, "maxiter": 200}
    A, b, _ = poisson3d_system((6, 6, 6), "uniform")
    extra = {"zero": {}, "jacobi": {"blasted_async_apply_init_type":
                                    "init_jacobi"},
             "none": {"blasted_async_apply_init_type": "init_none"},
             "sequential": {"blasted_async_sweeps": "3,-1"},
             "one_sweep": {"blasted_async_sweeps": "3,1"},
             "mixed_dtype": {"blasted_apply_dtype": "bfloat16"},
             "padded": {"prefer_dia": False}}
    if route == "block":
        from blasted_tpu_torch.sparse import BSRMatrix

        rowptr, colind, vals = block_poisson_arrays(4, 2, seed=2)
        A = BSRMatrix.from_arrays(rowptr, colind, vals, 2)
        b = np.ones(A.nrows)
    else:
        opts.update(extra[route])
    profiling.reset()
    _, info, ctx = solve(A, b, opts, device="cpu")
    return dict(profiling.counters), info, ctx


@pytest.mark.parametrize("route", ["zero", "jacobi", "none", "sequential",
                                   "one_sweep", "mixed_dtype", "block",
                                   "padded"])
def test_zero_start_engages_only_from_zero_with_two_sweeps(route):
    """``precond.zero_start`` counts every apply of a DIA ILU(0) solve from
    zero with two sweeps or more and the factor in the vector's dtype, and
    stays 0 on every other route; ``precond.ilu_apply`` counts the DIA
    ILU(0) applies."""
    counters, info, ctx = _counted_solve(route)
    assert info.iters >= 1
    applies = counters.get("precond.ilu_apply", 0)
    if route in ("block", "padded"):
        assert type(ctx.prec).__name__ != "DiaILU0Preconditioner"
        assert applies == 0
    else:
        assert type(ctx.prec).__name__ == "DiaILU0Preconditioner"
        assert applies == 2 * info.iters
    assert counters.get("precond.zero_start", 0) \
        == (applies if route == "zero" else 0)


@pytest.mark.parametrize("value", [np.inf, np.nan])
@pytest.mark.parametrize("where", ["lower", "upper"])
def test_non_finite_factor_fails_as_the_k2_chain_does(where, value):
    """One non-finite factor entry makes the apply non-finite, as the JAX
    package's float64 sweeps from zero do, and the solve reports what the
    K2 chain from zero reports."""
    from blasted_tpu_torch import solvers
    from blasted_tpu_torch.ops.spmv import spmv

    p, pj = _pair((7, 7, 7), nbuildsweeps=3, napplysweeps=4)
    p.compute()
    st = p.state
    ilu = st.ilu.clone()
    d = 0 if where == "lower" else len(p.mat.offsets) - 1
    ilu[d, p.mat.nrows // 2 - 60] = value
    p.load_state_numpy(list(ilu.numpy()), st.ilu_dinv.numpy())
    pj.compute()
    pj.state = pj.state._replace(
        ilu=tuple(jnp.asarray(v) for v in ilu.numpy()),
        ilu_dinv=jnp.asarray(st.ilu_dinv.numpy()))
    r = torch.from_numpy(np.random.default_rng(4).standard_normal(
        p.mat.nrows))
    got = p.apply(r)
    assert not bool(torch.isfinite(got).all())
    assert not np.isfinite(np.asarray(pj.apply(jnp.asarray(r.numpy())))).all()
    assert not bool(torch.isfinite(_k2_chain_from_zero(p, r)).all())
    D = p.mat
    runs = [solvers.bicgstab(lambda v: spmv(D, v), prec, r,
                             torch.zeros_like(r), tol=1e-8, maxiter=50)
            for prec in (p.apply_flat, lambda v: _k2_chain_from_zero(p, v))]
    (x_new, info_new), (x_old, info_old) = runs
    assert not info_new.converged
    assert (info_new.converged, info_new.iters, info_new.breakdown) \
        == (info_old.converged, info_old.iters, info_old.breakdown)
    torch.testing.assert_close(x_new, x_old, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("nsw", [2, 3, 4])
def test_solve_runs_k12_and_k2_as_chip_smoke_counts(nsw, monkeypatch):
    """A BiCGSTAB solve with ILU(0) from zero calls K12's wrapper once per
    triangle an apply and K2's ``nsw − 2`` times: ``chip_smoke.py``'s
    launch rule ``ilu_launches``, which the card's launches are held to."""
    import chip_smoke
    from blasted_tpu_torch import solve
    from blasted_tpu_torch.ops import sweeps
    from blasted_tpu_torch.precond import dia_ilu0

    calls = {"tri_sweep": 0, "zero_start_lower_sweep": 0,
             "zero_start_upper_sweep": 0}

    def counted(name, fn):
        def call(*args, **kw):
            key = name
            if name == "zero_start":
                upper = len(args) > 3 and args[3] is not None
                key = "zero_start_" + ("upper" if upper else "lower") \
                    + "_sweep"
            calls[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(sweeps, "tri_sweep_stencil",
                        counted("tri_sweep", sweeps.tri_sweep_stencil))
    monkeypatch.setattr(dia_ilu0, "zero_start_sweep_stencil",
                        counted("zero_start",
                                dia_ilu0.zero_start_sweep_stencil))
    A, b, _ = poisson3d_system((8, 8, 8), "uniform")
    _, info, _ = solve(A, b, {"blasted_pc_type": "ilu0",
                              "blasted_async_sweeps": f"4,{nsw}",
                              "rtol": 1e-8, "maxiter": 200}, device="cpu")
    assert info.converged
    want = chip_smoke.ilu_launches("dia", 4, nsw, info.iters)
    assert calls == {k: want[k] for k in calls}
