"""Kernels K9 (the padded SpMV), K10 (the padded ILU(0) apply sweep, both
modes) and K11 (the Chow–Patel factor sweep over the ILU pair lists) of the
PyTorch port, which the JAX package leaves to XLA gathers: each plain twin
(what a CPU tensor runs) against the JAX function on the same numpy inputs
made from a seed, in float64, to 1e-12 of the largest magnitude (the twins
sum each row's slots, and each entry's pairs, in order; XLA sums in its own
order, so the bound allows for the last bits of a different summation
tree); the wrappers' contracts; the int32 index tables built once per
pattern; and the slice end to end (the padded ILU(0) 8,4 preconditioner
against JAX's, and one padded solve through the wrappers, counted).

The CUDA kernels themselves only run on the card; ``chip_smoke.py`` holds
each against its twin there."""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasted_tpu.precond.ilu0 import BlockILU0Preconditioner as JaxBILU
from blasted_tpu.precond.ilu0 import ILU0Preconditioner as JaxILU
from blasted_tpu_torch import api
from blasted_tpu_torch.apps import poisson3d_system
from blasted_tpu_torch.config import AsyncSolverSettings, PrecType
from blasted_tpu_torch.ops import _cuda, padded
from blasted_tpu_torch.ops.bstencil import block_inverse_ref
from blasted_tpu_torch.ops.sweeps import invert_diag_blocks, triangle
from blasted_tpu_torch.parallel import make_mesh
from blasted_tpu_torch.parallel.dist import DistributedSolver
from blasted_tpu_torch.precond import (
    BlockILU0Preconditioner,
    ILU0Preconditioner,
)
from test_torch_padded import bsr_pair, csr_pair

RTOL = 1e-12      # max |port − JAX| / max |JAX|, float64
jspmv, jsw = (import_module(f"blasted_tpu.ops.{m}") for m in ("spmv", "sweeps"))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max(), scale)


def _pair(bs: int, spare: int = 1):
    """The same random (non-banded) matrix as a padded matrix of each
    package, with ``spare`` sentinel slots on every row."""
    if bs == 1:
        A, Aj = csr_pair(seed=3)
        width = int(np.diff(A.rowptr).max()) + spare
        return A.pad(width, device="cpu"), Aj.pad(width)
    B, Bj = bsr_pair(bs=bs, seed=bs)
    width = int(np.diff(B.rowptr).max()) + spare
    return B.pad(width, device="cpu"), Bj.pad(width)


def _vec(P, rng):
    return rng.standard_normal((P.nbrows, P.bs) if P.vals_pad.dim() == 4
                               else P.nrows)


# ------------------------------------------------------------------ K9 ----

@pytest.mark.parametrize("bs", [1, 2, 4])
def test_k9_twin_matches_jax(bs):
    P, Pj = _pair(bs)
    x = _vec(P, np.random.default_rng(bs))
    got = padded.padded_spmv(P.vals_pad, padded.col_table(P),
                             torch.from_numpy(x))
    want = (jspmv.spmv if bs == 1 else jspmv.bspmv)(Pj, jnp.asarray(x))
    _close(got, want)


# ----------------------------------------------------------------- K10 ----

@pytest.mark.parametrize("mode", ["lower", "upper"])
@pytest.mark.parametrize("bs", [1, 2, 4])
def test_k10_twin_matches_jax(bs, mode):
    """One sweep of each mode on a random factor in the padded layout,
    pre-masked to its triangle, against ``ops/sweeps.py``'s ILU sweep."""
    P, Pj = _pair(bs)
    rng = np.random.default_rng(10 * bs + len(mode))
    ilu = rng.standard_normal(P.vals_pad.shape)
    z, y = _vec(P, rng), _vec(P, rng)
    dinv = rng.standard_normal((P.nrows,) if bs == 1
                               else (P.nbrows, bs, bs))
    t, j = torch.from_numpy, jnp.asarray
    col = padded.col_table(P)
    tri = triangle(P, t(ilu), mode)
    if mode == "lower":
        got = padded.padded_lower_sweep(tri, col, t(z), t(y))
        fn = jsw.unit_lower_sweep if bs == 1 else jsw.block_unit_lower_sweep
        want = fn(Pj, j(ilu), j(z), j(y))
    else:
        got = padded.padded_upper_sweep(tri, col, t(dinv), t(y), t(z))
        fn = jsw.upper_solve_sweep if bs == 1 \
            else jsw.block_upper_solve_sweep
        want = fn(Pj, j(ilu), j(dinv), j(y), j(z))
    _close(got, want)


# ----------------------------------------------------------------- K11 ----

def _factor_pair(bs: int):
    """The port's and JAX's ILU(0) preconditioners on one padded matrix,
    symbolic data built, and a random iterate."""
    P, Pj = _pair(bs, spare=0)
    cls, jcls = (ILU0Preconditioner, JaxILU) if bs == 1 \
        else (BlockILU0Preconditioner, JaxBILU)
    p, pj = cls(P), jcls(Pj)
    p._ensure_symbolic()
    pj._ensure_symbolic()
    rng = np.random.default_rng(20 + bs)
    shape = (P.nnz_total,) if bs == 1 else (P.nnz_total, bs, bs)
    ilu = rng.standard_normal(shape)
    # a dominant diagonal keeps the divisors (and block inverses) tame
    diag = P.diagind.numpy()
    ilu[diag] += 4.0 if bs == 1 else 4.0 * np.eye(bs)
    return p, pj, ilu


@pytest.mark.parametrize("bs", [1, 2, 4])
def test_k11_twin_matches_jax(bs):
    p, pj, ilu = _factor_pair(bs)
    base = p._vals
    got = p.factor_sweep_fn(base)(torch.from_numpy(ilu))
    want = pj._factor_sweep_fn(pj._vals)(jnp.asarray(ilu))
    _close(got, want)
    # the pair lists hold the real pairs only, in the JAX lists' order
    plan = p.symbolic.plan
    lowerp = np.asarray(pj.symbolic.lowerp)
    valid = lowerp < p.mat.nnz_total
    assert plan.pl.dtype == torch.int32
    np.testing.assert_array_equal(plan.pl.numpy(), lowerp[valid])
    np.testing.assert_array_equal(np.diff(plan.ptr.numpy()), valid.sum(1))


# --------------------------------------------------------- the wrappers ----

def _calls(kernel):
    """(wrapper call, twin call, operands) on the same CPU operands."""
    if kernel == "k11" or kernel == "k11_block":
        p, _, ilu = _factor_pair(1 if kernel == "k11" else 2)
        ilu = torch.from_numpy(ilu)
        src = ilu if kernel == "k11" else \
            invert_diag_blocks(ilu[p.mat.diagind])
        plan, base = p.symbolic.plan, p._vals
        return (lambda: padded.padded_factor_sweep(plan, base, ilu, src),
                lambda: padded.padded_factor_sweep_ref(plan, base, ilu, src),
                (base, ilu, src))
    bs = 2 if kernel.endswith("_block") else 1
    P, _ = _pair(bs)
    rng = np.random.default_rng(7)
    vals, col = P.vals_pad, padded.col_table(P)
    x, rhs = (torch.from_numpy(_vec(P, rng)) for _ in range(2))
    if kernel.startswith("k9"):
        return (lambda: padded.padded_spmv(vals, col, x),
                lambda: padded.padded_spmv_ref(vals, col, x), (vals, x))
    if kernel.startswith("k10_lower"):
        r = x if "rhs_is_x" in kernel else rhs
        return (lambda: padded.padded_lower_sweep(vals, col, r, x),
                lambda: padded.padded_lower_sweep_ref(vals, col, r, x),
                (vals, r, x))
    dinv = torch.from_numpy(rng.standard_normal(
        (P.nrows,) if bs == 1 else (P.nbrows, bs, bs)))
    return (lambda: padded.padded_upper_sweep(vals, col, dinv, rhs, x),
            lambda: padded.padded_upper_sweep_ref(vals, col, dinv, rhs, x),
            (vals, dinv, rhs, x))


KERNELS = ["k9", "k9_block", "k10_lower", "k10_lower_block", "k10_upper",
           "k10_upper_block", "k11", "k11_block"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_cpu_tensor_runs_the_twin_and_counts_no_launch(kernel):
    wrapper, twin, _ = _calls(kernel)
    _cuda.reset_launches()
    assert torch.equal(wrapper(), twin())
    assert set(_cuda.launches.values()) == {0}


@pytest.mark.parametrize("kernel", KERNELS + ["k10_lower_rhs_is_x"])
def test_output_is_fresh(kernel):
    """Every wrapper writes a tensor of its own: no output shares memory
    with an operand (the lower mode with rhs and x one tensor included)."""
    wrapper, _, operands = _calls(kernel)
    got = wrapper()
    start = got.data_ptr()
    end = start + got.numel() * got.element_size()
    for t in operands:
        t_start = t.data_ptr()
        t_end = t_start + t.numel() * t.element_size()
        assert end <= t_start or t_end <= start


def _raises(case):
    P, _ = _pair(2)
    vals, col = P.vals_pad, padded.col_table(P)
    x = torch.zeros(P.nbrows, 2, dtype=torch.float64)
    if case == "k9_mixed_dtypes":
        return padded.padded_spmv(vals, col, x.float())
    if case == "k9_int64_ids":
        return padded.padded_spmv(vals, P.colind, x)
    if case == "k9_wrong_shape":
        return padded.padded_spmv(vals, col, x[:-1])
    if case == "k9_bad_vals":
        return padded.padded_spmv(vals[..., 0], col, x)
    if case == "k9_non_contiguous":
        return padded.padded_spmv(vals, col, torch.zeros(
            2, P.nbrows, dtype=torch.float64).t())
    if case == "k9_other_device":
        return padded.padded_spmv(vals.to("meta"), col.to("meta"),
                                  x.to("meta"))
    if case == "k10_mixed_dtypes":
        return padded.padded_lower_sweep(vals, col, x.float(), x)
    if case == "k10_wrong_dinv":
        return padded.padded_upper_sweep(vals, col, x, x, x)
    p, _, ilu = _factor_pair(1)
    ilu = torch.from_numpy(ilu)
    plan = p.symbolic.plan
    if case == "k11_mixed_dtypes":
        return padded.padded_factor_sweep(plan, p._vals.float(), ilu, ilu)
    assert case == "k11_plan_of_another_pattern"
    other, _, _ = _factor_pair(2)
    return padded.padded_factor_sweep(other.symbolic.plan, p._vals, ilu, ilu)


RAISES = {"k9_mixed_dtypes": TypeError, "k9_int64_ids": TypeError,
          "k9_wrong_shape": ValueError, "k9_bad_vals": ValueError,
          "k9_non_contiguous": ValueError, "k9_other_device": RuntimeError,
          "k10_mixed_dtypes": TypeError, "k10_wrong_dinv": ValueError,
          "k11_mixed_dtypes": TypeError,
          "k11_plan_of_another_pattern": ValueError}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_wrapper_raises(case):
    with pytest.raises(RAISES[case]):
        _raises(case)


# ------------------------------------------------------ the index tables ----

@pytest.mark.parametrize("where", ["preconditioner", "distributed"])
def test_index_tables_built_once_per_pattern(where, monkeypatch):
    """K11's pair table is built once per preconditioner (once per shard
    under the distributed solver), and the int32 column ids once per
    padded matrix; both survive ``update_values`` and re-factors."""
    built = []
    init = padded.FactorSweepPlan.__init__

    def counted(self, *args, **kw):
        built.append(self)
        init(self, *args, **kw)

    monkeypatch.setattr(padded.FactorSweepPlan, "__init__", counted)
    A, b, _ = poisson3d_system((6, 6, 6), "uniform")
    s = AsyncSolverSettings(prec_type=PrecType.ILU0, nbuildsweeps=2,
                            napplysweeps=2)
    if where == "preconditioner":
        p = ILU0Preconditioner(A.pad(device="cpu"), nbuildsweeps=2,
                               napplysweeps=2)
        precs = [p]
    else:
        ds = DistributedSolver(A, make_mesh(2, devices=["cpu"] * 2), s)
        precs = ds.prec.precs
    for p in precs:
        p.compute()
        p.apply(torch.zeros(p.mat.nrows, dtype=torch.float64))
    cols = [padded.col_table(p.mat) for p in precs]
    for p in precs:
        p.update_values(1.5 * p.mat.flat_vals())
        p.compute()
        p.apply(torch.zeros(p.mat.nrows, dtype=torch.float64))
    assert built == [p.symbolic.plan for p in precs]
    assert all(padded.col_table(p.mat) is c for p, c in zip(precs, cols))
    assert all(c.dtype == torch.int32 for c in cols)


def test_block_factor_keeps_the_torch_inverse():
    """K11's block divisors come from the padded path's torch inverse
    (``ops/sweeps.py::_gauss_jordan_inverse``), not from the block-DIA
    inverse kernel: that kernel's twin (``block_inverse_ref``, SoA)
    scales the pivot row by the pivot's reciprocal where the padded path
    divides by the pivot, so the two agree to rounding but not to the
    bit."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((500, 4, 4)) + 3 * np.eye(4))
    aos = invert_diag_blocks(a)
    soa = block_inverse_ref(a.reshape(-1, 16).t().contiguous())
    soa = soa.t().reshape(-1, 4, 4)
    _close(aos, soa, rtol=1e-12)
    assert not torch.equal(aos, soa)


# ----------------------------------------------------------- the slice ----

@pytest.mark.parametrize("bs", [1, 2])
def test_padded_ilu0_8_4_matches_jax(bs):
    """ILU(0) 8,4 (the padded main path's options) on a random padded
    matrix: the factor (eight K11 twin sweeps), its inverse diagonal and
    one apply (four K10 sweeps of each mode) against JAX's."""
    P, Pj = _pair(bs, spare=0)
    cls, jcls = (ILU0Preconditioner, JaxILU) if bs == 1 \
        else (BlockILU0Preconditioner, JaxBILU)
    p = cls(P, nbuildsweeps=8, napplysweeps=4)
    pj = jcls(Pj, nbuildsweeps=8, napplysweeps=4)
    p.compute()
    pj.compute()
    for f in ("ilu", "ilu_dinv"):
        _close(getattr(p.state, f), getattr(pj.state, f), rtol=1e-11)
    r = _vec(P, np.random.default_rng(30 + bs))
    _close(p.apply(torch.from_numpy(r)), pj.apply(jnp.asarray(r)),
           rtol=1e-11)


@pytest.mark.parametrize("block", [False, True], ids=["csr", "bsr"])
def test_padded_solve_runs_the_kernels_wrappers(block, monkeypatch):
    """``solve`` with ``prefer_dia: False`` and ILU(0) 8,4 reaches every
    wrapper as often as ``chip_smoke.py``'s launch rule ``ilu_launches``
    requires of the kernels on the card: K9 once per SpMV (2·iters + 1
    with BiCGSTAB), K10 four times per mode per apply (two applies per
    iteration), K11 eight times."""
    import chip_smoke

    calls = dict.fromkeys(["padded_spmv", "padded_lower_sweep",
                           "padded_upper_sweep", "padded_factor_sweep"], 0)
    for name in calls:
        twin = getattr(padded, name + "_ref")

        def counted(*args, _twin=twin, _name=name):
            calls[_name] += 1
            return _twin(*args)

        monkeypatch.setattr(padded, name + "_ref", counted)
    if block:
        B, _ = bsr_pair(nb=60, bs=3, density=0.08, seed=4)
        M = B
    else:
        M, _, _ = poisson3d_system((7, 7, 7), "uniform")
    b = np.random.default_rng(5).standard_normal(M.nrows)
    opts = {"blasted_pc_type": "ilu0", "blasted_async_sweeps": "8,4",
            "prefer_dia": False, "ksp_type": "bicgstab", "rtol": 1e-8}
    x, info, ctx = api.solve(M, b, opts, device="cpu")
    assert info.converged
    assert type(ctx.prec.mat).__name__ == ("PaddedBSR" if block
                                           else "PaddedCSR")
    assert calls == chip_smoke.ilu_launches("padded", 8, 4, info.iters)
    res = np.linalg.norm(b - M.to_scipy() @ x.numpy()) / np.linalg.norm(b)
    assert res < 1e-7
