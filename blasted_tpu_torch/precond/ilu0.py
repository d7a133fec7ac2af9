"""Fixed-point ("asynchronous") ILU(0) on the padded forms, scalar and block.

Port of ``blasted_tpu/precond/ilu0.py:68-392, 482-629``
(``AsyncILU0_SRPreconditioner`` / ``AsyncBlockILU0_SRPreconditioner``;
reference: src/solverops_ilu0.cpp, src/async_ilu_factor.cpp,
src/async_blockilu_factor.cpp, src/kernels/kernels_ilu0_factorize.hpp).

Factorization (Chow–Patel): ``nbuildsweeps`` times the whole-pattern update

    lower (i>c):  l_ic ← (â_ic − Σ l_ik u_kc) / u_cc
    upper (i<=c): u_ic ←  â_ic − Σ l_ik u_kc

with every right-hand value read from the previous sweep.  The pair lists
come from the host symbolic pass (``ilu_pattern.py``); one sweep is kernel
K11 (``ops/padded.py``: the pair products and one divide, block: a product
with the previous sweep's inverted diagonal blocks, which torch computes
per sweep) over the lists in int32 CSR form, and the apply's sweeps are
K10 on the pre-masked triangles — XLA gathers in JAX, with no Pallas
kernel on this path.

``nbuildsweeps == SEQUENTIAL`` (−1) selects the exact factorization: a host
loop over the entry-level slot schedule (``compute_fact_slots``), each step
updating one chunk of mutually independent entries with ``index_put_``;
``napplysweeps == SEQUENTIAL`` selects exact level-scheduled triangular
solves.  The levels and the slot schedule are built on first use by a
SEQUENTIAL phase only (the JAX class builds both in every first compute).
Optional symmetric scaling Â = S·A·S, S = diag(1/√a_ii) (reference:
async_ilu_factor.cpp:43-45).  With ``compute_precinfo`` the factor reports
the fixed-point remainder before and after its sweeps and the diagonal
dominance of the factors.  The JAX shard-state hooks have no counterpart:
the distributed solvers build one preconditioner per shard.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SEQUENTIAL, ApplyInit, FactInit
from ..ops.padded import (
    FactorSweepPlan,
    bmm,
    col_table,
    padded_factor_sweep,
    padded_lower_sweep,
    padded_upper_sweep,
)
from ..ops.sweeps import invert_diag_blocks, run_sweeps, triangle
from ..sparse.csr import extend_zero, flat_colind, take
from .base import Preconditioner, PrecInfo
from .diagnostics import (
    block_diagonal_dominance,
    diagonal_dominance,
    prec_info,
)
from .ilu_pattern import (
    compute_fact_slots,
    compute_ilu_positions,
    pad_ilu_positions,
    rows_of_nnz,
)
from .levels import (
    compute_levels_lower,
    compute_levels_upper,
    exact_block_lower_solve,
    exact_block_upper_solve,
    exact_lower_solve,
    exact_upper_solve,
)

__all__ = ["ILU0Preconditioner", "BlockILU0Preconditioner"]


class _ILUSymbolic(NamedTuple):
    """Symbolic data, computed once per sparsity pattern (the reference
    caches plist across compute() calls, solverops_ilu0.cpp:193-196)."""

    lowerp: torch.Tensor    # (nnz, P) int64 pair gather indices, sentinel nnz
    upperp: torch.Tensor    # (nnz, P)
    colind: torch.Tensor    # (nnz,) int64 — column of each stored nonzero
    rows: torch.Tensor      # (nnz,) int64 — row of each stored nonzero
    is_lower: torch.Tensor  # (nnz,) bool — strictly-lower entries
    plan: FactorSweepPlan   # K11's int32 pair lists and divisor table
    host: tuple             # (rowptr, colind) numpy, for the lazy schedules


class _ILUState(NamedTuple):
    ilu: torch.Tensor            # (nnz,) or (nnzb, bs, bs) factor values
    lower: torch.Tensor          # row-padded strictly-lower factor values
    upper: torch.Tensor          # row-padded strictly-upper factor values
    ilu_dinv: torch.Tensor       # 1/u_ii or inv(U_ii)
    scale: torch.Tensor | None   # (n,) or (nbrows, bs) scaling, or None


def _build_symbolic(P, block: bool) -> _ILUSymbolic:
    """Pair lists and per-entry tables of the padded matrix ``P``; K11's
    divisor of a strictly-lower entry is u_cc's position in the iterate
    (scalar) or the column c, a row of the inverted diagonal blocks
    (block)."""
    rowptr = P.rowptr.cpu().numpy()
    colind = flat_colind(P)
    nnz = P.nnz_total
    diagind = P.diagind.cpu().numpy()
    plist = compute_ilu_positions(rowptr, colind, diagind)
    padded = pad_ilu_positions(plist, nnz)
    rows = rows_of_nnz(rowptr)
    lower = colind < rows
    dev = P.device

    def put(a, dtype=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    dtab = np.where(lower, colind if block else diagind[colind], -1)
    plan = FactorSweepPlan(plist.posptr, plist.lowerp, plist.upperp, dtab,
                           P.nbrows if block else nnz, dev)
    return _ILUSymbolic(lowerp=put(padded.lowerp), upperp=put(padded.upperp),
                        colind=put(colind), rows=put(rows),
                        is_lower=put(lower, torch.bool), plan=plan,
                        host=(rowptr, colind))


def _build_levels(sym: _ILUSymbolic, device):
    """(low_level, nlow, up_level, nup): row wavefronts of the exact solves
    (the factorization's row levels equal the lower solve's)."""
    low = compute_levels_lower(*sym.host)
    up = compute_levels_upper(*sym.host)
    return (torch.from_numpy(low).to(device), int(low.max()) + 1,
            torch.from_numpy(up).to(device), int(up.max()) + 1)


def _build_slots(sym: _ILUSymbolic, low_level: np.ndarray,
                 chunk_size: int) -> torch.Tensor:
    """The entry-level exact schedule as one (nchunks, maxseg) tensor of
    entry ids per scan step, padded with the sentinel ``nnz``."""
    slots = compute_fact_slots(*sym.host, low_level, chunk_size=chunk_size)
    nnz = sym.host[1].shape[0]
    ar = np.arange(slots.maxseg)
    idx = slots.order[slots.starts[:, None] + ar]
    idx = np.where(ar < slots.lens[:, None], idx, nnz).astype(np.int64)
    return torch.from_numpy(idx).to(sym.colind.device)


def _segmented_exact_factor(base, ilu, sym: _ILUSymbolic, slots, diagind,
                            block: bool):
    """Exact IKJ ILU(0) by entry-level wavefront slots: one step per slot
    chunk touches only that chunk's entries, each updated once, after every
    dependency is final.  Padded lanes carry the sentinel ``nnz``: they all
    write slot ``nnz`` (duplicate indices, no defined winner), which is
    reset to zero after every step, so no live value reads them."""
    nnz = base.shape[0]
    pad = sym.lowerp.new_full((1, sym.lowerp.shape[1]), nnz)
    lowerp = torch.cat([sym.lowerp, pad])
    upperp = torch.cat([sym.upperp, pad])
    base_e = extend_zero(base)
    islow_e = extend_zero(sym.is_lower)
    col_e = extend_zero(sym.colind)
    ilu_e = extend_zero(ilu)
    for idx in slots.unbind(0):
        lp, up = take(lowerp, idx), take(upperp, idx)
        islow = islow_e[idx]
        # u_cc is final (diag of row c sits in a strictly earlier slot)
        ud = take(ilu_e, diagind[col_e[idx]])
        if block:
            s = take(base_e, idx) - bmm(take(ilu_e, lp),
                                        take(ilu_e, up)).sum(1)
            newv = torch.where(islow[:, None, None],
                               bmm(s, invert_diag_blocks(ud)), s)
        else:
            s = base_e[idx] - (ilu_e[lp] * ilu_e[up]).sum(1)
            newv = torch.where(islow, s / torch.where(islow, ud, 1.0), s)
        ilu_e[idx] = newv
        ilu_e[nnz] = 0.0
    return ilu_e[:nnz]


class _PaddedILU0(Preconditioner):
    """What the scalar and block classes share: options, the symbolic data,
    the lazy SEQUENTIAL schedules and compute()."""

    _BLOCK = False

    def __init__(self, mat, nbuildsweeps: int = 1, napplysweeps: int = 1,
                 use_scaling: bool = False,
                 fact_init: FactInit = FactInit.ORIGINAL,
                 apply_init: ApplyInit = ApplyInit.ZERO,
                 compute_precinfo: bool = False,
                 thread_chunk_size: int = 0):
        super().__init__(mat)
        self.nbuildsweeps = nbuildsweeps
        self.napplysweeps = napplysweeps
        self.use_scaling = use_scaling
        self.fact_init = fact_init
        self.apply_init = apply_init
        self.compute_precinfo = compute_precinfo
        self.thread_chunk_size = thread_chunk_size
        self.symbolic: _ILUSymbolic | None = None
        self._levels = None
        self._slots = None
        self._vals = None   # flat values of the *current* matrix

    def _ensure_symbolic(self):
        """Symbolic data survives :meth:`update_values`; values are re-read
        from the current matrix on every compute()."""
        if self.symbolic is None:
            self.symbolic = _build_symbolic(self.mat, self._BLOCK)
        self._vals = self.mat.flat_vals()

    def _schedule_levels(self):
        if self._levels is None:
            self._levels = _build_levels(self.symbolic, self.mat.device)
        return self._levels

    def _schedule_slots(self):
        if self._slots is None:
            low = self._schedule_levels()[0].cpu().numpy()
            self._slots = _build_slots(self.symbolic, low,
                                       self.thread_chunk_size)
        return self._slots

    def compute(self) -> PrecInfo:
        self._ensure_symbolic()
        scale = self._scale()
        base = self._scaled_vals(scale)
        if self.state is not None and self.fact_init == FactInit.NONE:
            ilu = self.state.ilu                 # warm start from last compute
        else:
            ilu = self._fact_initial(base)
        diagind = self.mat.diagind
        info0 = self._nonlinear_res(base, ilu) if self.compute_precinfo \
            else None
        if self.nbuildsweeps == SEQUENTIAL:
            ilu = _segmented_exact_factor(base, ilu, self.symbolic,
                                          self._schedule_slots(), diagind,
                                          block=self._BLOCK)
        else:
            ilu = run_sweeps(self.nbuildsweeps, self.factor_sweep_fn(base),
                             ilu)
        udiag = take(ilu, diagind)
        # the triangles are masked once here, not in every apply sweep
        pad = self.mat.repad_vals(ilu)
        self.state = _ILUState(ilu=ilu, lower=triangle(self.mat, pad, "lower"),
                               upper=triangle(self.mat, pad, "upper"),
                               ilu_dinv=self._diag_inverse(udiag),
                               scale=scale)
        if self.compute_precinfo:
            return prec_info(info0, self._nonlinear_res(base, ilu),
                             self._dominance(self.mat, pad))
        return PrecInfo()

    def _nonlinear_res(self, base, ilu) -> torch.Tensor:
        """Σ|â_j − Σ_k l·u − (l_j·u_cc | u_j)|, the ILU fixed-point
        remainder (reference: async_ilu_factor.cpp
        scalar_ilu0_nonlinear_res, :179-217; block_ilu0_nonlinear_res,
        async_blockilu_factor.cpp:97-141)."""
        sym = self.symbolic
        ext = extend_zero(ilu)
        udiag_c = take(take(ilu, self.mat.diagind), sym.colind)
        if self._BLOCK:
            s = base - bmm(take(ext, sym.lowerp), take(ext, sym.upperp)).sum(1)
            lu = bmm(ilu, udiag_c)
            s = s - torch.where(sym.is_lower[:, None, None], lu, ilu)
        else:
            s = base - (ext[sym.lowerp] * ext[sym.upperp]).sum(1)
            s = s - torch.where(sym.is_lower, ilu * udiag_c, ilu)
        return s.abs().sum()

    def factor_sweep_fn(self, base):
        """One Chow–Patel sweep ``ilu → ilu'`` on the flat values (K11);
        the divisors are the previous sweep's (``_divisors``)."""
        plan = self.symbolic.plan
        return lambda ilu: padded_factor_sweep(plan, base, ilu,
                                               self._divisors(ilu))

    def apply_with(self, mat, state, r: torch.Tensor) -> torch.Tensor:
        """Solve LU z ≈ r by sweep (or exact wavefront) triangular solves
        (reference: scalar_ilu0_apply, solverops_ilu0.cpp:240-321;
        block_ilu0_apply, :55-148): K10's two modes on the pre-masked
        triangles; block vectors are (nbrows, bs)."""
        st = state
        z = st.scale * r if st.scale is not None else r
        if self.napplysweeps == SEQUENTIAL:
            low, nlow, up, nup = self._schedule_levels()
            lower_solve, upper_solve = self._EXACT
            y = lower_solve(mat, st.lower, z, low, nlow)
            zout = upper_solve(mat, st.upper, st.ilu_dinv, y, up, nup)
        else:
            col = col_table(mat)
            y = run_sweeps(self.napplysweeps,
                           lambda yy: padded_lower_sweep(st.lower, col, z, yy),
                           torch.zeros_like(z))
            z0 = y if self.apply_init == ApplyInit.JACOBI \
                else torch.zeros_like(z)
            zout = run_sweeps(
                self.napplysweeps,
                lambda zz: padded_upper_sweep(st.upper, col, st.ilu_dinv, y,
                                              zz),
                z0)
        return st.scale * zout if st.scale is not None else zout

    def apply_relax(self, b, x):
        raise NotImplementedError("ILU relaxation not implemented "
                                  "(matches reference, solverops_ilu0.cpp"
                                  ":378-383)")


# ================================================================= scalar ====

class ILU0Preconditioner(_PaddedILU0):
    """Scalar fixed-point ILU(0) on padded CSR (reference:
    solverops_ilu0.cpp:218-383)."""

    _dominance = staticmethod(diagonal_dominance)
    _EXACT = (exact_lower_solve, exact_upper_solve)

    def _scale(self):
        if not self.use_scaling:
            return None
        return 1.0 / torch.sqrt(self._vals[self.mat.diagind])

    def _scaled_vals(self, scale):
        if scale is None:
            return self._vals
        sym = self.symbolic
        return scale[sym.rows] * self._vals * scale[sym.colind]

    def _fact_initial(self, base):
        """Initial iterate (reference: async_ilu_factor.cpp:47-60, 109-151;
        INIT_F_ZERO falls through to the original-matrix init)."""
        if self.fact_init == FactInit.SGS:
            # L' = L D⁻¹ (+I implied), U' = D+U so L'U' = (D+L)D⁻¹(D+U)
            sym = self.symbolic
            diag = base[self.mat.diagind]
            return torch.where(sym.is_lower, base / diag[sym.colind], base)
        return base

    @staticmethod
    def _diag_inverse(udiag):
        return 1.0 / udiag

    @staticmethod
    def _divisors(ilu):
        """K11 divides a lower entry by u_cc of the iterate itself."""
        return ilu


# ================================================================== block ====

class BlockILU0Preconditioner(_PaddedILU0):
    """Block fixed-point ILU(0) on padded BSR (reference:
    solverops_ilu0.cpp:19-216, async_blockilu_factor.cpp).  The lower update
    right-multiplies by the inverse of the previous sweep's diagonal block
    (kernels_ilu0_factorize.hpp:86-96); diagonal blocks are pre-inverted
    for the apply (async_blockilu_factor.cpp:143-147)."""

    _BLOCK = True
    _dominance = staticmethod(block_diagonal_dominance)
    _EXACT = (exact_block_lower_solve, exact_block_upper_solve)

    def _scale(self):
        if not self.use_scaling:
            return None
        dblocks = take(self._vals, self.mat.diagind)
        return 1.0 / torch.sqrt(torch.diagonal(dblocks, dim1=-2, dim2=-1))

    def _scaled_vals(self, scale):
        """scaleBlock: val[i,j] *= s[row·bs+i]·s[col·bs+j]
        (reference: kernels_ilu0_factorize.hpp:61-69); scale is
        (nbrows, bs)."""
        if scale is None:
            return self._vals
        sym = self.symbolic
        return self._vals * take(scale, sym.rows)[:, :, None] \
            * take(scale, sym.colind)[:, None, :]

    def _fact_initial(self, base):
        if self.fact_init == FactInit.SGS:
            sym = self.symbolic
            dinv = invert_diag_blocks(take(base, self.mat.diagind))
            lowered = bmm(base, take(dinv, sym.colind))
            return torch.where(sym.is_lower[:, None, None], lowered, base)
        return base

    @staticmethod
    def _diag_inverse(udiag):
        return invert_diag_blocks(udiag)

    def _divisors(self, ilu):
        """The previous sweep's inverted diagonal blocks (nbrows, bs, bs),
        which K11 right-multiplies the lower blocks by."""
        return invert_diag_blocks(take(ilu, self.mat.diagind))
