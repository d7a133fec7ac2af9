"""Fixed-point block ILU(0) on block-DIA storage — gather-free.

Port of ``blasted_tpu/precond/bdia_ilu0.py:51-468``: the block analogue of
:mod:`~blasted_tpu_torch.precond.dia_ilu0` (same diagonal-pair structure)
with the block algebra of the reference's point-block kernels (reference:
kernels_ilu0_factorize.hpp:71-98 async_block_ilu0_factorize,
async_blockilu_factor.cpp).  One factorization sweep is, per block
diagonal o,

    S_o[i]   = Â_o[i] − Σ_{(o1,o2)} ilu_o1[i] · ilu_o2[i+o1]     (bs×bs products)
    ilu_o[i] = S_o[i] · (ilu_0[i+o])⁻¹                           (o < 0)

with the previous sweep's diagonal-block inverses from the batched pivoted
Gauss–Jordan, and the diagonal blocks inverted once more after the last
sweep for the triangular applies (reference: async_blockilu_factor.cpp
:143-147).  Everything works on ``(bs², nb)`` component slabs, the
container's layout; a block product is bs unrolled multiply-adds over
``(bs, bs, nb)`` views.

The factor takes one of two routes, chosen by
:func:`~blasted_tpu_torch.ops.bstencil.bdia_factor_takes_compressed_route`
from the problem and the options only: the compressed sweeps (kernel K6
where every diagonal block is stored, else the torch u0-state chain with
the same iterates) or the plain per-sweep chain (torch operations).  Block
inverses (the JAX package's ``_soa_gj_inverse``) go through
``bdia_block_inverse``; the apply sweeps are kernel K7 (``ops/bdia.py``),
the level-scheduled (SEQUENTIAL) ones included.  An apply from zero
(``ApplyInit.ZERO``) with at least two sweeps and the factor in the
vector's dtype starts each chain with kernel K13, the block head sweep,
which computes K7's first two sweeps from zero in one launch: the first of
them yields the right-hand side (lower) or the inverse diagonal blocks
times it (upper), so the chain runs one K13 and ``napplysweeps − 2`` K7
launches a triangle, no fill, and equals the K7 chain from zero bit for
bit on finite factors (the sign of a zero aside).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SEQUENTIAL, ApplyInit, FactInit
from ..ops.bdia import (
    cols_of,
    soa_unit_lower_sweep,
    soa_upper_solve_sweep,
    stack_cols,
)
from ..ops.bstencil import (
    bdia_block_inverse,
    bdia_factor_stencil,
    bdia_factor_takes_compressed_route,
    bdia_head_sweep_stencil,
)
from ..ops.sweeps import run_sweeps
from ..sparse.bdia import BlockDiaMatrix, block_pattern_csr, shift_last
from ..utils import profiling
from .base import Preconditioner, PrecInfo
from .diagnostics import bdia_block_diagonal_dominance, prec_info
from .dia_ilu0 import dia_pairs
from .levels import compute_levels_lower, compute_levels_upper, level_loop

__all__ = ["BlockDiaILU0Preconditioner", "bdia_factor_sweep",
           "bdia_factor_sweeps_soa", "bdia_factor_sweeps_compressed",
           "bdia_ilu_remainder"]


def _soa_bmm(a: torch.Tensor, b: torch.Tensor, bs: int,
             shift: int = 0) -> torch.Tensor:
    """Block product on (bs², nb) slabs: ``c[i·bs+k] = Σ_j a[i,j]·b[j,k]``
    with ``b`` read at block-row offset ``shift``, summed over j in order."""
    nb = a.shape[-1]
    A = a.reshape(bs, bs, nb)
    B = shift_last(b, shift).reshape(bs, bs, nb)
    c = A[:, 0:1] * B[0:1]
    for j in range(1, bs):
        c = c + A[:, j:j + 1] * B[j:j + 1]
    return c.reshape(bs * bs, nb)


def _masked(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` (…, bs², nb) zeroed outside the (…, nb) structural mask."""
    return torch.where(mask.unsqueeze(-2), t, 0.0)


def _soa_sweep(offsets, pairs, d0, mask, base, ilu, bs: int) -> torch.Tensor:
    """One block Chow–Patel sweep over (k, bs², nb) values; re-masks every
    diagonal so band fill stays exactly out of the ILU(0) pattern."""
    dinv = bdia_block_inverse(ilu[d0], mask[d0])
    out = []
    for d, o in enumerate(offsets):
        if not pairs[d] and o > 0:
            out.append(ilu[d])                  # pair-free upper: fixed point
            continue
        s = base[d]
        for (dl, du, o1) in pairs[d]:
            s = s - _soa_bmm(ilu[dl], ilu[du], bs, shift=o1)
        if o < 0:
            s = _soa_bmm(s, dinv, bs, shift=o)
        out.append(_masked(mask[d], s))
    return torch.stack(out)


def bdia_factor_sweeps_soa(offsets, pairs, d0, mask, base, ilu0,
                           nsweeps: int, level=None, fact_inner: int = 1,
                           nlev: int = 0) -> torch.Tensor:
    """Run the plain block fixed-point factorization.  With ``level`` given
    (the exact path), each of ``nlev × fact_inner`` steps commits only the
    block rows of the active wavefront, reproducing the sequential
    factorization."""
    bs = int(round(ilu0.shape[1] ** 0.5))
    base_t = _masked(mask, base)
    ilu = ilu0
    if level is None:
        for _ in range(nsweeps):
            ilu = _soa_sweep(offsets, pairs, d0, mask, base_t, ilu, bs)
    else:
        for it in range(nlev * fact_inner):
            new = _soa_sweep(offsets, pairs, d0, mask, base_t, ilu, bs)
            ilu = torch.where(level == it // fact_inner, new, ilu)
    return ilu


def bdia_factor_sweep(offsets, pairs, d0, mask, base, ilu) -> torch.Tensor:
    """One block Chow–Patel fixed-point sweep on (k, bs², nb) values."""
    bs = int(round(ilu.shape[1] ** 0.5))
    return _soa_sweep(offsets, pairs, d0, mask, base, ilu, bs)


def bdia_ilu_remainder(offsets, pairs, mask, base, ilu) -> torch.Tensor:
    """Block ILU fixed-point remainder on block-DIA storage (reference:
    block_ilu0_nonlinear_res, async_blockilu_factor.cpp:97-141), per block
    diagonal with shifted slab block products."""
    bs = int(round(ilu.shape[1] ** 0.5))
    udiag = ilu[offsets.index(0)]
    total = base.new_zeros(())
    for d, o in enumerate(offsets):
        s = base[d]
        for (dl, du, o1) in pairs[d]:
            s = s - _soa_bmm(ilu[dl], ilu[du], bs, shift=o1)
        if o < 0:
            s = s - _soa_bmm(ilu[d], udiag, bs, shift=o)
        else:
            s = s - ilu[d]
        total = total + _masked(mask[d], s).abs().sum()
    return total


def bdia_factor_sweeps_compressed(offsets, pairs, d0, mask, base, ilu0,
                                  nsweeps: int,
                                  diag_mask_full: bool | None = None):
    """Compressed (substituted) block Chow–Patel sweeps.  For bands where
    only the main diagonal carries fill pairs, substituting the lower
    update L_o = Â_o·(U_0[·+o])⁻¹ into the diagonal update makes U_0 the
    only evolving state,

      U_0' = Â_0 − Σ_pairs mask(Â_l(o1)·inv(U_0)[·+o1]) · ub_pre,

    with the pair uppers pre-shifted once.  Each sweep carries the
    contraction of two plain sweeps: after K sweeps the diagonal equals the
    plain chain at 2K and the returned lowers (from the second-to-last
    iterate) equal it at 2K−1.  Uppers pass through.

    With every diagonal block stored (``diag_mask_full``) the inverse
    diagonal is the state and each sweep is one K6 launch: K−1 sweeps emit
    Dinv, the last one U0 (``precond/bdia_ilu0.py:194-227`` of the JAX
    package).  Otherwise the u0-state chain runs in torch; both give the
    same iterates."""
    if nsweeps <= 0:
        return ilu0
    bs = int(round(ilu0.shape[1] ** 0.5))
    base_t = _masked(mask, base)
    pairs_key = pairs[d0]
    pair_offs = tuple(o1 for (_, _, o1) in pairs_key)
    ub_pre = [shift_last(ilu0[du], o1) for (_, du, o1) in pairs_key]
    if diag_mask_full is None:
        diag_mask_full = bool(mask[d0].all())

    if diag_mask_full:
        base0 = base_t[d0]
        base_l = torch.stack([base_t[dl] for (dl, _, _) in pairs_key]) \
            if pairs_key else base_t[:0]
        ubs = torch.stack(ub_pre) if pairs_key else base_t[:0]
        dinv_prev = bdia_block_inverse(ilu0[d0], mask[d0])
        for _ in range(nsweeps - 1):
            dinv_prev = bdia_factor_stencil(pair_offs, base0, base_l, ubs,
                                            dinv_prev, out_dinv=True)
        u0_last = bdia_factor_stencil(pair_offs, base0, base_l, ubs,
                                      dinv_prev, out_dinv=False)
    else:
        def F(u0):
            dinv = bdia_block_inverse(u0, mask[d0])
            s = base_t[d0]
            for j, (dl, _, o1) in enumerate(pairs_key):
                low = _masked(mask[dl], _soa_bmm(base_t[dl], dinv, bs,
                                                 shift=o1))
                s = s - _soa_bmm(low, ub_pre[j], bs)
            return _masked(mask[d0], s)

        u0_prev = u0_last = ilu0[d0]
        for _ in range(nsweeps):
            u0_prev, u0_last = u0_last, F(u0_last)
        dinv_prev = bdia_block_inverse(u0_prev, mask[d0])

    # the lowers of the final state come from the previous diagonal iterate
    out = ilu0.clone()
    for d, o in enumerate(offsets):
        if o == 0:
            out[d] = u0_last
        elif o < 0:
            out[d] = _masked(mask[d], _soa_bmm(base_t[d], dinv_prev, bs,
                                               shift=o))
    return out


class _BDiaILUState(NamedTuple):
    ilu: torch.Tensor            # (k, bs², nb) factor values
    ilu_dinv: torch.Tensor       # (bs², nb) inverted diagonal blocks
    scale: torch.Tensor | None   # (nb, bs) symmetric scaling, or None


class BlockDiaILU0Preconditioner(Preconditioner):
    """Point-block fixed-point ILU(0) on block-DIA storage."""

    def __init__(self, mat: BlockDiaMatrix, nbuildsweeps: int = 1,
                 napplysweeps: int = 1, use_scaling: bool = False,
                 fact_init: FactInit = FactInit.ORIGINAL,
                 apply_init: ApplyInit = ApplyInit.ZERO,
                 apply_dtype=None, compute_precinfo: bool = False):
        super().__init__(mat)
        self.nbuildsweeps = nbuildsweeps
        self.napplysweeps = napplysweeps
        self.use_scaling = use_scaling
        self.fact_init = fact_init
        self.apply_init = apply_init
        self.compute_precinfo = compute_precinfo
        self.apply_dtype = apply_dtype   # see DiaILU0Preconditioner
        self._d0 = mat.d0
        self._pairs = dia_pairs(mat.offsets)
        self._diag_mask_full = mat.resolved_diag_mask_full()
        self._levels = None

    # -- helpers ------------------------------------------------------------

    def _build_levels(self):
        """Block-row wavefront levels, built on first use by a SEQUENTIAL
        phase only (the JAX class builds them in every compute and apply)."""
        if self._levels is None:
            indptr, indices = block_pattern_csr(self.mat)
            low = compute_levels_lower(indptr, indices)
            up = compute_levels_upper(indptr, indices)
            nlow_inner = sum(1 for o in self.mat.offsets if o < 0) + 1
            dev = self.mat.device
            self._levels = (torch.from_numpy(low).to(dev), int(low.max()) + 1,
                            torch.from_numpy(up).to(dev), int(up.max()) + 1,
                            nlow_inner)
        return self._levels

    def _scaled_base(self, scale):
        """scaleBlock on diagonals: ``val[i,j] *= s_row[i]·s_col[j]``
        (reference: kernels_ilu0_factorize.hpp:61-69); scale is (nb, bs)."""
        A = self.mat
        if scale is None:
            return A.data
        bs, nb = A.bs, A.nbrows
        srow = cols_of(scale)
        out = []
        for d, o in enumerate(A.offsets):
            scol = shift_last(srow, o)
            blk = A.data[d].view(bs, bs, nb) * srow[:, None] * scol[None]
            out.append(blk.reshape(bs * bs, nb))
        return torch.stack(out)

    def _fact_initial(self, base):
        A = self.mat
        if self.fact_init != FactInit.SGS:
            return base
        dinv = bdia_block_inverse(base[self._d0], A.mask[self._d0])
        out = []
        for d, o in enumerate(A.offsets):
            if o < 0:
                out.append(_masked(A.mask[d],
                                   _soa_bmm(base[d], dinv, A.bs, shift=o)))
            else:
                out.append(base[d])
        return torch.stack(out)

    # -- compute / apply ----------------------------------------------------

    def compute(self) -> PrecInfo:
        A = self.mat
        bs, d0, offsets, pairs = A.bs, self._d0, A.offsets, self._pairs
        scale = None
        if self.use_scaling:
            d0c = A.data[d0]
            diag = stack_cols(torch.stack([d0c[i * bs + i]
                                           for i in range(bs)]))
            scale = 1.0 / torch.sqrt(diag)
        base = self._scaled_base(scale)

        if self.state is not None and self.fact_init == FactInit.NONE:
            ilu = self.state.ilu
        else:
            ilu = self._fact_initial(base)

        info0 = self._nonlinear_res(base, ilu) if self.compute_precinfo \
            else None
        with profiling.annotate("precond.block_factor"):
            if self.nbuildsweeps == SEQUENTIAL:
                low, nlow, _, _, fact_inner = self._build_levels()
                ilu = bdia_factor_sweeps_soa(offsets, pairs, d0, A.mask,
                                             base, ilu, 0, level=low,
                                             fact_inner=fact_inner,
                                             nlev=nlow)
            elif bdia_factor_takes_compressed_route(offsets, pairs,
                                                    self.nbuildsweeps,
                                                    self.fact_init):
                ilu = bdia_factor_sweeps_compressed(
                    offsets, pairs, d0, A.mask, base, ilu,
                    self.nbuildsweeps, diag_mask_full=self._diag_mask_full)
            else:
                ilu = bdia_factor_sweeps_soa(offsets, pairs, d0, A.mask,
                                             base, ilu, self.nbuildsweeps)

        # the inverse diagonal blocks come from the unrounded factor
        with profiling.annotate("precond.block_inverse"):
            dinv = bdia_block_inverse(ilu[d0], A.mask[d0])
        self.state = _BDiaILUState(
            ilu=ilu if self.apply_dtype is None else ilu.to(self.apply_dtype),
            ilu_dinv=dinv, scale=scale)
        if self.compute_precinfo:
            return prec_info(info0, self._nonlinear_res(base, ilu),
                             bdia_block_diagonal_dominance(A, ilu))
        return PrecInfo()

    def _nonlinear_res(self, base, ilu) -> torch.Tensor:
        A = self.mat
        return bdia_ilu_remainder(A.offsets, self._pairs, A.mask, base, ilu)

    def load_state_numpy(self, ilu, dinv, scale=None) -> None:
        """Install factors given as numpy arrays — e.g. the fields ``ilu``
        (k × bs² streams of (nb,)), ``ilu_dinv`` (bs² streams) and
        ``scale`` ((nb, bs)) of a ``blasted_tpu`` block-DIA ILU(0) state —
        on this operator's device."""
        dev = self.mat.device

        def put(v):
            return torch.tensor(np.asarray(v), device=dev)

        self.state = _BDiaILUState(ilu=put(ilu), ilu_dinv=put(dinv),
                                   scale=None if scale is None else put(scale))

    def apply_with(self, mat, state, r: torch.Tensor) -> torch.Tensor:
        """``r`` and the result are (nb, bs) block vectors; the sweeps carry
        (bs, nb) column streams.  A ``precond.block_apply`` span, counted in
        the counter of that name; the applies whose chains start with K13
        are counted in ``precond.block_zero_start`` too."""
        profiling.count("precond.block_apply")
        with profiling.annotate("precond.block_apply"):
            return self._apply(mat, state, r)

    def _apply(self, mat, state, r: torch.Tensor) -> torch.Tensor:
        st = state
        A = mat
        bs, offsets = A.bs, A.offsets
        lower = [d for d, o in enumerate(offsets) if o < 0]
        upper = [d for d, o in enumerate(offsets) if o > 0]
        z = st.scale * r if st.scale is not None else r
        zc = cols_of(z)

        if self.napplysweeps == SEQUENTIAL:
            low, nlow, up, nup, _ = self._build_levels()
            y = level_loop(
                nlow, low,
                lambda y: stack_cols(soa_unit_lower_sweep(
                    st.ilu, offsets, lower, zc, cols_of(y), bs)),
                torch.zeros_like(z))
            yc = cols_of(y)
            zout = level_loop(
                nup, up,
                lambda zz: stack_cols(soa_upper_solve_sweep(
                    st.ilu, st.ilu_dinv, offsets, upper, yc, cols_of(zz),
                    bs)),
                torch.zeros_like(z))
        elif (self.apply_init == ApplyInit.ZERO and self.napplysweeps >= 2
              and st.ilu.dtype == zc.dtype):
            # K13 heads each chain; the dtypes are K7's route (ops/bdia.py)
            profiling.count("precond.block_zero_start")
            rest = self.napplysweeps - 2
            yc = run_sweeps(
                rest,
                lambda y: soa_unit_lower_sweep(st.ilu, offsets, lower, zc, y,
                                               bs),
                bdia_head_sweep_stencil(st.ilu, offsets, lower, zc))
            zout = stack_cols(run_sweeps(
                rest,
                lambda zz: soa_upper_solve_sweep(st.ilu, st.ilu_dinv, offsets,
                                                 upper, yc, zz, bs),
                bdia_head_sweep_stencil(st.ilu, offsets, upper, yc,
                                        st.ilu_dinv)))
        else:
            zero = torch.zeros_like(zc)
            yc = run_sweeps(
                self.napplysweeps,
                lambda y: soa_unit_lower_sweep(st.ilu, offsets, lower, zc, y,
                                               bs),
                zero)
            z0 = yc if self.apply_init == ApplyInit.JACOBI else zero
            zout = stack_cols(run_sweeps(
                self.napplysweeps,
                lambda zz: soa_upper_solve_sweep(st.ilu, st.ilu_dinv, offsets,
                                                 upper, yc, zz, bs),
                z0))
        return st.scale * zout if st.scale is not None else zout

    def apply_relax(self, b, x):
        raise NotImplementedError("ILU relaxation not implemented "
                                  "(matches reference)")
