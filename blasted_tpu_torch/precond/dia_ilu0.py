"""Fixed-point ILU(0) on DIA storage — gather-free.

Port of ``blasted_tpu/precond/dia_ilu0.py``: the Chow–Patel fixed point
(reference: kernels_ilu0_factorize.hpp) specialised to banded matrices.
The symbolic pair lists collapse to a static list of diagonal pairs per
target diagonal,

    pairs(o) = {(o1, o2) : o1 < 0, o2 = o − o1 > 0, both stored},

and one factorization sweep is, per diagonal o,

    ilu_o[i] ← â_o[i] − Σ_{(o1,o2)} ilu_o1[i] · ilu_o2[i+o1]
    ilu_o[i] ← ilu_o[i] / guard(ilu_0[i+o])     (lower diagonals, o<0)
    ilu_o[i] ← 0 outside the structural mask

The factor takes one of two routes, chosen by
:func:`~blasted_tpu_torch.ops.stencil.factor_takes_compressed_route` from
the problem and the options only: the compressed sweeps (kernels K3 + K4)
or the plain per-sweep chain (kernel K8, one launch per sweep, over a pair
table built once per preconditioner).  The apply sweeps are kernel K2
when the stored factor has the vector's dtype; with ``apply_dtype`` (the
factors stored in bfloat16, say) they are the plain shifted products, as in
JAX (``ops/sweeps.py``).  An apply from zero (``ApplyInit.ZERO``) with at
least two sweeps and the factor in the vector's dtype starts each chain
with kernel K12, the zero-start sweep, which computes K2's first two
sweeps from zero in one launch: the first of them yields the right-hand
side (lower) or the right-hand side times the inverse diagonal (upper),
so the chain runs one K12 and ``napplysweeps − 2`` K2 launches a
triangle, no fill, and equals the K2 chain from zero bit for bit on
finite factors (the sign of a zero aside).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SEQUENTIAL, ApplyInit, FactInit
from ..ops.blas1 import guard_zero
from ..ops.stencil import (
    PlainSweepPlan,
    dia_factor_sweeps_stencil,
    factor_takes_compressed_route,
    plain_factor_sweep_ref,
    plain_factor_sweep_stencil,
    zero_start_sweep_stencil,
)
from ..ops.sweeps import run_sweeps, unit_lower_sweep, upper_solve_sweep
from ..sparse.dia import DiaMatrix, shift_read
from ..utils import profiling
from .base import Preconditioner, PrecInfo
from .diagnostics import diagonal_dominance, prec_info
from .levels import (
    compute_levels_lower,
    compute_levels_upper,
    exact_lower_solve,
    exact_upper_solve,
)

__all__ = ["DiaILU0Preconditioner", "dia_pairs", "dia_factor_sweep",
           "dia_ilu_remainder"]


def dia_pairs(offsets):
    """Static diagonal-pair lists per target diagonal:
    pairs(o) = {(d_lower, d_upper, o1) : o1<0, o2=o−o1>0, both stored}."""
    oset = {o: d for d, o in enumerate(offsets)}
    return [
        [(oset[o1], oset[o - o1], o1)
         for o1 in offsets if o1 < 0 and (o - o1) in oset and (o - o1) > 0]
        for o in offsets
    ]


def dia_ilu_remainder(offsets, pairs, mask, base, ilu) -> torch.Tensor:
    """ILU fixed-point remainder Σ|â − Σ l·u − (l·u_cc | u)| on DIA
    storage (reference: scalar_ilu0_nonlinear_res,
    async_ilu_factor.cpp:179-217), per diagonal with shifted reads."""
    udiag = ilu[offsets.index(0)]
    total = base.new_zeros(())
    for d, o in enumerate(offsets):
        s = base[d]
        for (dl, du, o1) in pairs[d]:
            s = s - ilu[dl] * shift_read(ilu[du], o1)
        if o < 0:
            s = s - ilu[d] * shift_read(udiag, o)
        else:
            s = s - ilu[d]
        total = total + torch.where(mask[d], s, 0.0).abs().sum()
    return total


def dia_factor_sweep(plan: PlainSweepPlan, base, ilu) -> torch.Tensor:
    """One Chow–Patel fixed-point sweep on (k, n) DIA operands with the
    structure of ``plan``, built once by the caller: kernel K8.  The plan
    holds either form of the JAX package's sweep: ``dia_factor_sweep``
    (``prune=False`` and a (k, n) mask: every row re-masked) or
    ``dia_factor_sweep_tuple`` (``prune=True`` and one mask row or ``None``
    per diagonal: upper diagonals with no fill pairs are fixed points and
    pass through, and a ``None`` row is not re-masked).

    The twin runs instead of K8 where ``ilu`` is stored in another dtype
    than ``base`` (a FactInit.NONE warm start from a factor kept in
    ``apply_dtype``): fixed by the dtypes, as the applies' rule."""
    if ilu.dtype != base.dtype:
        return plain_factor_sweep_ref(plan, base, ilu)
    return plain_factor_sweep_stencil(plan, base, ilu)


class _DiaILUState(NamedTuple):
    ilu: torch.Tensor            # (k, n) factor values
    ilu_dinv: torch.Tensor       # (n,) 1/u_ii
    scale: torch.Tensor | None   # (n,) symmetric scaling, or None


class DiaILU0Preconditioner(Preconditioner):
    """Scalar fixed-point ILU(0) on DIA storage (banded fast path)."""

    def __init__(self, mat: DiaMatrix, nbuildsweeps: int = 1,
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
        # mixed-precision apply: factor in the matrix dtype, store the
        # triangular factors narrower (e.g. torch.bfloat16); the inverse
        # diagonal, the operator and the vectors keep the matrix dtype
        self.apply_dtype = apply_dtype
        offs = mat.offsets
        self._d0 = offs.index(0)
        self._pairs = dia_pairs(offs)
        # static structure, read from the device once
        self._mask_full = [bool(m) for m in mat.mask.all(dim=1).tolist()]
        self._levels = None
        self._plan = None        # K8's pair table, built at the first sweep

    # -- helpers ------------------------------------------------------------

    def _build_levels(self):
        """Wavefront levels, built on first use by a SEQUENTIAL phase only."""
        if self._levels is None:
            sp = self.mat.to_scipy()
            low = compute_levels_lower(sp.indptr, sp.indices)
            up = compute_levels_upper(sp.indptr, sp.indices)
            nlow_inner = sum(1 for o in self.mat.offsets if o < 0) + 1
            dev = self.mat.device
            self._levels = (torch.from_numpy(low).to(dev), int(low.max()) + 1,
                            torch.from_numpy(up).to(dev), int(up.max()) + 1,
                            nlow_inner)
        return self._levels

    def _scaled_base(self, scale):
        A = self.mat
        if scale is None:
            return A.data
        return torch.stack([A.data[d] * scale * shift_read(scale, o)
                            for d, o in enumerate(A.offsets)])

    def _fact_initial(self, base):
        A = self.mat
        if self.fact_init == FactInit.SGS:
            d0v = base[self._d0]
            rows = []
            for d, o in enumerate(A.offsets):
                if o < 0:
                    den = guard_zero(shift_read(d0v, o))
                    rows.append(torch.where(A.mask[d], base[d] / den, 0.0))
                else:
                    rows.append(base[d])
            return torch.stack(rows)
        return base

    # -- compute / apply ----------------------------------------------------

    def compute(self) -> PrecInfo:
        A = self.mat
        offsets, pairs, d0 = A.offsets, self._pairs, self._d0
        scale = 1.0 / torch.sqrt(A.diag_vals) if self.use_scaling else None
        base = self._scaled_base(scale)

        if self.state is not None and self.fact_init == FactInit.NONE:
            ilu = self.state.ilu
        else:
            ilu = self._fact_initial(base)

        mask_t = tuple(None if (o < 0 or self._mask_full[d]) else A.mask[d]
                       for d, o in enumerate(offsets))

        def sweep_t(v):
            if self._plan is None:
                self._plan = PlainSweepPlan(offsets, pairs, d0, mask_t,
                                            prune=True, device=A.device)
            return dia_factor_sweep(self._plan, base, v)

        info0 = self._nonlinear_res(base, ilu) if self.compute_precinfo \
            else None
        if factor_takes_compressed_route(offsets, pairs, self._mask_full[d0],
                                         self.nbuildsweeps, self.fact_init,
                                         A.nrows, A.data.element_size()):
            ilu = dia_factor_sweeps_stencil(offsets, pairs, d0, base, ilu,
                                            self.nbuildsweeps)
        elif self.nbuildsweeps == SEQUENTIAL:
            # factorization wavefronts == lower-solve wavefronts
            low, nlow, _, _, fact_inner = self._build_levels()
            for it in range(nlow * fact_inner):
                ilu = torch.where(low == it // fact_inner, sweep_t(ilu), ilu)
        else:
            ilu = run_sweeps(self.nbuildsweeps, sweep_t, ilu)

        # the inverse diagonal comes from the unrounded factor, as in JAX
        self.state = _DiaILUState(
            ilu=ilu if self.apply_dtype is None else ilu.to(self.apply_dtype),
            ilu_dinv=1.0 / ilu[d0], scale=scale)
        if self.compute_precinfo:
            return prec_info(info0, self._nonlinear_res(base, ilu),
                             diagonal_dominance(A, ilu))
        return PrecInfo()

    def _nonlinear_res(self, base, ilu) -> torch.Tensor:
        A = self.mat
        return dia_ilu_remainder(A.offsets, self._pairs, A.mask, base, ilu)

    def load_state_numpy(self, ilu, dinv, scale=None) -> None:
        """Install factors given as numpy arrays — e.g. the fields
        ``ilu`` (tuple of (n,) streams), ``ilu_dinv`` and ``scale`` of a
        ``blasted_tpu`` DIA-ILU(0) state — on this operator's device."""
        dev = self.mat.device
        ilu = np.stack([np.asarray(v) for v in ilu])
        self.state = _DiaILUState(
            ilu=torch.from_numpy(ilu).to(dev),
            ilu_dinv=torch.tensor(np.asarray(dinv), device=dev),
            scale=None if scale is None
            else torch.tensor(np.asarray(scale), device=dev))

    def apply_with(self, mat, state, r: torch.Tensor) -> torch.Tensor:
        st = state
        A = mat
        z = st.scale * r if st.scale is not None else r
        profiling.count("precond.ilu_apply")
        if self.napplysweeps == SEQUENTIAL:
            low, nlow, up, nup, _ = self._build_levels()
            y = exact_lower_solve(A, st.ilu, z, low, nlow)
            zout = exact_upper_solve(A, st.ilu, st.ilu_dinv, y, up, nup)
        elif (self.apply_init == ApplyInit.ZERO and self.napplysweeps >= 2
              and st.ilu.dtype == z.dtype):
            # K12 heads each chain; the dtypes are K2's route (ops/sweeps.py)
            profiling.count("precond.zero_start")
            d0, rest = A.d0, self.napplysweeps - 2
            y = run_sweeps(rest,
                           lambda yy: unit_lower_sweep(A, st.ilu, z, yy),
                           zero_start_sweep_stencil(A.offsets[:d0],
                                                    st.ilu[:d0], z))
            zout = run_sweeps(
                rest,
                lambda zz: upper_solve_sweep(A, st.ilu, st.ilu_dinv, y, zz),
                zero_start_sweep_stencil(A.offsets[d0 + 1:],
                                         st.ilu[d0 + 1:], y, st.ilu_dinv))
        else:
            y = run_sweeps(self.napplysweeps,
                           lambda yy: unit_lower_sweep(A, st.ilu, z, yy),
                           torch.zeros_like(z))
            z0 = y if self.apply_init == ApplyInit.JACOBI \
                else torch.zeros_like(z)
            zout = run_sweeps(
                self.napplysweeps,
                lambda zz: upper_solve_sweep(A, st.ilu, st.ilu_dinv, y, zz),
                z0)
        return st.scale * zout if st.scale is not None else zout

    def apply_relax(self, b, x):
        raise NotImplementedError("ILU relaxation not implemented "
                                  "(matches reference)")
