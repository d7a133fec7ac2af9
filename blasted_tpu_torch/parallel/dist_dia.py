"""Distributed banded solvers: DIA and block-DIA matrices over the mesh.

Port of ``blasted_tpu/parallel/dist_dia.py``.  A banded matrix needs only
a neighbour halo: with halo width H = max|offset| ≤ rows per shard, each
shard receives H boundary entries from each ring neighbour (PETSc's
VecScatter halo update, SURVEY.md §2.5 P8).  The SpMV sends the halo
strips first, then runs the interior pass — a shard-local product that
reads zero beyond the shard, which is exactly kernel K1 (scalar) or K5
(block) on the shard's contiguous slice — and then corrects the |o|
boundary rows of each diagonal from the halos.

The preconditioner follows the block-Jacobi contract: a shard's diagonal
block is the same band with the entries that cross the shard boundary
masked out, so set-up and apply run per shard with no communication.

- Scalar apply: the ILU(0) sweeps and the SGS lower sweep are K2's
  function, ``(rhs − Σ c·y[i+o])·(dinv | 1)`` with zero reads beyond the
  shard; the GS and SGS upper forms are not K2's shape and stay torch
  operations, as they are XLA work in JAX.
- Scalar factor: plain ``dia_factor_sweep`` sweeps, as JAX runs on every
  backend here — never the compressed K3/K4 route, whose K sweeps equal 2K
  plain ones (ROADMAP.md C1).  Each sweep is kernel K8 over a pair table
  built once per shard, at its first factor.
- Block factor: compressed (K6, one launch per sweep) exactly when the
  band is ``factor_stencil_eligible`` and every diagonal block is stored —
  the port's device-independent rule, where JAX goes compressed only on a
  TPU; otherwise the plain block sweeps.  Inverse diagonal blocks come
  from the block-inverse kernel.
- Block apply: the ILU(0) sweeps are kernel K7 (``ops/bdia.py``'s sweep
  functions, shared with the single-device apply); the Jacobi, GS and SGS
  forms are torch operations.

Only ``none``, ``jacobi``, ``gs``, ``sgs`` and ``ilu0`` are banded types
here.  JAX runs fixed-point ILU(0) sweeps for every other ``prec_type``
(ROADMAP.md §3, R3); the port raises ``TypeError`` instead, and
``api.solve`` then takes the general route, which builds the requested
preconditioner on each shard.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ApplyInit, AsyncSolverSettings, FactInit, PrecType
from ..ops.bdia import (
    cols_of,
    soa_dinv_mul,
    soa_mv_streams,
    soa_unit_lower_sweep,
    soa_upper_solve_sweep,
    stack_cols,
)
from ..ops.blas1 import guard_zero
from ..ops.bstencil import bdia_block_inverse, bdia_spmv_stencil
from ..ops.stencil import (
    MAX_DIAGS,
    PlainSweepPlan,
    dia_spmv_stencil,
    factor_stencil_eligible,
    tri_sweep_stencil,
)
from ..precond.base import PrecInfo
from ..precond.bdia_ilu0 import (
    bdia_factor_sweeps_compressed,
    bdia_factor_sweeps_soa,
    bdia_ilu_remainder,
)
from ..precond.dia_ilu0 import dia_factor_sweep, dia_ilu_remainder, dia_pairs
from ..precond.diagnostics import bdia_block_diagonal_dominance
from ..sparse.bdia import BlockDiaMatrix, bdia_from_bsr, bdia_pad_identity
from ..sparse.bsr import BSRMatrix
from ..sparse.csr import CSRMatrix
from ..sparse.dia import DiaMatrix, dia_from_csr, dia_pad_identity, shift_read
from .dist import krylov_solve, reduce_precinfo
from .mesh import Mesh, ShardedVector

__all__ = ["DistDiaSolver", "DistBlockDiaSolver", "dist_dia_spmv",
           "BANDED_TYPES"]

#: The preconditioner types the banded distributed solvers compute.
BANDED_TYPES = (PrecType.NONE, PrecType.JACOBI, PrecType.GS, PrecType.SGS,
                PrecType.ILU0)


def _check_type(settings: AsyncSolverSettings, who: str) -> None:
    if settings.prec_type not in BANDED_TYPES:
        raise TypeError(
            f"{who} computes {', '.join(t.value for t in BANDED_TYPES)}, "
            f"not {settings.prec_type.value} (ROADMAP.md §3 R3: the JAX "
            "package runs ILU(0) sweeps in its place); use the general "
            "DistributedSolver")


def _check_ndiags(rowptr, colind, nunits: int) -> None:
    """Raise before building a banded form with more diagonals than the
    kernels take (the band's width is checked on the banded form)."""
    rows = np.repeat(np.arange(nunits), np.diff(rowptr))
    ndiags = len(np.unique(np.asarray(colind, np.int64) - rows))
    if ndiags > MAX_DIAGS:
        raise ValueError(f"{ndiags} diagonals exceed the kernels' "
                         f"{MAX_DIAGS}; use the general path")


def _ring_halo(parts, H: int, devices):
    """Each shard's left halo (the last H rows of shard s − 1) and right
    halo (the first H rows of shard s + 1), on its own device; None at the
    non-periodic ends."""
    P = len(parts)
    if H == 0:
        return [None] * P, [None] * P
    left = [None] + [parts[s - 1][-H:].to(devices[s]) for s in range(1, P)]
    right = [parts[s + 1][:H].to(devices[s]) for s in range(P - 1)] + [None]
    return left, right


def _local_masks(mask: torch.Tensor, offsets, nl: int) -> torch.Tensor:
    """The (k, nl) local-block mask: entries crossing the shard boundary
    drop out."""
    r = torch.arange(nl, device=mask.device)
    return torch.stack([mask[d] & (r + o >= 0) & (r + o < nl)
                        for d, o in enumerate(offsets)])


def _shard_cols(t: torch.Tensor, mesh: Mesh, nl: int) -> tuple:
    """Equal slices of the last (row) axis, each on its shard's device."""
    return tuple(t[..., s * nl:(s + 1) * nl].to(dev, copy=True).contiguous()
                 for s, dev in enumerate(mesh.devices))


def _shard_info(rem, dominance) -> PrecInfo:
    """One shard's PrecInfo from its remainder and its dominance tuple
    (L avg, L min, U avg, U min); ``reduce_precinfo`` sums, averages (the
    shards are equal, so the mean of their means is JAX's psum over all
    rows, ``dist_dia.py:155-196``) and takes minima."""
    return PrecInfo(0.0, *(float(v) for v in (rem, *dominance)))


def dist_dia_spmv(mesh: Mesh, offsets, data, x: ShardedVector,
                  halo: int) -> ShardedVector:
    """y = A x with per-shard DIA data (k, nl) and a row-sharded x: the
    halo strips first, the interior pass through K1, then the boundary
    corrections."""
    left, right = _ring_halo(x.parts, halo, mesh.devices)
    out = []
    for s, xl in enumerate(x.parts):
        dl, nl = data[s], xl.shape[0]
        acc = dia_spmv_stencil(offsets, dl, xl)
        for d, o in enumerate(offsets):
            if o < 0 and left[s] is not None:
                acc[:-o] += dl[d, :-o] * left[s][halo + o:]
            elif o > 0 and right[s] is not None:
                acc[nl - o:] += dl[d, nl - o:] * right[s][:o]
        out.append(acc)
    return ShardedVector(out)


def _tri_mv(vl, offsets, sel, y):
    """Σ_{d∈sel} vl[d]·y[·+o_d], summed from zero in order (JAX's
    ``tri_mv``)."""
    acc = torch.zeros_like(y)
    for d in sel:
        acc = acc + vl[d] * shift_read(y, offsets[d])
    return acc


class DistDiaSolver:
    """Banded distributed solve: halo SpMV and shard-local DIA
    preconditioner."""

    METHODS = ("bicgstab", "cg", "gcr", "gmres", "richardson")

    def __init__(self, A, mesh: Mesh,
                 settings: AsyncSolverSettings | None = None):
        self.settings = settings or AsyncSolverSettings(
            prec_type=PrecType.JACOBI)
        _check_type(self.settings, "DistDiaSolver")
        if isinstance(A, CSRMatrix):
            _check_ndiags(A.rowptr, A.colind, A.nrows)
            A = dia_from_csr(A, device="cpu")
        if not isinstance(A, DiaMatrix):
            raise TypeError("DistDiaSolver needs a banded (DIA) matrix")
        self.mesh = mesh
        self.offsets = A.offsets
        self.halo = max((abs(o) for o in A.offsets), default=0)
        nd = mesh.size
        self.n_orig = A.nrows
        if A.nrows % nd:          # uneven partition: identity-pad
            A = dia_pad_identity(A, -(-A.nrows // nd) * nd)
        self.nl = A.nrows // nd
        if self.halo > self.nl:
            raise ValueError("band wider than a shard; use the general path")
        self.dtype = A.dtype
        self.data = _shard_cols(A.data, mesh, self.nl)
        self.mask = _shard_cols(A.mask, mesh, self.nl)
        self._plans = {}     # K8's structure per shard, built at its first ILU
        self._compute()

    # -- preconditioner set-up (per shard, no communication) -----------------

    def _compute(self):
        s = self.settings
        t = s.prec_type
        self._state = self._info = None
        if t == PrecType.NONE:
            return
        offsets, nl = self.offsets, self.nl
        d0 = offsets.index(0)
        pairs = dia_pairs(offsets)
        nsweeps = max(s.nbuildsweeps, 1)
        states, infos = [], []
        for shard, (dl, ml) in enumerate(zip(self.data, self.mask)):
            mask_l = _local_masks(ml, offsets, nl)
            base = torch.where(mask_l, dl, 0.0)
            if t in (PrecType.JACOBI, PrecType.GS, PrecType.SGS):
                states.append((base, 1.0 / base[d0]))
                continue
            ilu = base
            if s.fact_init == FactInit.SGS:
                den = guard_zero(base[d0])
                ilu = torch.stack([
                    torch.where(mask_l[d], base[d]
                                / guard_zero(shift_read(den, o)), 0.0)
                    if o < 0 else base[d] for d, o in enumerate(offsets)])
            if shard not in self._plans:
                self._plans[shard] = PlainSweepPlan(
                    offsets, pairs, d0, mask_l, prune=False,
                    device=base.device)
            for _ in range(nsweeps):
                ilu = dia_factor_sweep(self._plans[shard], base, ilu)
            states.append((ilu, 1.0 / guard_zero(ilu[d0])))
            if s.compute_precinfo:
                infos.append(self._info_parts(pairs, d0, mask_l, base, ilu))
        self._state = states
        if infos:
            self._info = reduce_precinfo(infos)

    def _info_parts(self, pairs, d0, mask_l, base, ilu):
        """One shard's ILU remainder and L/U diagonal dominance.  A zero
        pivot divides by 1, as in JAX's distributed set-up (its
        single-device ``diagonal_dominance`` does not guard)."""
        zero = torch.zeros_like(ilu[d0])
        ldd = 1.0 - sum((ilu[d].abs() for d, o in enumerate(self.offsets)
                         if o < 0), zero)
        usum = sum((ilu[d].abs() for d, o in enumerate(self.offsets)
                    if o > 0), zero)
        udd = 1.0 - usum / torch.where(ilu[d0] == 0, 1.0, ilu[d0].abs())
        return _shard_info(
            dia_ilu_remainder(self.offsets, pairs, mask_l, base, ilu),
            (ldd.mean(), ldd.min(), udd.mean(), udd.min()))

    def precinfo(self) -> PrecInfo | None:
        """The reduced per-shard PrecInfo (None unless compute_precinfo)."""
        return self._info

    # -- operators -----------------------------------------------------------

    def amat(self, x: ShardedVector) -> ShardedVector:
        return dist_dia_spmv(self.mesh, self.offsets, self.data, x,
                             self.halo)

    def prec_apply(self, r: ShardedVector) -> ShardedVector:
        if self._state is None:
            return r
        return ShardedVector(self._apply_local(vl, di, rl)
                             for (vl, di), rl in zip(self._state, r.parts))

    def _apply_local(self, vl, di, rl):
        """One shard's apply: shifts read zero beyond the shard."""
        s = self.settings
        t = s.prec_type
        offsets = self.offsets
        d0 = offsets.index(0)
        ns = max(s.napplysweeps, 1)
        if t == PrecType.JACOBI:
            return di * rl
        lower = list(range(d0))
        upper = list(range(d0 + 1, len(offsets)))
        if t == PrecType.GS:
            x = torch.zeros_like(rl)
            for _ in range(ns):
                x = di * (rl - _tri_mv(vl, offsets, lower, x)
                          - _tri_mv(vl, offsets, upper, x))
            return x
        low_offs, up_offs = offsets[:d0], offsets[d0 + 1:]
        y = torch.zeros_like(rl)
        if t == PrecType.SGS:
            for _ in range(ns):
                y = tri_sweep_stencil(low_offs, vl[:d0], rl, y, di)
            z = torch.zeros_like(rl)
            for _ in range(ns):
                z = y - di * _tri_mv(vl, offsets, upper, z)
            return z
        # ILU(0): unit-lower then upper sweeps with the factored band
        for _ in range(ns):
            y = tri_sweep_stencil(low_offs, vl[:d0], rl, y)
        z = y if s.apply_init == ApplyInit.JACOBI else torch.zeros_like(rl)
        for _ in range(ns):
            z = tri_sweep_stencil(up_offs, vl[d0 + 1:], y, z, di)
        return z

    def solve(self, b, x0=None, method: str = "bicgstab", tol: float = 1e-8,
              maxiter: int = 500, **kw):
        return krylov_solve(self.mesh, self.amat, self.prec_apply, b, x0,
                            self.nl * self.mesh.size, self.n_orig,
                            self.dtype, method, self.METHODS, tol, maxiter,
                            **kw)


class DistBlockDiaSolver:
    """Block-banded distributed solve: halo exchange of block segments and
    shard-local block ILU(0), Jacobi, GS or SGS."""

    METHODS = DistDiaSolver.METHODS

    def __init__(self, B, mesh: Mesh,
                 settings: AsyncSolverSettings | None = None):
        self.settings = settings or AsyncSolverSettings(
            prec_type=PrecType.JACOBI)
        _check_type(self.settings, "DistBlockDiaSolver")
        if isinstance(B, BSRMatrix):
            _check_ndiags(B.rowptr, B.colind, B.nbrows)
            B = bdia_from_bsr(B, device="cpu")
        if not isinstance(B, BlockDiaMatrix):
            raise TypeError("DistBlockDiaSolver needs a block-banded matrix")
        self.mesh = mesh
        self.offsets = B.offsets
        self.bs = B.bs
        self.halo = max((abs(o) for o in B.offsets), default=0)
        nd = mesh.size
        self.nb_orig = B.nbrows
        if B.nbrows % nd:         # uneven partition: identity-pad
            B = bdia_pad_identity(B, -(-B.nbrows // nd) * nd)
        self.nl = B.nbrows // nd
        if self.halo > self.nl:
            raise ValueError("band wider than a shard; use the general path")
        self.dtype = B.dtype
        # resolved on the host: the route must not depend on a shard
        self._diag_mask_full = B.resolved_diag_mask_full()
        self.data = _shard_cols(B.data, mesh, self.nl)
        self.mask = _shard_cols(B.mask, mesh, self.nl)
        self._compute()

    def _compute(self):
        s = self.settings
        t = s.prec_type
        self._state = self._info = None
        if t == PrecType.NONE:
            return
        offsets, nl, bs = self.offsets, self.nl, self.bs
        d0 = offsets.index(0)
        pairs = dia_pairs(offsets)
        nsweeps = max(s.nbuildsweeps, 1)
        # the local d0 mask is the global one (offset 0 never crosses a
        # shard boundary), so the host flag holds on every shard
        self.compressed = (factor_stencil_eligible(offsets, pairs)
                           and self._diag_mask_full)
        states, infos = [], []
        for dl, ml in zip(self.data, self.mask):
            mask_l = _local_masks(ml, offsets, nl)
            base = torch.where(mask_l[:, None, :], dl, 0.0)
            if t in (PrecType.JACOBI, PrecType.GS, PrecType.SGS):
                states.append((base, bdia_block_inverse(base[d0],
                                                        mask_l[d0])))
                continue
            if self.compressed:
                ilu = bdia_factor_sweeps_compressed(
                    offsets, pairs, d0, mask_l, base, base, nsweeps,
                    diag_mask_full=True)
            else:
                ilu = bdia_factor_sweeps_soa(offsets, pairs, d0, mask_l,
                                             base, base, nsweeps)
            states.append((ilu, bdia_block_inverse(ilu[d0], mask_l[d0])))
            if s.compute_precinfo:
                infos.append(self._info_parts(pairs, d0, mask_l, base, ilu))
        self._state = states
        if infos:
            self._info = reduce_precinfo(infos)

    def _info_parts(self, pairs, d0, mask_l, base, ilu):
        """One shard's block ILU remainder and scalar-row dominance."""
        local = BlockDiaMatrix(base, mask_l, self.offsets)
        return _shard_info(
            bdia_ilu_remainder(self.offsets, pairs, mask_l, base, ilu),
            bdia_block_diagonal_dominance(local, ilu))

    def precinfo(self) -> PrecInfo | None:
        """The reduced per-shard PrecInfo (None unless compute_precinfo)."""
        return self._info

    def amat(self, x: ShardedVector) -> ShardedVector:
        """y = A x on flat row-sharded vectors: the block-segment halos
        first, the interior pass through K5, then the |o| boundary block
        rows of each diagonal from the halos."""
        offsets, H, bs = self.offsets, self.halo, self.bs
        parts = [p.view(-1, bs) for p in x.parts]
        left, right = _ring_halo(parts, H, self.mesh.devices)
        out = []
        for s, xl in enumerate(parts):
            dl, nl = self.data[s], xl.shape[0]
            acc = bdia_spmv_stencil(offsets, dl, xl)
            for d, o in enumerate(offsets):
                if o < 0 and left[s] is not None:
                    rows, halo = slice(0, -o), left[s][H + o:]
                elif o > 0 and right[s] is not None:
                    rows, halo = slice(nl - o, nl), right[s][:o]
                else:
                    continue
                blk = dl[d].view(bs, bs, nl)[:, :, rows]
                corr = blk[:, 0] * halo[:, 0]
                for j in range(1, bs):
                    corr = corr + blk[:, j] * halo[:, j]
                acc[rows] += corr.t()
            out.append(acc.reshape(-1))
        return ShardedVector(out)

    def prec_apply(self, r: ShardedVector) -> ShardedVector:
        if self._state is None:
            return r
        return ShardedVector(self._apply_local(vl, di, rl)
                             for (vl, di), rl in zip(self._state, r.parts))

    def _apply_local(self, vl, di, rl):
        """One shard's apply on (bs, nl) column streams: the ILU(0) sweeps
        are K7 (``ops/bdia.py``), the Jacobi, GS and SGS forms torch
        operations, as in JAX."""
        s = self.settings
        t = s.prec_type
        offsets, bs = self.offsets, self.bs
        ns = max(s.napplysweeps, 1)
        lower = [d for d, o in enumerate(offsets) if o < 0]
        upper = [d for d, o in enumerate(offsets) if o > 0]
        rc = cols_of(rl.view(-1, bs))
        zero = torch.zeros_like(rc)

        def dmul(seg):
            return soa_dinv_mul(di, seg, bs)

        def tri_mv(sel, y):
            return soa_mv_streams(vl, offsets, sel, y, bs)

        if t == PrecType.JACOBI:
            out = dmul(rc)
        elif t == PrecType.GS:
            out = zero
            for _ in range(ns):
                out = dmul(rc - tri_mv(lower, out) - tri_mv(upper, out))
        elif t == PrecType.SGS:
            y = zero
            for _ in range(ns):
                y = dmul(rc - tri_mv(lower, y))
            out = zero
            for _ in range(ns):
                out = y - dmul(tri_mv(upper, out))
        else:
            y = zero
            for _ in range(ns):
                y = soa_unit_lower_sweep(vl, offsets, lower, rc, y, bs)
            out = y if s.apply_init == ApplyInit.JACOBI else zero
            for _ in range(ns):
                out = soa_upper_solve_sweep(vl, di, offsets, upper, y, out,
                                            bs)
        return stack_cols(out).reshape(-1)

    def solve(self, b, x0=None, method: str = "bicgstab", tol: float = 1e-8,
              maxiter: int = 500, **kw):
        n = self.nl * self.bs * self.mesh.size
        return krylov_solve(self.mesh, self.amat, self.prec_apply, b, x0, n,
                            self.nb_orig * self.bs, self.dtype, method,
                            self.METHODS, tol, maxiter, **kw)
