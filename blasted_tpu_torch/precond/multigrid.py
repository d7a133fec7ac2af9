"""Algebraic multigrid preconditioner with blasted smoothers on every level.

Port of ``blasted_tpu/precond/multigrid.py`` (reference: the PCMG/PCGAMG
branch of setup_blasted_stack_ext, src/blasted_petsc.cpp:610-630, which
attaches a BLASTed operator to every level of a PETSc hierarchy).  Here the
hierarchy is in-framework: aggregation AMG whose level smoothers are
factory-built operators and whose coarsest level is a dense LU solve.

- **Contiguous aggregation** of ``group`` consecutive rows (or isotropic
  bricks of a structured grid): prolongation is a ``repeat`` and
  restriction a reshape and sum — no gathers.  Galerkin coarsening of a
  banded matrix stays banded, so every level takes DIA storage where the
  fine one does (``factory.to_device_matrix``, per level).
- **Host set-up**: the Galerkin triple products and the spectral bound are
  scipy, once, and cached; the numbers stay float64 on the host, as in JAX.
  Each level's device matrix, its D⁻¹ and the coarse matrix are cast to the
  fine matrix's dtype on the fine matrix's device (the JAX package's
  float64 prolongator would otherwise leave float32 vectors meeting float64
  levels).
- **Device cycle**: the V/W cycle is a recursion over the fixed levels;
  smoothing steps are Richardson steps x ← x + M⁻¹(b − A x) with any
  :class:`Preconditioner` as M ("factory"), damped Jacobi ("jacobi") or
  Chebyshev ("chebyshev").  The coarse solve is ``torch.linalg.lu_factor``
  and ``lu_solve``, the library call JAX also leaves it to.

The cycle is a fixed linear operator (fixed sweep counts, exact coarse
solve), so CG and BiCGSTAB work as outer methods.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..config import AsyncSolverSettings, PrecType
from ..ops.spmv import spmv
from ..sparse.csr import CSRMatrix, as_device
from ..utils.profiling import annotate
from .base import Preconditioner, PrecInfo, SolveParams

__all__ = ["AMGSettings", "MultigridPreconditioner", "build_hierarchy",
           "aggregation_prolongator", "brick_prolongator"]


@dataclass(frozen=True)
class AMGSettings:
    """Hierarchy and cycle options (the JAX package's, field for field).

    ``smoother`` settings go to the factory on every level (the reference
    walker configures one Blasted_data context per MG level,
    blasted_petsc.cpp:610-630).  ``grid_shape`` (interior points
    (nx, ny, nz), x fastest) selects brick aggregation by ``brick``;
    ``smoother_kind`` is "factory", "jacobi" (ω = jacobi_omega/ρ(D⁻¹A)) or
    "chebyshev" (cheby_degree SpMVs per step)."""

    group: int = 4
    grid_shape: tuple | None = None
    brick: tuple = (2, 2, 2)
    max_levels: int = 12
    coarse_size: int = 200
    cycle: str = "v"
    npre: int = 1
    npost: int = 1
    smooth_prolongator: bool = False
    omega_scale: float = 4.0 / 3.0
    smoother_kind: str = "factory"
    jacobi_omega: float = 1.4
    cheby_degree: int = 2
    smoother: AsyncSolverSettings = field(
        default_factory=lambda: AsyncSolverSettings(
            prec_type=PrecType.SGS, napplysweeps=2))


def aggregation_prolongator(n: int, group: int, A_sp=None,
                            smooth: bool = False,
                            omega_scale: float = 4.0 / 3.0):
    """Host prolongator of contiguous size-``group`` aggregates:
    ``(P, omega)``, ``omega`` 0.0 for the piecewise-constant tentative
    operator T, else the damped-Jacobi weight of P = (I − ω D⁻¹A) T with
    ω = omega_scale / ρ(D⁻¹A) (the Gershgorin bound, :func:`_rho_dinv_a`)."""
    import scipy.sparse as sps

    nc = -(-n // group)
    rows = np.arange(n, dtype=np.int64)
    T = sps.csr_matrix((np.ones(n), (rows, rows // group)), shape=(n, nc))
    if not smooth:
        return T, 0.0
    return _smooth_prolongator(T, A_sp, omega_scale)


def _rho_dinv_a(A_sp) -> float:
    """An upper bound on ρ(D⁻¹A): the Gershgorin row-sum bound
    max_i Σ_j |a_ij|/|a_ii| (2 exactly for M-matrix stencils).  Chebyshev
    smoothing amplifies modes above its interval, so it needs an upper
    bound, not a power-iteration estimate."""
    d = A_sp.diagonal()
    if np.any(d == 0):
        raise ValueError("Jacobi-scaled smoothing needs a zero-free diagonal")
    absrow = np.asarray(abs(A_sp).sum(axis=1)).ravel()
    return float(np.max(absrow / np.abs(d)))


def _smooth_prolongator(T, A_sp, omega_scale: float):
    """P = (I − ω D⁻¹ A) T with ω = omega_scale / ρ(D⁻¹A)."""
    import scipy.sparse as sps

    omega = omega_scale / _rho_dinv_a(A_sp)
    Dinv = sps.diags(1.0 / A_sp.diagonal())
    P = (T - omega * ((Dinv @ A_sp) @ T)).tocsr()
    return P, omega


def brick_prolongator(shape: tuple, brick: tuple):
    """Host tentative prolongator of ``brick`` aggregation on a structured
    grid in x-fastest order: ``(T, coarse_shape)``; every dimension must be
    divisible by its brick edge."""
    import scipy.sparse as sps

    nx, ny, nz = shape
    bx, by, bz = brick
    if nx % bx or ny % by or nz % bz:
        raise ValueError(f"grid {shape} not divisible by brick {brick}")
    cx, cy, cz = nx // bx, ny // by, nz // bz
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    rows = (i + nx * j + nx * ny * k).reshape(-1)
    cols = ((i // bx) + cx * (j // by) + cx * cy * (k // bz)).reshape(-1)
    n, ncoarse = nx * ny * nz, cx * cy * cz
    T = sps.csr_matrix((np.ones(n), (rows, cols)), shape=(n, ncoarse))
    return T, (cx, cy, cz)


class _Level(NamedTuple):
    """Static per-level data and the level's device operators."""

    n: int
    nc: int
    group: int
    A_dev: object                 # DiaMatrix or PaddedCSR
    AT_dev: object | None         # the smoothed restriction's transpose
    smoother: Preconditioner | None
    omega: float
    dinv: torch.Tensor
    shape: tuple | None = None    # brick mode: the fine (nx, ny, nz)
    brick: tuple | None = None    # and the brick edges
    rho: float = 0.0              # ρ(D⁻¹A) bound (jacobi/chebyshev kinds)


def _to_scipy_csr(mat):
    """A host CSR/BSR matrix (or scipy) as scalar scipy CSR: the hierarchy
    is scalar."""
    import scipy.sparse as sps

    if hasattr(mat, "to_scipy"):
        return sps.csr_matrix(mat.to_scipy())
    return sps.csr_matrix(mat)


def build_hierarchy(A0, settings: AMGSettings, *, device="cuda"):
    """The level list and the dense coarsest operator, built on the host
    once: ``(levels, A_coarse)``, every level's ``A_dev`` in the best
    device storage on ``device`` (DIA where banded) and in ``A0``'s
    dtype."""
    from ..factory import create_preconditioner, to_device_matrix

    device = as_device(device)
    A_sp = _to_scipy_csr(A0)
    dt = A_sp.dtype
    kind = settings.smoother_kind
    if kind not in ("factory", "jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother_kind {kind!r}")
    levels = []
    shape, brick = settings.grid_shape, settings.brick
    if shape is not None and int(np.prod(shape)) != A_sp.shape[0]:
        raise ValueError(f"grid_shape {shape} does not match "
                         f"nrows {A_sp.shape[0]}")
    while (A_sp.shape[0] > settings.coarse_size
           and len(levels) < settings.max_levels - 1):
        n = A_sp.shape[0]
        cur_shape = cur_brick = None
        if shape is not None and all(s % b == 0 for s, b in zip(shape, brick)):
            cur_shape, cur_brick = shape, brick
            T, coarse_shape = brick_prolongator(shape, brick)
            P, omega = (_smooth_prolongator(T, A_sp, settings.omega_scale)
                        if settings.smooth_prolongator else (T, 0.0))
            grp = int(np.prod(brick))
            shape = coarse_shape
        else:
            shape = None   # off the structured path: index blocks onward
            grp = settings.group
            P, omega = aggregation_prolongator(
                n, grp, A_sp, smooth=settings.smooth_prolongator,
                omega_scale=settings.omega_scale)
        Ac = (P.T @ A_sp @ P).tocsr()
        Ac.eliminate_zeros()
        Ac.sort_indices()

        A_dev = to_device_matrix(CSRMatrix.from_scipy(A_sp.astype(dt)),
                                 device=device)
        smoother = (create_preconditioner(A_dev, settings.smoother)
                    if kind == "factory" else None)
        rho = _rho_dinv_a(A_sp) if kind in ("jacobi", "chebyshev") else 0.0
        dinv = torch.from_numpy((1.0 / A_sp.diagonal()).astype(dt)).to(device)
        AT_dev = None
        if omega != 0.0:
            asym = abs(A_sp - A_sp.T)
            if asym.nnz and asym.max() > 1e-12 * abs(A_sp).max():
                AT_dev = to_device_matrix(
                    CSRMatrix.from_scipy(A_sp.T.tocsr().astype(dt)),
                    device=device)
        levels.append(_Level(n=n, nc=P.shape[1], group=grp, A_dev=A_dev,
                             AT_dev=AT_dev, smoother=smoother, omega=omega,
                             dinv=dinv, shape=cur_shape, brick=cur_brick,
                             rho=rho))
        A_sp = Ac

    A_coarse = torch.from_numpy(A_sp.toarray().astype(dt)).to(device)
    return levels, A_coarse


def _prolong(lev: _Level, xc: torch.Tensor) -> torch.Tensor:
    """P @ xc without gathers: a repeat (index blocks) or a 3-D broadcast
    (grid bricks), then the optional damped-Jacobi smoothing."""
    if lev.shape is not None:
        nx, ny, nz = lev.shape
        bx, by, bz = lev.brick
        cx, cy, cz = nx // bx, ny // by, nz // bz
        y = xc.reshape(cz, 1, cy, 1, cx, 1).expand(
            cz, bz, cy, by, cx, bx).reshape(-1)
    else:
        y = xc[:, None].expand(lev.nc, lev.group).reshape(-1)[:lev.n]
    if lev.omega != 0.0:
        y = y - lev.omega * lev.dinv * spmv(lev.A_dev, y)
    return y


def _restrict(lev: _Level, r: torch.Tensor) -> torch.Tensor:
    """Pᵀ @ r without gathers: the optional smoothing transpose, then a
    reshape and sum."""
    if lev.omega != 0.0:
        At = lev.AT_dev if lev.AT_dev is not None else lev.A_dev
        r = r - lev.omega * spmv(At, lev.dinv * r)
    if lev.shape is not None:
        nx, ny, nz = lev.shape
        bx, by, bz = lev.brick
        return r.reshape(nz // bz, bz, ny // by, by, nx // bx, bx) \
                .sum(dim=(1, 3, 5)).reshape(-1)
    pad = lev.nc * lev.group - lev.n
    if pad:
        r = torch.cat([r, r.new_zeros(pad)])
    return r.reshape(lev.nc, lev.group).sum(1)


class MultigridPreconditioner(Preconditioner):
    """AMG V/W cycle as a :class:`Preconditioner` — an MG stack with blasted
    smoothers on every level (reference: blasted_petsc.cpp:610-630).

    ``mat`` is the host container (CSR or BSR, flattened to scalar for the
    hierarchy); the levels live on ``device`` (the card unless asked).
    ``apply(r)`` is one cycle from zero, a fixed linear operator;
    ``apply_relax(b, x)`` runs ``solveparams.maxits`` cycles from x."""

    def __init__(self, mat, settings: AMGSettings | None = None, *,
                 device="cuda"):
        self.mat = mat
        self.state = None
        self.settings = settings or AMGSettings()
        if self.settings.cycle not in ("v", "w"):
            raise ValueError(f"unknown cycle type {self.settings.cycle!r}")
        self._device = as_device(device)
        self.levels: list[_Level] = []
        self._A_coarse = None
        self._coarse_lu = None
        self._values_version = 0
        self._built_version = -1
        self.solveparams = SolveParams()

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def block_size(self) -> int:
        return 1   # the cycle runs on flat vectors whatever the input blocks

    def update_values(self, vals) -> None:
        """New values for the fine host matrix (flat nnz array, tensor or
        numpy); the next :meth:`compute` rebuilds the Galerkin chain and the
        level operators.  Repeated compute() calls without an update keep
        the cached hierarchy."""
        with annotate("precond.update"):
            if isinstance(vals, torch.Tensor):
                vals = vals.cpu().numpy()
            self.mat = self.mat.with_vals(np.asarray(vals))
            self._values_version += 1

    def compute(self) -> PrecInfo:
        if not self.levels or self._built_version != self._values_version:
            self.levels, self._A_coarse = build_hierarchy(
                self.mat, self.settings, device=self._device)
            self._built_version = self._values_version
        info = PrecInfo()
        for li, lev in enumerate(self.levels):
            if lev.smoother is None:        # jacobi/chebyshev: dinv only
                continue
            lev_info = lev.smoother.compute()
            if li == 0:                     # the fine level's diagnostics
                info = lev_info
        self._coarse_lu = torch.linalg.lu_factor(self._A_coarse)
        return info

    # -- the cycle -----------------------------------------------------------

    def _smooth(self, lev: _Level, b, x, steps: int):
        s = self.settings
        if s.smoother_kind == "jacobi":
            om = s.jacobi_omega / lev.rho
            for _ in range(steps):
                x = x + om * lev.dinv * (b - spmv(lev.A_dev, x))
            return x
        if s.smoother_kind == "chebyshev":
            # Chebyshev on D⁻¹A over [ρ/4, ρ] (the standard interval)
            lmax = lev.rho * 1.05
            lmin = lmax / 4.0
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            for _ in range(steps):
                sigma = theta / delta
                rho_c = 1.0 / sigma
                d = lev.dinv * (b - spmv(lev.A_dev, x)) / theta
                x = x + d
                for _ in range(s.cheby_degree - 1):
                    rho_new = 1.0 / (2.0 * sigma - rho_c)
                    r = lev.dinv * (b - spmv(lev.A_dev, x))
                    d = rho_new * rho_c * d + (2.0 * rho_new / delta) * r
                    x = x + d
                    rho_c = rho_new
            return x
        for _ in range(steps):
            x = x + lev.smoother.apply_flat(b - spmv(lev.A_dev, x))
        return x

    def _cycle(self, li: int, b: torch.Tensor, x: torch.Tensor):
        if li == len(self.levels):
            LU, piv = self._coarse_lu
            return torch.linalg.lu_solve(LU, piv, b[:, None])[:, 0]
        lev = self.levels[li]
        s = self.settings
        x = self._smooth(lev, b, x, s.npre)
        rc = _restrict(lev, b - spmv(lev.A_dev, x))
        ec = b.new_zeros(lev.nc)
        ngamma = 1 if (s.cycle == "v" or li + 1 == len(self.levels)) else 2
        for _ in range(ngamma):
            ec = self._cycle(li + 1, rc, ec)
        x = x + _prolong(lev, ec)
        return self._smooth(lev, b, x, s.npost)

    # -- the reference triad -------------------------------------------------

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r, torch.zeros_like(r))

    def apply_flat(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply(r)

    def apply_relax(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        from .jacobi import relax_loop
        return relax_loop(lambda bb, xx: self._cycle(0, bb, xx),
                          b, x, self.solveparams)
