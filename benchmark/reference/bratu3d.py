"""Plain reference for PETSc SNES ex14, the 3D Bratu problem.

ex14 (``src/snes/tutorials/ex14.c``) solves -Δu - λ·e^u = 0 on the unit
cube with u = 0 on the boundary, on an Mx × My × Mz DMDA with a 7-point
star stencil and one dof per point.  Its ``FormFunction`` and
``FormJacobian`` write, with hx = 1/(Mx-1) (hy, hz alike), cx = hy·hz/hx,
cy = hx·hz/hy, cz = hx·hy/hz and sc = λ·hx·hy·hz:

- at a boundary point: F = u, and the Jacobian row is the diagonal 1;
- at an interior point: F = cx(2u - u_w - u_e) + cy(2u - u_s - u_n)
  + cz(2u - u_d - u_u) - sc·e^u, and the Jacobian row is -cx, -cy, -cz
  off the diagonal and 2(cx + cy + cz) - sc·e^u on it.

This module rebuilds each linear system J(u_J) x = -F(u_b) from those
formulas on a (Mz, My, Mx) grid, z slowest, for the iterates u_J, u_b the
benchmark hands it (ex14's ``FormInitialGuess`` and the Newton iterates
that follow it).  It judges a solution by its relative residual and a
factor by its gap to the Chow–Patel sweeps computed here, and it can
itself solve (ILU(0) sweeps and right-preconditioned BiCGSTAB) in any
dtype, which makes the lower-precision control.  It is plain PyTorch on
whatever device it is given and imports nothing of the program under
test.
"""

from __future__ import annotations

import torch

__all__ = ["System", "initial_guess", "residual", "factor_sweeps",
           "ilu_apply", "bicgstab", "relres", "factor_gap", "DIRECTIONS"]

#: The stencil's directions in the order of sorted column offsets (z
#: slowest): the three lower neighbours, the centre, the three upper ones.
DIRECTIONS = ("z-", "y-", "x-", "c", "x+", "y+", "z+")
# the grid axis of each direction in a (Mz, My, Mx) tensor
_AXIS = {"x": 2, "y": 1, "z": 0}


def spacing(grid) -> tuple:
    mx, my, mz = grid
    return 1.0 / (mx - 1), 1.0 / (my - 1), 1.0 / (mz - 1)


def _shape(grid) -> tuple:
    mx, my, mz = grid
    return (mz, my, mx)


def _interior(grid, device) -> torch.Tensor:
    mask = torch.zeros(_shape(grid), dtype=torch.bool, device=device)
    mask[1:-1, 1:-1, 1:-1] = True
    return mask


def initial_guess(grid, lam: float, device) -> torch.Tensor:
    """ex14's ``FormInitialGuess`` in float64: λ/(λ+1)·sqrt of the least
    distance to a face, measured in grid steps times the spacing; zero on
    the boundary."""
    hx, hy, hz = spacing(grid)
    mx, my, mz = grid

    def dist(m, h):
        i = torch.arange(m, device=device, dtype=torch.float64)
        return torch.minimum(i, m - 1 - i) * h

    dz = dist(mz, hz)[:, None, None]
    dy = dist(my, hy)[None, :, None]
    dx = dist(mx, hx)[None, None, :]
    u = lam / (lam + 1.0) * torch.sqrt(torch.minimum(torch.minimum(dx, dy),
                                                     dz))
    return torch.where(_interior(grid, device), u, 0.0)


def _prev(t: torch.Tensor, axis: int) -> torch.Tensor:
    """t at index − 1 along ``axis``, zero at the first index."""
    out = torch.zeros_like(t)
    src = t.narrow(axis, 0, t.shape[axis] - 1)
    out.narrow(axis, 1, t.shape[axis] - 1).copy_(src)
    return out


def _next(t: torch.Tensor, axis: int) -> torch.Tensor:
    """t at index + 1 along ``axis``, zero at the last index."""
    out = torch.zeros_like(t)
    src = t.narrow(axis, 1, t.shape[axis] - 1)
    out.narrow(axis, 0, t.shape[axis] - 1).copy_(src)
    return out


def _coefficients(grid, lam: float) -> tuple:
    hx, hy, hz = spacing(grid)
    return hy * hz / hx, hx * hz / hy, hx * hy / hz, lam * hx * hy * hz


def residual(grid, lam: float, u: torch.Tensor) -> torch.Tensor:
    """ex14's F(u) on the (Mz, My, Mx) grid, in u's dtype."""
    cx, cy, cz, sc = _coefficients(grid, lam)
    lap = (cx * (2 * u - _prev(u, 2) - _next(u, 2))
           + cy * (2 * u - _prev(u, 1) - _next(u, 1))
           + cz * (2 * u - _prev(u, 0) - _next(u, 0)))
    return torch.where(_interior(grid, u.device), lap - sc * torch.exp(u), u)


class System:
    """J(u_J) and b = -F(u_b) of one ex14 grid for two iterates on the
    (Mz, My, Mx) grid, each value rounded to ``dtype_in`` (the precision
    the configuration hands the solver) and held in float64."""

    def __init__(self, grid, lam: float, u_matrix: torch.Tensor,
                 u_rhs: torch.Tensor, dtype_in, device):
        self.grid = tuple(grid)
        self.device = torch.device(device)
        cx, cy, cz, sc = _coefficients(grid, lam)
        interior = _interior(grid, self.device)

        def rounded(t):
            return t.to(dtype_in).to(torch.float64)

        self.interior = interior
        # off-diagonal coefficient of each axis (the same in every interior
        # row), rounded as the solver receives it
        self.coef = {ax: float(rounded(torch.tensor(-c, dtype=torch.float64)))
                     for ax, c in (("x", cx), ("y", cy), ("z", cz))}
        uj = u_matrix.to(self.device, torch.float64).reshape(_shape(grid))
        self.diag = rounded(torch.where(
            interior, 2.0 * (cx + cy + cz) - sc * torch.exp(uj), 1.0))
        ub = u_rhs.to(self.device, torch.float64).reshape(_shape(grid))
        self.b = rounded(-residual(grid, lam, ub))

    def entries(self, dtype=torch.float64) -> dict:
        """The matrix by direction: (Mz, My, Mx) tensors of A[r, r + o],
        zero where the row stores no such entry (boundary rows, and every
        interior row's neighbours exist)."""
        out = {"c": self.diag.to(dtype)}
        for ax, c in self.coef.items():
            off = (self.interior.to(torch.float64) * c).to(dtype)
            out[ax + "-"] = off
            out[ax + "+"] = off
        return out

    def matvec(self, x: torch.Tensor, entries: dict | None = None):
        """J x on a grid-shaped or flat x, in x's dtype."""
        e = self.entries(x.dtype) if entries is None else entries
        xg = x.reshape(_shape(self.grid))
        y = e["c"] * xg
        for ax, axis in _AXIS.items():
            y = (y + e[ax + "-"] * _prev(xg, axis)
                 + e[ax + "+"] * _next(xg, axis))
        return y.reshape(x.shape)


def factor_sweeps(system: System, sweeps: int, dtype=torch.float64) -> dict:
    """``sweeps`` Jacobi-type Chow–Patel ILU(0) sweeps from the matrix
    itself (FactInit ORIGINAL), in ``dtype``.  On the 7-point pattern no
    fill pair reaches an upper or a lower entry, so each sweep is

        u_c[r]  ← a_c[r] − Σ_ax l_ax[r] · u_ax[r − e_ax]
        l_ax[r] ← a_ax-[r] / u_c[r − e_ax]        (from the last iterate)

    and the upper entries stay the matrix's.  A zero divisor divides by 1.
    Returns the factor by direction."""
    a = system.entries(dtype)
    f = dict(a)
    for _ in range(sweeps):
        new = dict(f)
        uc = a["c"]
        for ax in ("z", "y", "x"):
            axis = _AXIS[ax]
            uc = uc - f[ax + "-"] * _prev(f[ax + "+"], axis)
            den = _prev(f["c"], axis)
            den = torch.where(den == 0, torch.ones_like(den), den)
            new[ax + "-"] = torch.where(system.interior, a[ax + "-"] / den,
                                        0.0)
        new["c"] = uc
        f = new
    return f


def ilu_apply(system: System, f: dict, r: torch.Tensor, sweeps: int):
    """ILU(0) apply with ``sweeps`` Jacobi sweeps on each triangle from
    zero: y ← r − L y, then z ← (y − U z) / u_c."""
    shape = _shape(system.grid)
    rg = r.reshape(shape)
    dinv = 1.0 / f["c"]
    y = torch.zeros_like(rg)
    for _ in range(sweeps):
        y = rg - sum(f[ax + "-"] * _prev(y, _AXIS[ax]) for ax in "zyx")
    z = torch.zeros_like(rg)
    for _ in range(sweeps):
        z = dinv * (y - sum(f[ax + "+"] * _next(z, _AXIS[ax])
                            for ax in "xyz"))
    return z.reshape(r.shape)


def bicgstab(system: System, dtype, build_sweeps: int, apply_sweeps: int,
             rtol: float, maxiter: int):
    """Right-preconditioned BiCGSTAB from x0 = 0 with ILU(0) sweeps, every
    operation in ``dtype`` (the system's values rounded to it).  Stops at
    ||r|| < rtol·||b||, at ``maxiter``, or when a scalar is not finite.
    Returns (x, iterations)."""
    e = system.entries(dtype)
    f = factor_sweeps(system, build_sweeps, dtype)
    b = system.b.to(dtype).reshape(-1)

    def amat(v):
        return system.matvec(v, e)

    def prec(v):
        return ilu_apply(system, f, v, apply_sweeps)

    x = torch.zeros_like(b)
    r = b.clone()
    rhat = r.clone()
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho_old = alpha = omega = torch.ones((), dtype=dtype, device=b.device)
    bnorm = torch.linalg.vector_norm(b.to(torch.float64))
    it = 0
    while it < maxiter:
        it += 1
        rho = torch.dot(rhat, r)
        beta = (rho / rho_old) * (alpha / omega)
        p = r + beta * (p - omega * v)
        y = prec(p)
        v = amat(y)
        alpha = rho / torch.dot(rhat, v)
        s = r - alpha * v
        z = prec(s)
        t = amat(z)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x_new = x + alpha * y + omega * z
        if not bool(torch.isfinite(x_new).all()):
            break
        x = x_new
        r = s - omega * t
        rho_old = rho
        if float(torch.linalg.vector_norm(r.to(torch.float64))) \
                < rtol * float(bnorm):
            break
    return x, it


def relres(system: System, x: torch.Tensor) -> float:
    """||b − J x|| / ||b|| in float64."""
    x64 = x.to(torch.float64).reshape(-1)
    r = system.b.reshape(-1) - system.matvec(x64)
    return float(torch.linalg.vector_norm(r)
                 / torch.linalg.vector_norm(system.b))


def factor_gap(system: System, factor: dict, sweeps: int) -> float:
    """The widest gap of a factor (by direction, flat or grid-shaped) to
    the float64 sweeps here: per direction max |f − f_ref| over every row,
    divided by max |f_ref| over the interior rows (the boundary rows' 1 on
    the diagonal would hide a gap of the interior's ~6h), the largest over
    the directions."""
    ref = factor_sweeps(system, sweeps, torch.float64)
    inner = system.interior.reshape(-1)
    worst = 0.0
    for d in DIRECTIONS:
        want = ref[d].reshape(-1)
        got = factor[d].to(device=want.device,
                           dtype=torch.float64).reshape(-1)
        scale = float(want[inner].abs().max()) if bool(inner.any()) else 0.0
        gap = float((got - want).abs().max())
        worst = max(worst, gap / scale if scale > 0 else gap)
    return worst
