"""Plain reference for PETSc SNES ex19, the 2D nonlinear driven cavity.

ex19 (``src/snes/tutorials/ex19.c``) solves for the velocity (u, v), the
vorticity ω and the temperature T of a lid-driven cavity with buoyancy, on
an mx × my DMDA (x fastest) with a 5-point star stencil and 4 unknowns at
each point, in the order (u, v, ω, T).  Its ``FormFunctionLocal`` writes,
with dhx = mx − 1, dhy = my − 1, hx = 1/dhx, hy = 1/dhy, hydhx = hy·dhx,
hxdhy = hx·dhy, for a field a

    Δa = (2a − a_w − a_e)·hydhx + (2a − a_s − a_n)·hxdhy

(w, e, s, n the neighbours at i − 1, i + 1, j − 1, j + 1), and the upwind
coefficients vxp = max(u, 0), vxm = min(u, 0), vyp = max(v, 0),
vym = min(v, 0):

- at an interior point,

      F_u = Δu − ½(ω_n − ω_s)·hx
      F_v = Δv + ½(ω_e − ω_w)·hy
      F_ω = Δω + [vxp(ω − ω_w) + vxm(ω_e − ω)]·hy
               + [vyp(ω − ω_s) + vym(ω_n − ω)]·hx − ½·Gr·(T_e − T_w)·hy
      F_T = ΔT + Pr·{[vxp(T − T_w) + vxm(T_e − T)]·hy
                     + [vyp(T − T_s) + vym(T_n − T)]·hx};

- on the boundary, bottom (j = 0) and top first, then left (i = 0) and
  right over every j, so that the four corners take the left and right
  rows:

      bottom  (u, v, ω + (u_n − u)·dhy, T − T_n)
      top     (u − lid, v, ω + (u − u_s)·dhy, T − T_s)
      left    (u, v, ω − (v_e − v)·dhx, T)
      right   (u, v, ω − (v − v_w)·dhx, T − [Gr > 0]).

``FormInitialGuess`` is u = v = ω = 0 and T = [Gr > 0]·i/(mx − 1).
ex19's defaults are lid = 1/(mx·my), Pr = 1, Gr = 1; the configuration
states its own (``lidvelocity``, ``grashof``, ``prandtl``).

Departures from ex19: the Jacobian is built by forward-mode products
(``torch.func.jvp``) over ex19's distance-2 colouring of the 5-point star,
colour (i + 5j) mod 13 times the 4 unknowns, 52 products, where PETSc
differences F over the same colouring; so it has no differencing error.
At a kink (u = 0 or v = 0) it takes d max(u, 0)/du = 1 and
d min(u, 0)/du = 0, as a positive differencing step does.

Fields are (my, mx, 4) tensors; flat, they are the program's vector (block
rows in natural order, the 4 unknowns of a point together).  A Jacobian is
a dict of (my, mx, 4, 4) blocks by direction (:data:`DIRECTIONS`), block
[r, c] the derivative of row unknown r by column unknown c, zero where the
neighbour is outside the grid.

Beside the residual and the Jacobian: the block matrix–vector product,
block Chow–Patel ILU(0) sweeps in their plain form, the ILU apply sweeps,
right-preconditioned BiCGSTAB in any dtype, the relative residual and the
gap of a factor to the plain sweeps.  Plain PyTorch on whatever device it
is given; it imports nothing of the program under test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# block products are broadcast multiply-adds; no TF32 anywhere
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["Params", "params", "DIRECTIONS", "STEP", "DOF", "initial_guess",
           "residual", "jacobian", "matvec", "factor_sweeps", "port_factor",
           "ilu_apply", "bicgstab", "relres", "factor_gap"]

DOF = 4
#: The block diagonals in the order of sorted block-column offsets
#: (−mx, −1, 0, 1, mx): south, west, centre, east, north.
DIRECTIONS = ("s", "w", "c", "e", "n")
#: The grid step (dj, di) of each direction.
STEP = {"s": (-1, 0), "w": (0, -1), "c": (0, 0), "e": (0, 1), "n": (1, 0)}
LOWER, UPPER = ("s", "w"), ("e", "n")
U, V, OMEGA, TEMP = range(DOF)


class Params(NamedTuple):
    lid: float
    grashof: float
    prandtl: float


def params(cfg: dict) -> Params:
    return Params(float(cfg["lidvelocity"]), float(cfg["grashof"]),
                  float(cfg["prandtl"]))


def initial_guess(grid, prm: Params, device) -> torch.Tensor:
    """ex19's ``FormInitialGuess`` in float64."""
    mx, my = grid
    x = torch.zeros((my, mx, DOF), dtype=torch.float64, device=device)
    i = torch.arange(mx, dtype=torch.float64, device=device)
    x[:, :, TEMP] = float(prm.grashof > 0) * i / (mx - 1)
    return x


def shifted(t: torch.Tensor, d: str) -> torch.Tensor:
    """``t`` (my, mx, ...) read at the neighbour in direction ``d``, zero
    outside the grid."""
    for axis, step in enumerate(STEP[d]):
        if step:
            n = t.shape[axis]
            edge = torch.zeros_like(t.narrow(axis, 0, 1))
            t = torch.cat([t.narrow(axis, 1, n - 1), edge] if step > 0
                          else [edge, t.narrow(axis, 0, n - 1)], dim=axis)
    return t


def _rows(grid, device):
    mx, my = grid
    j = torch.arange(my, device=device)[:, None, None]
    i = torch.arange(mx, device=device)[None, :, None]
    return i, j


def residual(grid, prm: Params, x: torch.Tensor) -> torch.Tensor:
    """ex19's F(x) (see the module docstring), in x's dtype."""
    mx, my = grid
    dhx, dhy = float(mx - 1), float(my - 1)
    hx, hy = 1.0 / dhx, 1.0 / dhy
    hydhx, hxdhy = hy * dhx, hx * dhy
    c = x
    w, e, s, n = (shifted(x, d) for d in ("w", "e", "s", "n"))
    lap = (2 * c - w - e) * hydhx + (2 * c - s - n) * hxdhy
    u, v = c[..., U], c[..., V]
    zero = torch.zeros_like(u)
    vxp, vxm = torch.where(u >= 0, u, zero), torch.where(u >= 0, zero, u)
    vyp, vym = torch.where(v >= 0, v, zero), torch.where(v >= 0, zero, v)

    def convect(k):
        f = c[..., k]
        return ((vxp * (f - w[..., k]) + vxm * (e[..., k] - f)) * hy
                + (vyp * (f - s[..., k]) + vym * (n[..., k] - f)) * hx)

    om, t = c[..., OMEGA], c[..., TEMP]
    inner = torch.stack([
        lap[..., U] - 0.5 * (n[..., OMEGA] - s[..., OMEGA]) * hx,
        lap[..., V] + 0.5 * (e[..., OMEGA] - w[..., OMEGA]) * hy,
        lap[..., OMEGA] + convect(OMEGA)
        - 0.5 * prm.grashof * (e[..., TEMP] - w[..., TEMP]) * hy,
        lap[..., TEMP] + prm.prandtl * convect(TEMP)], dim=-1)
    bottom = torch.stack([u, v, om + (n[..., U] - u) * dhy,
                          t - n[..., TEMP]], dim=-1)
    top = torch.stack([u - prm.lid, v, om + (u - s[..., U]) * dhy,
                       t - s[..., TEMP]], dim=-1)
    left = torch.stack([u, v, om - (e[..., V] - v) * dhx, t], dim=-1)
    right = torch.stack([u, v, om - (v - w[..., V]) * dhx,
                         t - float(prm.grashof > 0)], dim=-1)
    i, j = _rows(grid, x.device)
    f = torch.where(j == 0, bottom, inner)
    f = torch.where(j == my - 1, top, f)
    f = torch.where(i == 0, left, f)
    return torch.where(i == mx - 1, right, f)


def jacobian(grid, prm: Params, x: torch.Tensor) -> dict:
    """J(x) as blocks by direction, by 52 forward-mode products over the
    distance-2 colouring (i + 5j) mod 13: within any row's 5-point star
    the 5 colours differ, so the product with the indicator of colour c and
    unknown k holds, in row r, column k of r's block at its neighbour of
    colour c."""
    mx, my = grid
    i, j = _rows(grid, x.device)
    colour = (i[..., 0] + 5 * j[..., 0]) % 13          # (my, mx)
    inside = {d: shifted(torch.ones_like(colour, dtype=torch.bool), d)
              for d in DIRECTIONS}
    neighbour = {d: shifted(colour, d) for d in DIRECTIONS}
    blocks = {d: x.new_zeros((my, mx, DOF, DOF)) for d in DIRECTIONS}

    def product(seed):
        return torch.func.jvp(lambda y: residual(grid, prm, y), (x,),
                              (seed,))[1]

    unit = torch.eye(DOF, dtype=x.dtype, device=x.device)
    for col in range(13):
        hit = (colour == col).to(x.dtype)
        # the 4 unknowns of one colour: one batch of 4 products
        seeds = hit[None, :, :, None] * unit[:, None, None, :]
        jv = torch.func.vmap(product)(seeds)             # (4, my, mx, 4)
        for d in DIRECTIONS:
            sel = (inside[d] & (neighbour[d] == col))[..., None, None]
            blocks[d] = torch.where(sel, jv.permute(1, 2, 3, 0), blocks[d])
    return blocks


def _bmv(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block times vector at every point: (…, 4, 4) by (…, 4)."""
    return (b * x.unsqueeze(-2)).sum(-1)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Block times block at every point."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def matvec(blocks: dict, x: torch.Tensor) -> torch.Tensor:
    """J x for a (my, mx, 4) or flat x, in the blocks' dtype."""
    c = blocks["c"]
    xg = x.reshape(c.shape[:3])
    y = sum(_bmv(blocks[d], shifted(xg, d)) for d in DIRECTIONS)
    return y.reshape(x.shape)


def _inverse(b: torch.Tensor) -> torch.Tensor:
    """Each block's inverse; a singular block gives non-finite values and
    does not raise (see :func:`factor_sweeps`)."""
    return torch.linalg.inv_ex(b).inverse


def factor_sweeps(blocks: dict, sweeps: int, dtype=torch.float64,
                  keep_lowers_at: int | None = None) -> dict:
    """``sweeps`` Jacobi-type block Chow–Patel ILU(0) sweeps from the
    matrix itself (FactInit ORIGINAL), in ``dtype``.  On the 5-point star
    only the centre has fill pairs, (s, n) and (w, e), so each sweep is

        C[r]   ← A_c[r] − L_s[r]·U_n[r − mx] − L_w[r]·U_e[r − 1]
        L_d[r] ← A_d[r]·C[r + step d]⁻¹          (d = s, w; last iterate)

    and the uppers stay the matrix's.  The centre at sweep t reads the
    lowers of sweep t − 1, which read the centre of sweep t − 2, so the
    even and the odd iterates form two chains that never meet.  The odd
    chain starts from lowers that were never divided, and its centre can
    be singular (on ex19's walls C_1's T,T entry is 1 − 1): its inverse
    is then not finite, and nothing of the even chain reads it.  With
    ``keep_lowers_at`` the lowers returned are those of that sweep.
    Returns the factor by direction."""
    a = {d: t.to(dtype) for d, t in blocks.items()}
    f = dict(a)
    kept = None
    for it in range(1, sweeps + 1):
        new = dict(f)
        new["c"] = (a["c"] - _bmm(f["s"], shifted(f["n"], "s"))
                    - _bmm(f["w"], shifted(f["e"], "w")))
        inv = _inverse(f["c"])
        for d in LOWER:
            new[d] = _bmm(a[d], shifted(inv, d))
        f = new
        if it == keep_lowers_at:
            kept = {d: f[d] for d in LOWER}
    if kept is not None:
        f.update(kept)
    return f


def port_factor(blocks: dict, build_sweeps: int,
                dtype=torch.float64) -> dict:
    """The factor the program's compressed route reaches with
    ``build_sweeps`` sweeps, by plain sweeps: K compressed sweeps carry 2K
    plain ones for the centre and 2K − 1 for the lowers."""
    return factor_sweeps(blocks, 2 * build_sweeps, dtype,
                         keep_lowers_at=2 * build_sweeps - 1)


def ilu_apply(f: dict, dinv: torch.Tensor, r: torch.Tensor,
              sweeps: int) -> torch.Tensor:
    """ILU(0) apply with ``sweeps`` Jacobi sweeps on each triangle from
    zero: y ← r − L y, then z ← C⁻¹(y − U z)."""
    rg = r.reshape(dinv.shape[:3])
    y = torch.zeros_like(rg)
    for _ in range(sweeps):
        y = rg - sum(_bmv(f[d], shifted(y, d)) for d in LOWER)
    z = torch.zeros_like(rg)
    for _ in range(sweeps):
        z = _bmv(dinv, y - sum(_bmv(f[d], shifted(z, d)) for d in UPPER))
    return z.reshape(r.shape)


def bicgstab(blocks: dict, b: torch.Tensor, dtype, build_sweeps: int,
             apply_sweeps: int, rtol: float, maxiter: int,
             x0: torch.Tensor | None = None):
    """Right-preconditioned BiCGSTAB from ``x0`` (zero where None) with
    block ILU(0) (the compressed route's factor), every operation in
    ``dtype``.  Stops at ||r|| < rtol·||b||, at ``maxiter``, or when an
    iterate is not finite (a breakdown; x is the last finite iterate).
    Returns (x, iterations, converged), x flat."""
    e = {d: t.to(dtype) for d, t in blocks.items()}
    f = port_factor(blocks, build_sweeps, dtype)
    dinv = _inverse(f["c"])
    b = b.to(dtype).reshape(-1)

    def prec(v):
        return ilu_apply(f, dinv, v, apply_sweeps)

    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.to(dtype).reshape(-1)
        r = b - matvec(e, x)
    rhat = r.clone()
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho_old = alpha = omega = torch.ones((), dtype=dtype, device=b.device)
    bnorm = float(torch.linalg.vector_norm(b.to(torch.float64)))
    it, done = 0, False
    while it < maxiter and not done:
        it += 1
        rho = torch.dot(rhat, r)
        beta = (rho / rho_old) * (alpha / omega)
        p = r + beta * (p - omega * v)
        y = prec(p)
        v = matvec(e, y)
        alpha = rho / torch.dot(rhat, v)
        s = r - alpha * v
        z = prec(s)
        t = matvec(e, z)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x_new = x + alpha * y + omega * z
        if not bool(torch.isfinite(x_new).all()):
            break
        x = x_new
        r = s - omega * t
        rho_old = rho
        done = float(torch.linalg.vector_norm(r.to(torch.float64))) \
            < rtol * bnorm
    return x, it, done


def relres(blocks: dict, b: torch.Tensor, x: torch.Tensor) -> float:
    """||b − J x|| / ||b|| in float64."""
    b64 = b.to(torch.float64).reshape(-1)
    r = b64 - matvec({d: t.to(torch.float64) for d, t in blocks.items()},
                     x.to(torch.float64).reshape(-1))
    return float(torch.linalg.vector_norm(r)
                 / torch.linalg.vector_norm(b64))


def factor_gap(ref: dict, got: dict) -> float:
    """The widest gap of a factor to ``ref`` (both by direction): per block
    diagonal max |f − f_ref| over max |f_ref|, the largest over the
    diagonals."""
    worst = 0.0
    for d in DIRECTIONS:
        want = ref[d].to(torch.float64)
        have = got[d].to(device=want.device, dtype=torch.float64) \
            .reshape(want.shape)
        scale = float(want.abs().max())
        gap = float((have - want).abs().max())
        worst = max(worst, gap / scale if scale > 0 else gap)
    return worst
