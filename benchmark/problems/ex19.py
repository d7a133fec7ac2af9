"""Inputs of PETSc SNES ex19 (2D driven cavity, u, v, ω, T at each point)
for the program under test, and the comparison of its answers with the
plain reference (``benchmark/reference/ex19.py``).

The pool is ex19's own Newton sequence at the configuration's grid: from
``FormInitialGuess`` x_0, x_{k+1} = x_k + δ_k with J(x_k) δ_k = −F(x_k),
until ||F(x_k)|| ≤ snes_rtol·||F(x_0)|| (PETSc's SNES default, in the mix
file).  Each step is the reference's float64 block ILU(0) BiCGSTAB solve to
the mix's ``step_rtol``.  The iterates are computed once and kept in a
cache file at a fixed path inside the checkout, so later runs load them.
Slot k of the pool is step k's system, J(x_k) and −F(x_k); the window runs
the steps in order from step 0 in every run, as every SNES solve starts at
``FormInitialGuess`` (the seed draws only which system of each slot is
judged).

The program's forms of a slot's system, written here apart from the
reference (its Jacobian is the analytic derivative of ex19's F, where the
reference differentiates F by forward-mode products), each computed in
float64 and rounded once to the configuration's dtype:

- :func:`host_bsr`: the Jacobian as a DMDA with a 5-point star
  preallocates it, every in-grid star block stored, zero blocks included,
  in natural block-row order with sorted columns;
- :func:`band_values`: the same values as the (k, bs², nb) block band that
  a block-DIA preconditioner's ``update_values`` takes, on the device;
- :func:`rhs`: b = −F(x) on the device.

:func:`judge` rebuilds each judged system with the reference and reads the
true residual of x and the factor's gap to the reference's plain sweeps;
the hooks :func:`control` and :func:`stale` give ``benchmark/readings.py``
what the limits are set from.

Grids are (mx, my), x fastest; iterates are (my, mx, 4) float64 tensors.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import ex19 as reference

__all__ = ["offsets", "jacobian_blocks", "band_values", "host_bsr", "rhs",
           "newton_iterates", "Inputs", "judge", "control", "stale"]

DOF = reference.DOF
U, V, OMEGA, TEMP = range(DOF)
#: The block diagonals, in the order of :func:`offsets`.
DIRECTIONS = reference.DIRECTIONS
#: The precision just below each configuration dtype: the control's.
BELOW = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def offsets(grid) -> tuple:
    """The block-column offsets of the 5-point star, sorted."""
    mx, _ = grid
    return (-mx, -1, 0, 1, mx)


def _sweeps(cfg: dict) -> tuple:
    nb, na = (int(v) for v in
              str(cfg["options"]["blasted_async_sweeps"]).split(","))
    return nb, na


def jacobian_blocks(grid, prm, x: torch.Tensor) -> torch.Tensor:
    """J(x) as (5, my, mx, 4, 4) float64 blocks by direction (``DIRECTIONS``),
    differentiated by hand from ex19's F; zero where the neighbour lies
    outside the grid.  At u = 0 (v = 0) the upwind switch takes the side of
    u > 0, as the reference does."""
    mx, my = grid
    dev = x.device
    dhx, dhy = float(mx - 1), float(my - 1)
    hx, hy = 1.0 / dhx, 1.0 / dhy
    a, c = hy * dhx, hx * dhy
    lid, gr, pr = prm
    x = x.to(torch.float64)
    j = torch.arange(my, device=dev)[:, None].expand(my, mx)
    i = torch.arange(mx, device=dev)[None, :].expand(my, mx)
    left, right = i == 0, i == mx - 1
    bottom = (j == 0) & ~left & ~right
    top = (j == my - 1) & ~left & ~right
    inner = ~(left | right | bottom | top)
    jac = torch.zeros((5, my, mx, DOF, DOF), dtype=torch.float64,
                      device=dev)
    d_of = {d: k for k, d in enumerate(DIRECTIONS)}

    def put(d, r, col, value, where):
        jac[d_of[d], :, :, r, col] += torch.where(where, value, 0.0) \
            if torch.is_tensor(value) else where.to(torch.float64) * value

    # value of field k at the neighbour (j + dj, i + di), 0 outside
    pad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))

    def at(dj, di, k):
        return pad[1 + dj:1 + dj + my, 1 + di:1 + di + mx, k]

    u, v = x[..., U], x[..., V]
    hu, hv = u >= 0, v >= 0
    vxp, vxm = torch.where(hu, u, 0.0), torch.where(hu, 0.0, u)
    vyp, vym = torch.where(hv, v, 0.0), torch.where(hv, 0.0, v)
    centre = 2 * a + 2 * c
    # interior: the 5-point Laplacian of every field
    for k in range(DOF):
        put("c", k, k, centre, inner)
        put("w", k, k, -a, inner)
        put("e", k, k, -a, inner)
        put("s", k, k, -c, inner)
        put("n", k, k, -c, inner)
    # F_u's −½(ω_n − ω_s)·hx, F_v's +½(ω_e − ω_w)·hy
    put("n", U, OMEGA, -0.5 * hx, inner)
    put("s", U, OMEGA, 0.5 * hx, inner)
    put("e", V, OMEGA, 0.5 * hy, inner)
    put("w", V, OMEGA, -0.5 * hy, inner)
    # F_ω's buoyancy −½·Gr·(T_e − T_w)·hy
    put("e", OMEGA, TEMP, -0.5 * gr * hy, inner)
    put("w", OMEGA, TEMP, 0.5 * gr * hy, inner)
    # upwinded convection of ω (factor 1) and T (factor Pr)
    for k, fac in ((OMEGA, 1.0), (TEMP, pr)):
        f = x[..., k]
        put("c", k, k, fac * ((vxp - vxm) * hy + (vyp - vym) * hx), inner)
        put("w", k, k, -fac * vxp * hy, inner)
        put("e", k, k, fac * vxm * hy, inner)
        put("s", k, k, -fac * vyp * hx, inner)
        put("n", k, k, fac * vym * hx, inner)
        du = torch.where(hu, f - at(0, -1, k), at(0, 1, k) - f)
        dv = torch.where(hv, f - at(-1, 0, k), at(1, 0, k) - f)
        put("c", k, U, fac * du * hy, inner)
        put("c", k, V, fac * dv * hx, inner)
    # boundary rows: the identity on u, v, ω and T, and their couplings
    edge = ~inner
    for k in range(DOF):
        put("c", k, k, 1.0, edge)
    put("c", OMEGA, U, -dhy, bottom)
    put("n", OMEGA, U, dhy, bottom)
    put("n", TEMP, TEMP, -1.0, bottom)
    put("c", OMEGA, U, dhy, top)
    put("s", OMEGA, U, -dhy, top)
    put("s", TEMP, TEMP, -1.0, top)
    put("c", OMEGA, V, dhx, left)
    put("e", OMEGA, V, -dhx, left)
    put("c", OMEGA, V, -dhx, right)
    put("w", OMEGA, V, dhx, right)
    return jac


def band_values(grid, prm, x: torch.Tensor, band_offsets, device,
                dtype) -> torch.Tensor:
    """J(x) as the (k, bs², nb) block band, ``data[d, r·bs + c, p]`` the
    entry (r, c) of the block at block row p and offset
    ``band_offsets[d]``, on ``device`` in ``dtype``."""
    if tuple(band_offsets) != offsets(grid):
        raise ValueError(f"offsets {tuple(band_offsets)} are not the 5-point "
                         f"star of {tuple(grid)}")
    mx, my = grid
    jac = jacobian_blocks(grid, prm, x.to(device))
    return jac.reshape(5, mx * my, DOF * DOF).transpose(1, 2) \
        .to(dtype).contiguous()


def host_bsr(grid, prm, x: torch.Tensor, dtype) -> tuple:
    """(rowptr, colind, vals (nnzb, 4, 4)) of J(x) as numpy arrays, int32
    indices and values in ``dtype``: every block of the star whose
    neighbour is inside the grid, zero blocks included."""
    mx, my = grid
    nb = mx * my
    jac = jacobian_blocks(grid, prm, x.to("cpu"))
    j = np.repeat(np.arange(my), mx)
    i = np.tile(np.arange(mx), my)
    inside = np.stack([j > 0, i > 0, np.ones(nb, bool), i < mx - 1,
                       j < my - 1], axis=1)                 # (nb, 5)
    cols = np.arange(nb)[:, None] + np.asarray(offsets(grid))[None, :]
    rowptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(inside.sum(axis=1), out=rowptr[1:])
    blocks = jac.permute(1, 2, 0, 3, 4).reshape(nb, 5, DOF, DOF).numpy()
    return (rowptr.astype(np.int32), cols[inside].astype(np.int32),
            blocks[inside].astype(dtype))


def residual(grid, prm, x: torch.Tensor) -> torch.Tensor:
    """ex19's F(x) in float64, row class by row class as
    ``FormFunctionLocal`` writes it."""
    mx, my = grid
    dhx, dhy = float(mx - 1), float(my - 1)
    hx, hy = 1.0 / dhx, 1.0 / dhy
    lid, gr, pr = prm
    x = x.to(torch.float64)
    f = torch.empty_like(x)
    # bottom and top, then left and right over every j
    f[0, :, U], f[0, :, V] = x[0, :, U], x[0, :, V]
    f[0, :, OMEGA] = x[0, :, OMEGA] + (x[1, :, U] - x[0, :, U]) * dhy
    f[0, :, TEMP] = x[0, :, TEMP] - x[1, :, TEMP]
    f[-1, :, U], f[-1, :, V] = x[-1, :, U] - lid, x[-1, :, V]
    f[-1, :, OMEGA] = x[-1, :, OMEGA] + (x[-1, :, U] - x[-2, :, U]) * dhy
    f[-1, :, TEMP] = x[-1, :, TEMP] - x[-2, :, TEMP]
    f[:, 0, U], f[:, 0, V] = x[:, 0, U], x[:, 0, V]
    f[:, 0, OMEGA] = x[:, 0, OMEGA] - (x[:, 1, V] - x[:, 0, V]) * dhx
    f[:, 0, TEMP] = x[:, 0, TEMP]
    f[:, -1, U], f[:, -1, V] = x[:, -1, U], x[:, -1, V]
    f[:, -1, OMEGA] = x[:, -1, OMEGA] - (x[:, -1, V] - x[:, -2, V]) * dhx
    f[:, -1, TEMP] = x[:, -1, TEMP] - float(gr > 0)
    # the interior, point (j, i) for 1 ≤ j ≤ my − 2, 1 ≤ i ≤ mx − 2
    cen = x[1:-1, 1:-1]
    west, east = x[1:-1, :-2], x[1:-1, 2:]
    south, north = x[:-2, 1:-1], x[2:, 1:-1]
    lap = ((2.0 * cen - west - east) * (hy * dhx)
           + (2.0 * cen - south - north) * (hx * dhy))
    vx, vy = cen[..., U], cen[..., V]
    vxp, vxm = 0.5 * (vx + vx.abs()), 0.5 * (vx - vx.abs())
    vyp, vym = 0.5 * (vy + vy.abs()), 0.5 * (vy - vy.abs())

    def upwind(k):
        g = cen[..., k]
        return ((vxp * (g - west[..., k]) + vxm * (east[..., k] - g)) * hy
                + (vyp * (g - south[..., k]) + vym * (north[..., k] - g))
                * hx)

    f[1:-1, 1:-1, U] = lap[..., U] \
        - 0.5 * (north[..., OMEGA] - south[..., OMEGA]) * hx
    f[1:-1, 1:-1, V] = lap[..., V] \
        + 0.5 * (east[..., OMEGA] - west[..., OMEGA]) * hy
    f[1:-1, 1:-1, OMEGA] = lap[..., OMEGA] + upwind(OMEGA) \
        - 0.5 * gr * (east[..., TEMP] - west[..., TEMP]) * hy
    f[1:-1, 1:-1, TEMP] = lap[..., TEMP] + pr * upwind(TEMP)
    return f


def rhs(grid, prm, x: torch.Tensor, device, dtype) -> torch.Tensor:
    """b = −F(x) as a flat vector on ``device`` in ``dtype``."""
    return (-residual(grid, prm, x.to(device))).reshape(-1).to(dtype)


def _check_mix(mix: dict) -> None:
    if mix["jacobian"] != "per_step":
        raise ValueError(f"mix jacobian {mix['jacobian']!r}: ex19's pool "
                         "takes per_step")


def newton_iterates(cfg: dict, mix: dict, device) -> dict:
    """ex19's Newton iterates x_0, …, x_{K−1} from ``FormInitialGuess``
    (the SNES solves K systems; x_K, where it stops, is not a system),
    float64 on the host, with ||F|| at every iterate x_0 … x_K and each
    step's BiCGSTAB iterations, each step also written to stderr.  A solve
    that breaks down (at 1024² the recurrence can stall near 2e-7 and its
    scalars vanish) restarts from its last iterate; a step that does not
    reach ``step_rtol`` in ``step_maxiter`` iterations in all raises."""
    _check_mix(mix)
    t0 = time.perf_counter()
    grid, prm = cfg["grid"], reference.params(cfg)
    nb, na = _sweeps(cfg)
    x = reference.initial_guess(grid, prm, device)
    iterates, norms, iters = [], [], []
    for _ in range(int(mix["snes_max_it"]) + 1):
        f = reference.residual(grid, prm, x)
        norms.append(float(torch.linalg.vector_norm(f)))
        if norms[-1] <= float(mix["snes_rtol"]) * norms[0]:
            break
        if len(iterates) == int(mix["snes_max_it"]):
            raise RuntimeError(f"ex19's Newton did not reach snes_rtol in "
                               f"{len(iterates)} steps: ||F|| {norms}")
        jac = reference.jacobian(grid, prm, x)
        dx, it, starts, ok = None, 0, 0, False
        while not ok and it < int(mix["step_maxiter"]):
            dx, more, ok = reference.bicgstab(
                jac, -f, torch.float64, nb, na, float(mix["step_rtol"]),
                int(mix["step_maxiter"]) - it, x0=dx)
            it, starts = it + more, starts + 1
        del jac
        if not ok:
            raise RuntimeError(f"Newton step {len(iterates)}: the reference "
                               f"solve stopped after {it} iterations short "
                               f"of step_rtol {mix['step_rtol']}")
        iterates.append(x.cpu())
        iters.append(it)
        x = x + dx.reshape(x.shape)
        print(f"ex19 Newton step {len(iterates) - 1}: ||F|| {norms[-1]:.6e}, "
              f"{it} iterations in {starts} start(s), "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    return {"iterates": iterates, "norms": norms, "iters": iters}


def _cached_iterates(cfg: dict, mix: dict, device, cache_dir) -> dict:
    """:func:`newton_iterates`, from a file in ``cache_dir`` where an
    earlier run left it (``cache_dir`` None: always computed)."""
    if cache_dir is None:
        return newton_iterates(cfg, mix, device)
    key = {k: cfg[k] for k in ("grid", "lidvelocity", "grashof", "prandtl",
                               "options")}
    key.update({k: mix[k] for k in ("jacobian", "snes_rtol", "snes_max_it",
                                    "step_rtol", "step_maxiter")})
    digest = hashlib.sha1(json.dumps(key, sort_keys=True).encode()) \
        .hexdigest()[:16]
    mx, my = cfg["grid"]
    path = Path(cache_dir) / f"ex19_{mx}x{my}_{digest}.pt"
    if path.is_file():
        return torch.load(path)
    pool = newton_iterates(cfg, mix, device)
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_suffix(".part")
    torch.save(pool, part)
    os.replace(part, path)
    return pool


class Inputs:
    """One run's pool: ex19's Newton iterates, one system each, walked in
    order from step 0."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 cache_dir=None):
        _check_mix(mix)
        self.cfg = cfg
        self.prm = reference.params(cfg)
        pool = _cached_iterates(cfg, mix, device, cache_dir)
        self.iterates = pool["iterates"]
        self.norms, self.step_iters = pool["norms"], pool["iters"]
        self.slots = len(self.iterates)

    def slot(self, i: int) -> int:
        """The slot of the run's i-th system: the steps in order from
        step 0, repeated."""
        return i % self.slots

    def host_bsr(self) -> tuple:
        """The host BSR of the matrix set-up factors: the first system's."""
        return host_bsr(self.cfg["grid"], self.prm,
                        self.iterates[self.slot(0)],
                        np.dtype(self.cfg["dtype"]))

    def rhs(self, device, dtype) -> list:
        return [rhs(self.cfg["grid"], self.prm, x, device, dtype)
                for x in self.iterates]

    def bands(self, band_offsets, device, dtype) -> list:
        """Each slot's block band: every system brings its own matrix."""
        return [band_values(self.cfg["grid"], self.prm, x, band_offsets,
                            device, dtype) for x in self.iterates]


def _reference_system(cfg: dict, inputs: Inputs, k: int, device) -> tuple:
    """The reference's J and b of slot k, rebuilt from the slot's iterate
    and rounded to the configuration's dtype."""
    grid, prm = cfg["grid"], inputs.prm
    dtype = getattr(torch, cfg["dtype"])
    x = inputs.iterates[k].to(device)
    blocks = {d: t.to(dtype).to(torch.float64)
              for d, t in reference.jacobian(grid, prm, x).items()}
    b = (-reference.residual(grid, prm, x)).to(dtype).to(torch.float64)
    return blocks, b


def by_direction(factor: dict, grid) -> dict:
    """A factor keyed by block offset, (bs², nb) slabs, as blocks by
    direction, (my, mx, 4, 4)."""
    mx, my = grid
    out = {}
    for d, o in zip(DIRECTIONS, offsets(grid)):
        out[d] = factor[o].reshape(DOF, DOF, my, mx).permute(2, 3, 0, 1)
    return out


def judge(cfg: dict, inputs: Inputs, samples, device) -> dict:
    """The compared numbers of the sampled systems: ``relres_max`` (the
    largest ||b − J x|| / ||b|| in float64, J and b the reference's at the
    slot's iterate) and ``factor_gap_max`` (the widest gap, per block
    diagonal, of a sampled factor to the reference's plain float64 sweeps:
    2K for the centre, 2K − 1 for the lowers, the base values for the
    uppers; None where no sample holds a factor)."""
    nb, _ = _sweeps(cfg)
    res, gap = None, None
    for smp in samples:
        blocks, b = _reference_system(cfg, inputs, smp.slot, device)
        r = reference.relres(blocks, b, smp.x.to(device))
        res = r if res is None else max(res, r)
        if smp.factor is not None:
            g = reference.factor_gap(
                reference.port_factor(blocks, nb),
                by_direction({o: t.to(device) for o, t in
                              smp.factor.items()}, cfg["grid"]))
            gap = g if gap is None else max(gap, g)
        del blocks, b
    return {"relres_max": res, "factor_gap_max": gap}


def control(cfg: dict, inputs: Inputs, device, dtype) -> dict:
    """The control (``benchmark/readings.py --control``): the reference in
    the program's place, x and factor of every slot of the pool, judged as
    the program's are.  It computes in ``dtype``, but never below the
    precision just below the configuration's (``BELOW``: float32 for a
    float64 configuration, whatever lower dtype the caller names)."""
    nb, na = _sweeps(cfg)
    opts = cfg["options"]
    floor = BELOW[getattr(torch, cfg["dtype"])]
    if torch.finfo(dtype).bits < torch.finfo(floor).bits:
        dtype = floor
    res, gap, iters = 0.0, 0.0, []
    for k in range(inputs.slots):
        blocks, b = _reference_system(cfg, inputs, k, device)
        x, it, _ = reference.bicgstab(blocks, b, dtype, nb, na,
                                      float(opts["rtol"]),
                                      int(opts["maxiter"]))
        iters.append(it)
        res = max(res, reference.relres(blocks, b, x))
        gap = max(gap, reference.factor_gap(
            reference.port_factor(blocks, nb),
            reference.port_factor(blocks, nb, dtype)))
        del blocks, b, x
    return {"dtype": str(dtype).replace("torch.", ""), "relres_max": res,
            "factor_gap_max": gap, "iters": iters}


def stale(cfg: dict, inputs: Inputs, device) -> dict:
    """The stale-factor reading (``benchmark/readings.py --stale``):
    gaps[k][j] is slot k's system judged against the reference's factor of
    slot j's matrix in the configuration's dtype (j = k: a sound factor, to
    rounding)."""
    nb, _ = _sweeps(cfg)
    dtype = getattr(torch, cfg["dtype"])
    factors = []
    for j in range(inputs.slots):
        blocks, _ = _reference_system(cfg, inputs, j, device)
        factors.append({d: t.cpu() for d, t in
                        reference.port_factor(blocks, nb, dtype).items()})
        del blocks
    gaps = []
    for k in range(inputs.slots):
        blocks, _ = _reference_system(cfg, inputs, k, device)
        ref = reference.port_factor(blocks, nb)
        gaps.append([reference.factor_gap(ref, f) for f in factors])
        del blocks, ref
    return {"gaps": gaps}
