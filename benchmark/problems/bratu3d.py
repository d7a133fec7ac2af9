"""Inputs of PETSc SNES ex14 (3D Bratu) for the program under test, and
the comparison of its answers with the plain reference.

The pool is ex14's own Newton sequence at the configuration's grid: from
``FormInitialGuess`` u_0, u_{k+1} = u_k + δ_k with J δ_k = -F(u_k), until
||F(u_k)|| ≤ snes_rtol·||F(u_0)|| (PETSc's SNES default, in the mix
file).  The mix's ``jacobian`` says which J: ``per_step`` J(u_k) (the user
who rebuilds the preconditioner at every step) or ``lagged`` J(u_0)
(``-snes_lag_jacobian`` / ``-snes_lag_preconditioner``).  Each step is the
plain reference's float64 ILU(0) BiCGSTAB solve, to the mix's
``step_rtol``, of the system as the program gets it (J and -F rounded to
the configuration's dtype), so δ_k is also the answer the program's x is
judged against.  The steps are computed once and kept in a cache file
at a fixed path inside the checkout, so later runs load them.  Slot k of
the pool is step k's system; the window runs the steps in order,
repeated, from a step drawn from the seed.

The program's three forms of a slot's system, each computed in float64
and rounded once to the configuration's dtype, with code apart from the
reference's (``benchmark/reference/bratu3d.py``):

- :func:`host_csr`: the Jacobian as PETSc's ``MatSetValuesStencil``
  leaves it (sorted columns, boundary rows holding the diagonal 1 alone);
- :func:`band_values`: the same values as the (k, n) band that a DIA
  preconditioner's ``update_values`` takes, built on the device;
- :func:`rhs`: b = -F(u) on the device.

Beside :func:`judge`, the hooks that ``benchmark/readings.py`` calls to
read what the limits are set from: :func:`control` (the reference in a
lower precision in the program's place) and :func:`stale` (each slot
judged against another slot's factor).

Grids are (Mx, My, Mz) with x fastest, z slowest (PETSc's natural DMDA
ordering); iterates are (Mz, My, Mx) float64 tensors.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import bratu3d as reference

__all__ = ["offsets", "by_direction", "guess", "host_csr", "band_values",
           "rhs", "newton_steps", "Inputs", "judge", "control", "stale"]

#: The star's directions in the order of :func:`offsets`.
DIRECTIONS = ("z-", "y-", "x-", "c", "x+", "y+", "z+")


def _coefficients(grid, lam: float) -> tuple:
    mx, my, mz = grid
    hx, hy, hz = 1.0 / (mx - 1), 1.0 / (my - 1), 1.0 / (mz - 1)
    return hy * hz / hx, hx * hz / hy, hx * hy / hz, lam * hx * hy * hz


def offsets(grid) -> tuple:
    """The column offsets of the 7-point star, sorted."""
    mx, my, _ = grid
    return (-mx * my, -mx, -1, 0, 1, mx, mx * my)


def by_direction(grid, by_offset: dict) -> dict:
    """Rows of a band keyed by column offset, keyed by direction."""
    return {d: by_offset[o] for d, o in zip(DIRECTIONS, offsets(grid))}


def _interior(grid, device) -> torch.Tensor:
    mx, my, mz = grid
    m = torch.zeros((mz, my, mx), dtype=torch.bool, device=device)
    m[1:-1, 1:-1, 1:-1] = True
    return m


def guess(grid, lam: float, device) -> torch.Tensor:
    """ex14's ``FormInitialGuess``: λ/(λ+1)·sqrt of the least distance to
    a face, float64; zero on every face, where one distance is 0."""
    mx, my, mz = grid
    hx, hy, hz = 1.0 / (mx - 1), 1.0 / (my - 1), 1.0 / (mz - 1)

    def dist(m, h):
        i = torch.arange(m, dtype=torch.float64, device=device)
        return torch.minimum(i, m - 1 - i) * h

    d = torch.minimum(torch.minimum(dist(mx, hx)[None, None, :],
                                    dist(my, hy)[None, :, None]),
                      dist(mz, hz)[:, None, None])
    return lam / (lam + 1.0) * torch.sqrt(d)


def band_values(grid, lam: float, u: torch.Tensor, band_offsets, device,
                dtype) -> torch.Tensor:
    """J(u) as a (k, n) band, ``data[d, i] = J[i, i + band_offsets[d]]``
    (zero where row i stores no such entry), on ``device`` in ``dtype``."""
    cx, cy, cz, sc = _coefficients(grid, lam)
    interior = _interior(grid, device).reshape(-1)
    inner = interior.to(torch.float64)
    uf = u.to(device, torch.float64).reshape(-1)
    diag = torch.where(interior, 2.0 * (cx + cy + cz) - sc * torch.exp(uf),
                       1.0)
    coef = dict(zip(offsets(grid), (-cz, -cy, -cx, None, -cx, -cy, -cz)))
    rows = []
    for o in band_offsets:
        if o not in coef:
            raise ValueError(f"offset {o} is not on the 7-point star of "
                             f"{tuple(grid)}")
        rows.append(diag if o == 0 else inner * coef[o])
    return torch.stack(rows).to(dtype)


def host_csr(grid, lam: float, u: torch.Tensor, dtype) -> tuple:
    """(rowptr, colind, vals, diagind) of J(u) as numpy arrays: int32
    indices, values in ``dtype``; interior rows hold 7 entries, boundary
    rows 1.  Built from :func:`band_values` on the host."""
    n = int(np.prod(grid))
    offs = offsets(grid)
    band = band_values(grid, lam, u, offs, "cpu", torch.float64)
    interior = _interior(grid, "cpu").reshape(-1)
    valid = interior[:, None].expand(n, 7).clone()
    valid[:, 3] = True
    rowptr = torch.zeros(n + 1, dtype=torch.int64)
    torch.cumsum(valid.sum(dim=1), dim=0, out=rowptr[1:])
    cols = torch.arange(n, dtype=torch.int64)[:, None] \
        + torch.tensor(offs, dtype=torch.int64)[None, :]
    colind = cols[valid].to(torch.int32)
    del cols
    vals = band.T[valid].numpy().astype(dtype)
    diagind = rowptr[:-1] + torch.where(interior, 3, 0)
    return (rowptr.to(torch.int32).numpy(), colind.numpy(), vals,
            diagind.to(torch.int32).numpy())


def rhs(grid, lam: float, u: torch.Tensor, device, dtype) -> torch.Tensor:
    """b = -F(u) (ex14's ``FormFunction``: F = u on the boundary) as a
    flat vector on ``device`` in ``dtype``."""
    cx, cy, cz, sc = _coefficients(grid, lam)
    u = u.to(device, torch.float64)
    f = torch.zeros_like(u)
    c = u[1:-1, 1:-1, 1:-1]
    f[1:-1, 1:-1, 1:-1] = (
        cx * (2 * c - u[1:-1, 1:-1, :-2] - u[1:-1, 1:-1, 2:])
        + cy * (2 * c - u[1:-1, :-2, 1:-1] - u[1:-1, 2:, 1:-1])
        + cz * (2 * c - u[:-2, 1:-1, 1:-1] - u[2:, 1:-1, 1:-1])
        - sc * torch.exp(c))
    f = torch.where(_interior(grid, device), f, u)
    return (-f).reshape(-1).to(dtype)


def _sweeps(cfg: dict) -> tuple:
    nb, na = (int(v) for v in
              str(cfg["options"]["blasted_async_sweeps"]).split(","))
    return nb, na


def newton_steps(cfg: dict, mix: dict, device) -> list:
    """ex14's Newton steps δ_0, …, δ_{K-1} from u_0 (see the module
    docstring): the SNES solves K systems, and u_K = u_0 + δ_0 + … is
    where it stops.  Float64 tensors on the host."""
    grid, lam = cfg["grid"], float(cfg["lambda"])
    lagged = mix["jacobian"] == "lagged"
    if not lagged and mix["jacobian"] != "per_step":
        raise ValueError(f"mix jacobian {mix['jacobian']!r}: per_step or "
                         "lagged")
    nb, na = _sweeps(cfg)
    dtype_in = getattr(torch, cfg["dtype"])
    u0 = guess(grid, lam, device)
    u, steps, f0 = u0, [], None
    for _ in range(int(mix["snes_max_it"])):
        fn = float(torch.linalg.vector_norm(reference.residual(grid, lam,
                                                               u)))
        f0 = fn if f0 is None else f0
        if fn <= float(mix["snes_rtol"]) * f0:
            break
        system = reference.System(grid, lam, u0 if lagged else u, u,
                                  dtype_in, device)
        du, _ = reference.bicgstab(system, torch.float64, nb, na,
                                   float(mix["step_rtol"]),
                                   int(mix["step_maxiter"]))
        del system
        du = du.reshape(u.shape)
        u = u + du
        steps.append(du.cpu())
    return steps


def _cached_steps(cfg: dict, mix: dict, device, cache_dir) -> list:
    """:func:`newton_steps`, from a file in ``cache_dir`` where an earlier
    run left it (``cache_dir`` None: always computed)."""
    if cache_dir is None:
        return newton_steps(cfg, mix, device)
    key = {k: cfg[k] for k in ("grid", "lambda", "options")}
    key.update({k: mix[k] for k in ("jacobian", "snes_rtol",
                                    "snes_max_it", "step_rtol",
                                    "step_maxiter")})
    digest = hashlib.sha1(json.dumps(key, sort_keys=True).encode()) \
        .hexdigest()[:16]
    mx, my, mz = cfg["grid"]
    path = Path(cache_dir) / f"bratu3d_{mx}x{my}x{mz}_{digest}.pt"
    if path.is_file():
        return torch.load(path)
    steps = newton_steps(cfg, mix, device)
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_suffix(".part")
    torch.save(steps, part)
    os.replace(part, path)
    return steps


def _system(cfg: dict, inputs: "Inputs", k: int, device):
    """The reference's form of slot k's system, in the configuration's
    dtype, rebuilt from the slot's iterate."""
    return reference.System(cfg["grid"], cfg["lambda"], inputs.u_matrix(k),
                            inputs.iterates[k], getattr(torch, cfg["dtype"]),
                            device)


class Inputs:
    """One run's pool: the Newton iterates and steps, the iterate each
    slot's matrix is taken at, and the first slot of the window, drawn
    from the seed."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 cache_dir=None):
        self.cfg = cfg
        self.steps = _cached_steps(cfg, mix, device, cache_dir)
        u = guess(cfg["grid"], float(cfg["lambda"]), "cpu")
        self.iterates = [u]     # u_k, summed as newton_steps summed them
        for du in self.steps[:-1]:
            u = u + du
            self.iterates.append(u)
        self.per_system = mix["jacobian"] == "per_step"
        self.slots = len(self.steps)
        rng = np.random.default_rng(seed % 2 ** 64)
        self.start = int(rng.integers(self.slots))

    def slot(self, i: int) -> int:
        """The slot of the run's i-th system."""
        return (self.start + i) % self.slots

    def u_matrix(self, k: int) -> torch.Tensor:
        return self.iterates[k if self.per_system else 0]

    def answer(self, k: int) -> torch.Tensor:
        """The reference's answer of slot k: the Newton step δ_k, flat."""
        return self.steps[k].reshape(-1)

    def host_csr(self) -> tuple:
        """The host CSR of the matrix set-up factors: the first system's."""
        cfg = self.cfg
        return host_csr(cfg["grid"], cfg["lambda"],
                        self.u_matrix(self.slot(0)), np.dtype(cfg["dtype"]))

    def rhs(self, device, dtype) -> list:
        cfg = self.cfg
        return [rhs(cfg["grid"], cfg["lambda"], u, device, dtype)
                for u in self.iterates]

    def bands(self, band_offsets, device, dtype) -> list | None:
        """Each slot's band, where every system brings its own matrix."""
        if not self.per_system:
            return None
        cfg = self.cfg
        return [band_values(cfg["grid"], cfg["lambda"], u, band_offsets,
                            device, dtype) for u in self.iterates]


def judge(cfg: dict, inputs: Inputs, samples, device) -> dict:
    """The compared numbers of the sampled systems: ``x_error_max`` (the
    largest ||x − δ|| / ||δ|| of a sampled x against the reference's
    float64 answer δ of its system, see the module docstring) and
    ``factor_gap_max`` (the widest gap of a sampled factor to the
    reference's own sweeps, on the system the reference rebuilds from the
    iterate; None where no sample holds a factor)."""
    nb, _ = _sweeps(cfg)
    err, gap = None, None
    for smp in samples:
        want = inputs.answer(smp.slot).to(device)
        got = smp.x.to(device, torch.float64).reshape(-1)
        e = float(torch.linalg.vector_norm(got - want)
                  / torch.linalg.vector_norm(want))
        err = e if err is None else max(err, e)
        del want, got
        if smp.factor is not None:
            system = _system(cfg, inputs, smp.slot, device)
            g = reference.factor_gap(
                system, by_direction(cfg["grid"], smp.factor), nb)
            gap = g if gap is None else max(gap, g)
            del system
    return {"x_error_max": err, "factor_gap_max": gap}


def control(cfg: dict, inputs: Inputs, device, dtype) -> dict:
    """The control (``benchmark/readings.py --control``): the reference in
    ``dtype`` in the program's place, x and factor of every slot of the
    pool, judged as the program's are."""
    opts = cfg["options"]
    nb, na = _sweeps(cfg)
    err, gap, iters = 0.0, 0.0, []
    for k in range(inputs.slots):
        system = _system(cfg, inputs, k, device)
        x, it = reference.bicgstab(system, dtype, nb, na,
                                   float(opts["rtol"]), int(opts["maxiter"]))
        iters.append(it)
        want = inputs.answer(k).to(device)
        err = max(err, float(torch.linalg.vector_norm(
            x.to(torch.float64).reshape(-1) - want)
            / torch.linalg.vector_norm(want)))
        gap = max(gap, reference.factor_gap(
            system, reference.factor_sweeps(system, nb, dtype), nb))
        del system, x, want
    return {"x_error_max": err, "factor_gap_max": gap, "iters": iters}


def stale(cfg: dict, inputs: Inputs, device) -> dict:
    """The stale-factor reading (``benchmark/readings.py --stale``):
    gaps[k][j] is slot k's system judged against the reference's float32
    factor of slot j's matrix (j = k: a sound factor, to rounding)."""
    nb, _ = _sweeps(cfg)
    factors = []
    for j in range(inputs.slots):
        system = _system(cfg, inputs, j, device)
        factors.append({d: t.float().cpu() for d, t in
                        reference.factor_sweeps(system, nb,
                                                torch.float32).items()})
        del system
    gaps = []
    for k in range(inputs.slots):
        system = _system(cfg, inputs, k, device)
        gaps.append([reference.factor_gap(system, f, nb) for f in factors])
        del system
    return {"gaps": gaps}
