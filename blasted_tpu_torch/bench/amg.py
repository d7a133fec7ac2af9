"""AMG-CG against single-level SGS-CG on the card: the counterpart of
``scripts/bench_amg.py``::

    python3 -m blasted_tpu_torch.bench.amg

The uniform Poisson system of ``BENCH_AMG_NPTS`` points a side (130: a
128³ interior, 2,097,152 rows) in float32 is solved by CG to
``BENCH_AMG_RTOL`` (1e-6) against numpy's ``default_rng(0)`` normal
right-hand side (the generator's b is an eigenvector of the stencil), once
with one V-cycle of the isotropic brick hierarchy
(``precond/multigrid.py::build_hierarchy`` through
``MultigridPreconditioner``, every level DIA on the card, coarse size 200)
and once with the single-level SGS of ``NS`` = 2 forward and backward
sweeps.  ``BENCH_AMG_SMOOTHER`` picks the level smoother: ``jacobi`` (the
default: damped Jacobi, ω = 1.4/ρ(D⁻¹A)), ``cheb`` (Chebyshev of degree 2)
or anything else (SGS of 2 sweeps), as in bench_amg.py.

Each solve is timed on the host clock ending in a synchronise, three times
after an untimed one; it reports iterations, the relative residual (the
solver's and the true one in float64), best and median seconds, ms per
iteration, its kernel launches and ``speedup_vs_sgs``.  The record goes to
the ``"amg"`` entry of ``chiprun_out/bench_torch_detail.json`` (never to
``bench_detail.json`` or ``perf/``) and to standard error; the last line of
standard output is a one-line summary.  The exit code is 1 when a solve did
not converge, 2 without a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..apps import poisson3d_system
from ..ops import _cuda
from ..ops.spmv import spmv
from ..precond.multigrid import AMGSettings, MultigridPreconditioner
from ..precond.sgs import SGSPreconditioner
from ..solvers import cg
from ..sparse.dia import DiaMatrix
from ..utils.timing import synchronize
from .common import (
    cpu_card,
    host_seconds,
    launched,
    require_card,
    write_detail,
)

__all__ = ["Settings", "bench_amg", "rehearse_on_cpu", "main"]

NS = 2                      # SGS sweeps each way (bench_amg.py:69)
COARSE_SIZE = 200
MAXITER = {"amg": 200, "sgs": 2000}
SAMPLES = 3
SMOOTHER_KINDS = {"jacobi": "jacobi", "cheb": "chebyshev"}


@dataclass(frozen=True)
class Settings:
    """bench_amg.py's knobs, defaults included."""

    npts: int = 130
    rtol: float = 1e-6
    smoother: str = "jacobi"

    @classmethod
    def from_env(cls, env=None) -> "Settings":
        env = os.environ if env is None else env
        d = cls()
        return cls(npts=int(env.get("BENCH_AMG_NPTS", d.npts)),
                   rtol=float(env.get("BENCH_AMG_RTOL", d.rtol)),
                   smoother=env.get("BENCH_AMG_SMOOTHER", d.smoother))


def bench_amg(s: Settings, device, card: dict) -> dict:
    """Both CG solves on ``device``; returns the ``"amg"`` record."""
    device = torch.device(device)
    A, _, _ = poisson3d_system((s.npts,) * 3, dist="uniform")
    A = A.astype(np.float32)
    kind = SMOOTHER_KINDS.get(s.smoother, "factory")
    synchronize(device)
    t0 = time.perf_counter()
    mg = MultigridPreconditioner(A, AMGSettings(
        grid_shape=(s.npts - 2,) * 3, coarse_size=COARSE_SIZE,
        smoother_kind=kind), device=device)
    mg.compute()
    synchronize(device)
    setup_s = time.perf_counter() - t0
    formats = [type(lev.A_dev).__name__ for lev in mg.levels]
    if any(f != "DiaMatrix" for f in formats):
        raise TypeError(f"the hierarchy fell off the DIA path: {formats}")
    D0: DiaMatrix = mg.levels[0].A_dev
    n = mg.levels[0].n
    levels = [lev.n for lev in mg.levels] + [int(mg._A_coarse.shape[0])]
    print(f"[amg] n={n} levels={levels} diags="
          f"{[lev.A_dev.ndiags for lev in mg.levels]} dtype={D0.dtype} "
          f"smoother={kind} set-up {setup_s:.3f} s", file=sys.stderr)

    rhs = np.random.default_rng(0).standard_normal(n)
    b = torch.as_tensor(rhs, dtype=D0.dtype, device=device)
    sgs = SGSPreconditioner(D0, napplysweeps=NS)
    sgs.compute()
    A_sp = A.to_scipy().astype(np.float64)
    b64 = b.double().cpu().numpy()
    results = {}
    for name, prec in (("amg", mg.apply), ("sgs", sgs.apply)):
        _cuda.reset_launches()

        def run():
            return cg(lambda v: spmv(D0, v), prec, b, torch.zeros_like(b),
                      tol=s.rtol, maxiter=MAXITER[name])

        times, (x, info) = host_seconds(run, device, SAMPLES)
        best = min(times)
        xh = x.double().cpu().numpy()
        results[name] = {
            "iters": info.iters, "converged": info.converged,
            "relres": info.resnorm / info.bnorm,
            "true_relres_f64": float(np.linalg.norm(A_sp @ xh - b64)
                                     / np.linalg.norm(b64)),
            "seconds": best, "median_seconds": float(np.median(times)),
            "samples": len(times),
            "ms_per_iter": best * 1e3 / max(info.iters, 1),
            "launches": launched()}
        print(f"{name}-cg: iters={info.iters} relres="
              f"{results[name]['relres']:.2e} solve={best * 1e3:.1f} ms "
              f"({results[name]['ms_per_iter']:.3f} ms/iter)",
              file=sys.stderr)
    return {"n": n, "npts": s.npts, "rtol": s.rtol, "smoother": s.smoother,
            "smoother_kind": kind, "levels": levels, "setup_seconds": setup_s,
            "amg_cg": results["amg"], "sgs_cg": results["sgs"],
            "speedup_vs_sgs": (results["sgs"]["seconds"]
                               / results["amg"]["seconds"]),
            "stamp": {"amg_npts": s.npts, "amg_rtol": s.rtol,
                      "amg_smoother": s.smoother, **card}}


def rehearse_on_cpu(s: Settings) -> dict:
    """Both solves on the CPU (no device number comes from this; nothing
    is written)."""
    return bench_amg(s, "cpu", cpu_card())


def main() -> int:
    s = Settings.from_env()
    card = require_card("amg")
    _cuda.kernels_library()
    entry = bench_amg(s, "cuda", card)
    write_detail({"amg": entry}, prefixes=("amg",))
    print(json.dumps(entry, indent=1, sort_keys=True), file=sys.stderr)
    ok = entry["amg_cg"]["converged"] and entry["sgs_cg"]["converged"]
    print(json.dumps({
        "amg_cg_iters": entry["amg_cg"]["iters"],
        "amg_cg_seconds": entry["amg_cg"]["seconds"],
        "sgs_cg_iters": entry["sgs_cg"]["iters"],
        "sgs_cg_seconds": entry["sgs_cg"]["seconds"],
        "speedup_vs_sgs": entry["speedup_vs_sgs"], "converged": ok}),
        flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
