#!/usr/bin/env python3
"""What float32 lets the bench's end-to-end solve reach, from the JAX side.

Runs ``bench.py::bench_solve`` (BiCGSTAB + DIA-ILU(0) 8,4 to rtol 1e-5 on
the uniform npts³ Poisson system) in float32 on the CPU, and prints, for
each npts given, one JSON line: its iterations, its recursive relative
residual, the true relative residual of its x in float64, and the float32
floor, the true relative residual of the system's exact solution rounded to
float32.  The generator's right-hand side is an eigenvector of the matrix
(``12π² sin 2πx sin 2πy sin 2πz``), so the exact solution is b/λ with
λ = bᵀAb / bᵀb.  ``main()`` of bench.py, which writes
``bench_detail.json``, is not called.  Run from the root of a checkout::

    JAX_PLATFORMS=cpu python3 scripts/solve_f32_witness.py 34 66 162

It is the JAX reading beside which ``blasted_tpu_torch.bench.roofline``'s
float32 solve bound (``RELRES_FACTOR``) is set.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("BENCH_REPS", "4")        # bench_solve: 2 timed solves

import jax                                      # noqa: E402
import jax.numpy as jnp                         # noqa: E402
import numpy as np                              # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from blasted_tpu.apps import poisson3d_system   # noqa: E402


def reading(npts: int) -> dict:
    os.environ["BENCH_NPTS"] = str(npts)
    spec = importlib.util.spec_from_file_location("_bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    n = (npts - 2) ** 3
    seen = []
    real_sum = jnp.sum

    def spy(a, *args, **kw):            # bench_solve's checksum of x
        if isinstance(a, jax.Array) and not isinstance(a, jax.core.Tracer) \
                and a.shape == (n,):
            seen.append(np.asarray(a))
        return real_sum(a, *args, **kw)

    jnp.sum = spy
    try:
        bench.bench_solve()
    finally:
        jnp.sum = real_sum
    got = bench.DETAIL["solve_bicgstab_diailu0"]
    A, b, _ = poisson3d_system((npts,) * 3, dist="uniform")
    S = A.astype(np.float32).to_scipy().astype(np.float64)
    nb = np.linalg.norm(b)
    x = seen[-1]
    lam = float(b @ (S @ b)) / float(b @ b)
    exact32 = (b / lam).astype(np.float32).astype(np.float64)
    return {"npts": npts, "n": n, "dtype": str(x.dtype),
            "iters": got["iters"], "converged": got["converged"],
            "relres": got["relres"], "tol": got["tol"],
            "true_relres_f64": float(np.linalg.norm(S @ x - b) / nb),
            "f32_floor": float(np.linalg.norm(S @ exact32 - b) / nb),
            "jax": jax.__version__, "backend": jax.default_backend()}


if __name__ == "__main__":
    for arg in sys.argv[1:] or ["34"]:
        print(json.dumps(reading(int(arg))), flush=True)
