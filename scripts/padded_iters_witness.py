#!/usr/bin/env python3
"""How far BiCGSTAB's iteration count on the padded path moves with the
summation order of the padded products alone, on the CPU.

Solves the uniform 8³ Poisson system (``tests/test_torch_apps.py``'s
testsolve fixture) with padded ILU(0) and BiCGSTAB to rtol 1e-10 for
several (factor, apply) sweep counts, three ways: the JAX package (jit,
XLA's order), the port (its twins, which sum each row's slots in order from
the first product, as K9/K10 do on the card), and the port with the row
sums taken by ``torch.sum`` instead (the order of the padded products
before K9/K10).  Prints one JSON line per sweep setting: each way's
iterations and final relative residual, and the residual history of each
every three steps.  Run from the root of a checkout::

    JAX_PLATFORMS=cpu python3 scripts/padded_iters_witness.py

With one factor sweep the three histories agree to about 1e-9 for the
first steps and then spread, so the counts differ by a few steps (1,1: JAX
32, the port 34, the torch.sum order 32; 1,2: 36, 34, 33); with two or
more factor sweeps they agree.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
jax.config.update("jax_enable_x64", True)

from blasted_tpu import api as japi                       # noqa: E402
from blasted_tpu.sparse.csr import CSRMatrix as JaxCSR    # noqa: E402
from blasted_tpu_torch import api                         # noqa: E402
from blasted_tpu_torch.apps import poisson3d_system       # noqa: E402
from blasted_tpu_torch.ops import padded                  # noqa: E402
from blasted_tpu_torch.sparse.csr import extend_zero, take  # noqa: E402

SWEEPS = ("1,1", "1,2", "2,1", "2,2", "2,3", "3,3")


def torch_sum_products(vals, col, x):
    """The padded products with each row summed by ``torch.sum``."""
    xg = take(extend_zero(x), col.long())
    if vals.dim() == 2:
        return (vals * xg).sum(1)
    return (vals * xg.unsqueeze(-2)).sum(-1).sum(1)


def main() -> None:
    A, b, _ = poisson3d_system((8, 8, 8), "uniform")
    Aj = JaxCSR.from_arrays(A.rowptr, A.colind, A.vals)
    in_order = padded.padded_products

    def run(way, opts):
        if way == "jax":
            info = japi.solve(Aj, jnp.asarray(b), opts)[1]
            return int(info.iters), float(info.resnorm / info.bnorm)
        padded.padded_products = in_order if way == "port" \
            else torch_sum_products
        try:
            info = api.solve(A, b, opts, device="cpu")[1]
        finally:
            padded.padded_products = in_order
        return info.iters, info.resnorm / info.bnorm

    for sweeps in SWEEPS:
        opts = {"blasted_pc_type": "ilu0", "blasted_async_sweeps": sweeps,
                "prefer_dia": False, "ksp_type": "bicgstab", "rtol": 1e-10,
                "maxiter": 500}
        rec = {"sweeps": sweeps}
        for way in ("jax", "port", "port_torch_sum"):
            iters, relres = run(way, opts)
            history = [run(way, dict(opts, maxiter=k))[1]
                       for k in range(1, iters + 1, 3)]
            rec[way] = {"iters": iters, "relres": relres,
                        "history_every_3": history}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
