#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``blasted_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``blasted_tpu_torch/csrc`` (K1-K4 of the
scalar banded path, K5, K6 and the block inverse of the point-block path)
and checks each against its plain PyTorch twin on the card: K1-K4 at the
shapes of the scalar main path (the npts=162 band in float32) and at npts=48
in float64; K5, both modes of K6 and the block inverse at bs=4 on the g=128
block band in float32 (the block main path's shapes), at bs=5, g=96 in
float32 and at bs=4, g=24 in float64.  At the main-path shapes it times
each kernel, its twin and, where one PyTorch call computes the same
function, that call.  ``[bench]`` then runs every section of the port's
roofline bench (``blasted_tpu_torch/bench/roofline.py``) cut in size
(``BENCH_SMOKE``: scalar g=240, bs=4 at g=96, bs=5 at g=80, each past
4× the L2, the padded CSR at g=64, the solve at npts=66; 14 chained
iterations, best of 2): each section holds each of its kernels against
its twin on the section's own operands before timing it, no section may
fail, each kernel section must launch its kernels, every fraction must lie
in (0, 1.05] and the bench's JSON line must parse.  It then drives both main paths through
``blasted_tpu_torch.api.solve`` on the default device:

- scalar: the 160³ Poisson system in float32, ILU(0) 8,4 (bench.py's
  factor: below JAX's halo gate the factor route is plain, so no K3/K4)
  and BiCGSTAB; ``[mixed]`` the same with ``-blasted_apply_dtype bfloat16``
  (the apply's plain shifted products, no K2); ``[main-compressed]`` the
  288³ band built on the card, past JAX's gate in float32, through
  ``setup_local_preconditioner``, ``compute_preconditioner`` (K3 four
  times, K4 once at ILU(0) 4,4) and BiCGSTAB;
- block: a random bs=4 block system on the 7-point band of a 128³ block
  grid (nb = 2,097,152, n = 8,388,608) in float32, block ILU(0) 4,4 and
  BiCGSTAB;

checks each true residual and that each solve launched its own kernels and
none of the other path's, re-factors and re-solves for steady-state times,
and solves each system's small float64 form on the card and on the CPU
twins and requires the same iteration count and solution.

Then the general (padded) path, which has no hand-written kernel: its
gathers are torch operations.  ``[padded-main]`` and ``[padded-block-main]``
solve the same two host systems with ``prefer_dia: False`` (padded CSR/BSR,
ILU(0) ``async_sweeps 8,4``, the scalar path's factor) and require
convergence, no
launch of K1-K6 and, for the scalar system, the banded path's iteration
count within one; each prints its host set-up, factor and solve seconds
and the device µs of one padded SpMV, one factor sweep and one apply beside
their byte bounds and the SpMV's ``torch.mv`` on the CUDA CSR/BSR tensor.
``[tf32]`` requires one padded block SpMV and one block factor sweep to be
bitwise equal with TF32 matmuls allowed and not.
``[padded-device-independence]`` solves small float64 systems on the card
and on the CPU (padded ILU(0), exact ILU(0) and Jacobi, the default
options, block ILU(0), and two randomly permuted systems through the RCM
route: one that RCM bands into 105 diagonals, solved on DIA through K1-K4,
and one it cannot band, solved on padded CSR) and requires the route each
must take, the same iterations and x within 1e-8.  ``[io]`` writes the
[main] system with the PETSc binary writer, reads it back and solves it
through ``apps.testsolve`` on the card ([main]'s iterations), and round-
trips a 32³ Matrix-Market file.

Then the rest of the solver stack, which adds no kernel: it runs K1-K5
around torch operations.  ``[krylov-main]`` solves the [main] matrix at
full width (160³, float32, DIA) with a seeded right-hand side (see
``seeded_poisson``) by GMRES(30) and GCR(30) with ILU(0) 4,4, CG with
Jacobi and BiCGSTAB with SGS 1,2, GS and CSC-BGS, then the [block-main]
system by BiCGSTAB with block SGS (block-DIA); ``[amg-main]`` solves the
same scalar system with AMG (group 4, V cycle, SGS smoother) under CG and
Richardson.  Each must converge to rtol 1e-5 with the true relative
residual at most 1.1·rtol, repeat its iterations, and launch its own
kernels: K1-K4 with ILU(0), K1 alone otherwise, K5 alone on the block
system; AMG's levels must all be DIA in float32.  ``[level-sgs]`` (64³:
one masked update per level) and ``[sai]`` (scalar 64³, block bs=4 g=48:
the host symbolic tables) are cut in size, as their docstrings say.
``[tf32]`` then holds one block SAI compute and one AMG apply bitwise
equal with TF32 matmuls allowed and not; ``[precinfo]`` the DIA,
block-DIA and padded ILU(0) diagnostics of small float64 systems, card
against CPU, within 1e-10; ``[stack-device-independence]`` every new
ksp_type and pc_type (AMG and the MC64-reordered ILU(0) included) on
small float64 systems, card against CPU: the route, the same iterations,
x within 1e-8.  ``[newton]`` runs the value-update workflow (solve,
perturb the band values, ``update_values``, ``compute_preconditioner``,
solve) on the seeded 160³ system and the block system with FactInit
ORIGINAL and NONE; ``[refined]`` ``solve_refined`` (float32 on the card,
float64 on the host) to 1e-10.

Then the distributed solvers (``blasted_tpu_torch.parallel``), on four
subdomains of the one card (``make_mesh(devices=["cuda:0"] * 4)``), which
add no kernel: the banded ones launch K1/K2 or K5/K6/the inverse once per
shard.  ``[dist-block-main]`` solves the [block-main] system over four
shards (the compressed block factor: K6 and two inverses per shard, K5
once per shard per SpMV); ``[dist-main]`` the [krylov-main] system with
ILU(0) 4,4 over four shards and over one (K1 once per shard per SpMV, K2
eight times per shard per apply, no K3/K4), with steady factor and solve
times; ``[dist-modes]`` the six modes of the distributed dry run
(``parallel/dryrun.py``), the banded ones at full width and the others
cut (the reasons printed), each asserting its route and its kernels, and
one distributed AMG cycle under [tf32]; ``[dist-device-independence]``
each mode, each banded pc_type and one R3 type (sai, the general route)
in float64 on four card shards and four CPU shards: the route, the same
iterations, x within 1e-8.  After ``[dist-main]``, ``[dist-block-main]``
and the banded ``[dist-modes]`` (on their uneven last shard) each kernel
of the route is held bitwise to its twin on one shard's own band and
state, at the shape the route gives it (``shard_twins``).  Each phase
prints its elapsed seconds.

With ``--cards 4`` (on a machine with four cards, one command of about
three minutes) it runs ``[build]`` and, instead of the phases above, the
distributed path across the cards, one shard per card of ``make_mesh()``
(cuda:0 ... cuda:3), each time taken after synchronising every card:
``[mc-topology]`` (``nvidia-smi topo -m``, peer access of every pair, the
device time of one halo-sized copy, 25,600 f32, and of one 0-d copy from
cuda:3 to cuda:0); ``[mc-kernel]`` every kernel on every card at the f32
shapes of ``[kernel]``, cut to those (K3/K4 at 160³, not also 288³; no
f64 or bs = 5 checks: they show nothing a card adds), held bitwise to its
twin and counted on that card only, timed on each card (its twin and
library call on the first only), then one call on cuda:2 operands with
cuda:0 current (counted on card 2) and calls across two cards (must
raise); ``[mc-dist-main]`` [dist-main]'s system over the four cards, over
four shards of cuda:0 and over one shard, and ``[mc-dist-block-main]``
[dist-block-main]'s over the cards and over four shards of cuda:0: the
cards' x and iterations equal to the bit to one card's, each card
launching its own shard's kernels, ``shard_twins`` on shard 3 (cuda:3),
each card's peak memory; ``[mc-weak]`` the seeded uniform Poisson system
of interior 160 × 160 × 640 over the cards (a 160³ slab, [main]'s size,
on each; not cut); ``[mc-dist-modes]`` the six dry-run modes at
[dist-modes]' sizes (its cuts, for its reasons) over the cards, mode 6 on
a (2, 2) mesh, and over four shards of cuda:0.  None of the one-card
phases runs: they show nothing a second card adds, and four cards cost
four times the chip time.  It ends with the kernels line (launches of the
four-card solves of [mc-dist-main], [mc-dist-block-main] and [mc-weak],
in all and by card; K3/K4 none, the distributed scalar factor is plain),
one ``nvidia-smi`` line per card and the last line.  With fewer than four
cards it exits with code 2 before any phase.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's ``nvidia-smi`` name and power limit; the one
before that is the per-kernel JSON record.  Any failure exits non-zero
before printing the last line.  Without a CUDA device the script exits
with code 2.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from blasted_tpu_torch import native, solvers
from blasted_tpu_torch.api import (
    compute_preconditioner,
    setup_local_preconditioner,
    solve,
    solve_refined,
)
from blasted_tpu_torch.apps import poisson3d_system, testsolve
from blasted_tpu_torch.bench import common as bench_common
from blasted_tpu_torch.bench import roofline
from blasted_tpu_torch.config import AsyncSolverSettings, FactInit, PrecType
from blasted_tpu_torch.factory import create_preconditioner, to_device_matrix
from blasted_tpu_torch.ops import _cuda, bstencil, stencil
from blasted_tpu_torch.ops.spmv import bspmv, spmv
from blasted_tpu_torch.parallel import make_mesh, shard_vector
from blasted_tpu_torch.parallel.dist_dia import DistBlockDiaSolver
from blasted_tpu_torch.parallel.dryrun import dryrun_cases, dryrun_multichip
from blasted_tpu_torch.precond.dia_ilu0 import (
    DiaILU0Preconditioner,
    dia_pairs,
)
from blasted_tpu_torch.precond.reordering import (
    MaxMatchingReordering,
    ReorderedILU0Preconditioner,
)
from blasted_tpu_torch.sparse import (
    BSRMatrix,
    COOMatrix,
    CSRMatrix,
    DiaMatrix,
    read_matrix_market,
    read_petsc_matrix,
    read_petsc_vector,
    write_matrix_market,
    write_petsc_matrix,
    write_petsc_vector,
)
from blasted_tpu_torch.sparse.bdia import shift_last
from blasted_tpu_torch.sparse.dia import shift_read

# the TPU kernel each one replaces: file:line of its pallas_call (the block
# inverse: the elimination XLA ran outside the kernels)
REPLACES = {
    "dia_spmv": "blasted_tpu/ops/stencil.py:221",
    "tri_sweep": "blasted_tpu/ops/stencil.py:295",
    "factor_u0": "blasted_tpu/ops/stencil.py:383",
    "factor_lower": "blasted_tpu/ops/stencil.py:436",
    "bspmv": "blasted_tpu/ops/bstencil.py:242",
    "bfactor_dinv": "blasted_tpu/ops/bstencil.py:448",
    "bfactor_u0": "blasted_tpu/ops/bstencil.py:448",
    "block_inverse": "blasted_tpu/ops/bstencil.py:284",
}
# max |kernel − twin| / max |twin|: the kernels are built to round as their
# twins do, so these bounds only allow for a different summation order
TOL = bench_common.TWIN_RTOL
# the bench's solve (bench.py:640-647): ILU(0) with 8 plain factor sweeps
# and 4 apply sweeps; below JAX's halo gate the port's factor is plain too
# (R4), so [main] computes bench.py's factor, the one PADDED_OPTS gives the
# padded path
MAIN_OPTS = {"blasted_pc_type": "ilu0", "blasted_async_sweeps": "8,4",
             "ksp_type": "bicgstab", "rtol": 1e-5, "maxiter": 800}
PADDED_OPTS = dict(MAIN_OPTS, prefer_dia=False)
# the block and distributed phases keep ILU(0) 4,4 (their earlier records)
ILU44_OPTS = dict(MAIN_OPTS, blasted_async_sweeps="4,4")
MAIN_NPTS = 162          # the bench's solve: 160³ = 4,096,000 unknowns
MAIN_RELRES = 1e-4       # true-residual bound: f32 working precision
CHECK_NPTS = 48          # the float64 device-independence solves
CHEB_ITERS_TOL = 5       # the Chebyshev case: about 10 % of its 41-44
BLOCK_BS, BLOCK_G = 4, 128   # the bench's block size and grid (bench.py:366)
BLOCK_CHECK_G = 24           # the float64 block device-independence solve
TIMING_REPS = 25
BATCH = 10
MAX_ENQUEUE_MS = 2.0     # host time of one timed batch, at most
# a sleep kernel of at least this many cycles (about 50 ms at the H100's
# 1.98 GHz) holds the card while the host enqueues one timed batch
SLEEP_CYCLES = 100_000_000
CYCLES_PER_MS = 1_980_000
HBM_GBPS = 3350.0        # H100 SXM device memory, NVIDIA's data sheet
# H100 SXM peak rates outside the tensor cores, NVIDIA's data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# the rest of the solver stack: rtol and the true-residual bound, 1.1·rtol
KRYLOV_RTOL = 1e-5
KRYLOV_RELRES = 1.1 * KRYLOV_RTOL
X_REF_SEED = 17
# ILU(0) on the 160³ band: K1 and K2; its factor is plain (R4)
ILU_KERNELS = {"dia_spmv": None, "tri_sweep": None}
# [krylov-main]: (label, options, kernels the solve must launch)
KRYLOV_CASES = [
    ("gmres+ilu0", {"ksp_type": "gmres", "restart": 30,
                    "blasted_pc_type": "ilu0",
                    "blasted_async_sweeps": "4,4"}, ILU_KERNELS),
    ("gcr+ilu0", {"ksp_type": "gcr", "restart": 30,
                  "blasted_pc_type": "ilu0",
                  "blasted_async_sweeps": "4,4"}, ILU_KERNELS),
    ("cg+jacobi", {"ksp_type": "cg", "blasted_pc_type": "jacobi"},
     {"dia_spmv": "cg"}),
    ("bicgstab+sgs", {"ksp_type": "bicgstab", "blasted_pc_type": "sgs",
                      "blasted_async_sweeps": "1,2"},
     {"dia_spmv": "bicgstab"}),
    ("bicgstab+gs", {"ksp_type": "bicgstab", "blasted_pc_type": "gs"},
     {"dia_spmv": "bicgstab"}),
    ("bicgstab+cscbgs", {"ksp_type": "bicgstab",
                         "blasted_pc_type": "cscbgs"},
     {"dia_spmv": "bicgstab"}),
]
AMG_OPTS = {"blasted_pc_type": "amg", "blasted_amg_group": 4,
            "blasted_amg_cycle": "v", "blasted_amg_sub_pc_type": "sgs"}
CUT_NPTS = 66            # [level-sgs] and scalar [sai]: 64³ = 262,144
SAI_BLOCK_G = 48         # block [sai]: bs = 4 on the g = 48 block band
STACK_NPTS = 14          # [stack-device-independence]: 12³ Poisson
STACK_BLOCK_G = 12       # and the bs = 4, g = 12 block band
# the distributed phases: four subdomains on the one card
DIST_SHARDS = 4
# [dist-modes]: the banded modes at full width (161³ = 4,173,281 rows and
# 2,097,153 block rows: neither divides by 4, so both identity-pad), the
# others cut (CUTS says why)
DIST_MODE_SIZES = {"npoints": (MAIN_NPTS + 1,) * 3,
                   "block_nb": BLOCK_G ** 3 + 1,
                   "ghost_npoints": (49,) * 3, "bsr_nb": 8 * DIST_SHARDS,
                   "amg_npoints": (25,) * 3}
CUTS = {
    "ghost-csr": "47³ = 103,823 rows (uneven): the general path's padded "
                 "ILU(0) runs a host symbolic pass (8-11 s at 160³, PR 3); "
                 "the mode shows the ghost exchange's route",
    "bsr-allgather": "32 block rows: a dense coupling's stored blocks grow "
                     "as nb² (density 0.15)",
    "amg": "23³ = 12,167 rows: two levels leave a dense coarse matrix of "
           "n/8 rows, factored by LU",
}
# [dist-device-independence]: the modes at 11³ = 1,331 rows (uneven),
# 50 block rows, in float64 to rtol 1e-8
DIST_CHECK_SIZES = {"npoints": (13,) * 3, "block_nb": 50}
# [main-compressed]: the 7-point band of a 288³ grid (n = 23,887,872), past
# JAX's halo gate in float32, so the factor takes the compressed K3/K4
# route (R4); ILU(0) 4,4: K3 four times, K4 once per factor
COMPRESSED_G = 288
# [newton]: JAX tests/test_update.py::_perturbed_vals's seed and scale,
# one draw per matrix row (``perturbed``)
NEWTON_SEED, NEWTON_SCALE = 99, 0.05
NEWTON_OPTS = dict(MAIN_OPTS, rtol=KRYLOV_RTOL)
# [refined]: the f64 target and the refinement passes allowed (nrefine + 1)
REFINED_RTOL, REFINED_NREFINE = 1e-10, 3
# [io]: Matrix-Market text round trip, cut to 32³ (MM_NPTS − 2)
MM_NPTS = 34
# [bench]: the roofline bench's sections cut in size (the full sizes run
# as their own command, ``python3 -m blasted_tpu_torch.bench.roofline``),
# each kernel section's data still past 4× the 50 MB L2 (7-8×): at
# g = 160 / 64 / 48, 1.5-2.2× L2, the chained kernels hit in L2 and K3,
# K5 and K6 read 1.01-1.14 of the H100's spec bandwidth; the padded CSR
# at g = 64 and the solve at 64³
BENCH_SMOKE = roofline.Settings(i2=14, reps=2, scalar_g=240, block_g4=96,
                                block_g5=80, csr_g=64, npts=66)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def bound(nbytes: float, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for the type."""
    t_bytes = nbytes / (HBM_GBPS * 1e9) * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gj_flops(bs: int) -> int:
    """Floating-point operations of one pivoted Gauss–Jordan inverse as
    ``gj_inverse_rows`` runs it on the augmented [A | I] (the pivot-row sum,
    the reciprocal, the row scaling and the eliminations)."""
    w = 2 * bs
    return sum(w * (bs - col) + 1 + w + (bs - 1) * 2 * w for col in range(bs))


def band_mask(g: int, device):
    """The structural mask (7, g³) of the 7-point band (offsets ±1, ±g, ±g²)
    of a g³ grid, and its offsets."""
    n = g ** 3
    idx = torch.arange(n, device=device)
    i0, j0, k0 = idx % g, (idx // g) % g, idx // (g * g)
    full = torch.ones(n, dtype=torch.bool, device=device)
    mask = torch.stack([k0 > 0, j0 > 0, i0 > 0, full,
                        i0 < g - 1, j0 < g - 1, k0 < g - 1])
    return (-g * g, -g, -1, 0, 1, g, g * g), mask


def band_operands(g: int, dtype, device, seed: int):
    """Operands of K1-K4 on the 7-point band of a g³ grid (offsets ±1, ±g,
    ±g²): random coefficients, a dominant diagonal, zeros outside the
    structural mask, and a few exact zeros in u0 to exercise the guard."""
    n = g ** 3
    offsets, mask = band_mask(g, device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    data = 0.25 * randn(7, n)
    data[3] += 14.0
    data = torch.where(mask, data, torch.zeros_like(data))
    u0 = data[3].clone()
    u0[::997] = 0.0
    lower_offs = offsets[:3]
    return {
        "offsets": offsets, "mask": mask, "data": data, "x": randn(n),
        "y": randn(n), "rhs": randn(n), "dinv": 1.0 / data[3], "u0": u0,
        "lower_offs": lower_offs, "base_l": data[:3].contiguous(),
        "ubs": torch.stack([data[6 - j] for j in range(3)]),
    }


def block_operands(g: int, bs: int, dtype, device, seed: int):
    """Operands of K5, K6 and the block inverse on the 7-point block band of
    a g³ block grid (bench.py:398-418): entries 0.25·N(0,1) inside the
    structural mask, 2k = 14 added to the diagonal of each diagonal block;
    a few all-zero diagonal blocks (zero pivots, the guard) and a diagonal
    mask with a few false rows (identity blocks) for the block inverse.
    K6 reads the three pair lowers, their uppers pre-shifted by the pair
    offset, and the inverse of the diagonal."""
    nb, b2 = g ** 3, bs * bs
    offsets, mask = band_mask(g, device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    data = 0.25 * randn(7, b2, nb)
    data[3, [i * bs + i for i in range(bs)]] += 14.0
    data = torch.where(mask[:, None], data, torch.zeros_like(data))
    u0 = data[3].clone()
    u0[:, ::997] = 0.0
    dmask = torch.arange(nb, device=device) % 1013 != 0
    return {
        "offsets": offsets, "mask": mask, "data": data,
        "x": randn(nb, bs), "u0": u0, "dmask": dmask,
        "pair_offs": offsets[:3], "base0": data[3], "base_l": data[:3],
        "ubs": torch.stack([shift_last(data[6 - p], offsets[p])
                            for p in range(3)]),
        "dinv": bstencil.block_inverse_ref(data[3]),
    }


def csr_of_band(offsets, data, mask, lower_only=False):
    """The band as a CUDA sparse CSR tensor (the library yardstick's
    operand): the structural entries of ``data`` (k, n), row by row."""
    sel = [d for d, o in enumerate(offsets) if o < 0 or not lower_only]
    m = mask[sel].t()                              # (n, k') by row
    rows, ds = m.nonzero(as_tuple=True)
    offs = torch.tensor(offsets, device=data.device)[sel]
    crow = torch.zeros(m.shape[0] + 1, dtype=torch.int64, device=data.device)
    crow[1:] = torch.cumsum(m.sum(1), 0)
    return torch.sparse_csr_tensor(crow, rows + offs[ds],
                                   data[sel][ds, rows], size=(m.shape[0],) * 2)


def bsr_of_band(offsets, data, mask):
    """The block band as a CUDA sparse BSR tensor (blocksize bs) of the
    structural blocks of ``data`` (k, bs², nb)."""
    k, b2, nb = data.shape
    bs = int(round(b2 ** 0.5))
    m = mask.t()
    rows, ds = m.nonzero(as_tuple=True)
    crow = torch.zeros(nb + 1, dtype=torch.int64, device=data.device)
    crow[1:] = torch.cumsum(m.sum(1), 0)
    cols = rows + torch.tensor(offsets, device=data.device)[ds]
    vals = data[ds, :, rows].reshape(-1, bs, bs)
    return torch.sparse_bsr_tensor(crow, cols, vals, size=(nb * bs,) * 2)


def kernel_cases(op):
    """(name, kernel call, twin call) for each scalar kernel; K2 is checked
    as the unit-lower and the upper sweep, and timed on the upper sweep."""
    offs, data = op["offsets"], op["data"]
    lo, up = offs[:3], offs[4:]
    return {
        "dia_spmv": [(lambda: stencil.dia_spmv_stencil(offs, data, op["x"]),
                      lambda: stencil.dia_spmv_ref(offs, data, op["x"]))],
        "tri_sweep": [
            (lambda: stencil.tri_sweep_stencil(lo, data[:3], op["rhs"], op["y"]),
             lambda: stencil.tri_sweep_ref(lo, data[:3], op["rhs"], op["y"])),
            (lambda: stencil.tri_sweep_stencil(up, data[4:], op["rhs"], op["y"],
                                               op["dinv"]),
             lambda: stencil.tri_sweep_ref(up, data[4:], op["rhs"], op["y"],
                                           op["dinv"])),
        ],
        "factor_u0": [(
            lambda: stencil.factor_u0_stencil(op["lower_offs"], data[3],
                                              op["base_l"], op["ubs"], op["u0"]),
            lambda: stencil.factor_u0_ref(op["lower_offs"], data[3],
                                          op["base_l"], op["ubs"], op["u0"]))],
        "factor_lower": [(
            lambda: stencil.factor_lower_stencil(op["lower_offs"], op["base_l"],
                                                 op["u0"]),
            lambda: stencil.factor_lower_ref(op["lower_offs"], op["base_l"],
                                             op["u0"]))],
    }


def block_kernel_cases(op):
    """(name, kernel call, twin call) for K5, K6 in each mode and the block
    inverse."""
    offs, data, po = op["offsets"], op["data"], op["pair_offs"]
    fac = (po, op["base0"], op["base_l"], op["ubs"], op["dinv"])
    return {
        "bspmv": [(lambda: bstencil.bdia_spmv_stencil(offs, data, op["x"]),
                   lambda: bstencil.bdia_spmv_ref(offs, data, op["x"]))],
        "bfactor_dinv": [(lambda: bstencil.bdia_factor_stencil(*fac, True),
                          lambda: bstencil.bdia_factor_ref(*fac, True))],
        "bfactor_u0": [(lambda: bstencil.bdia_factor_stencil(*fac, False),
                        lambda: bstencil.bdia_factor_ref(*fac, False))],
        # checked with zero pivots and identity rows, timed on the
        # nonsingular diagonal under the main path's full diagonal mask
        "block_inverse": [
            (lambda: bstencil.bdia_block_inverse(op["u0"], op["dmask"]),
             lambda: bstencil.block_inverse_ref(op["u0"], op["dmask"])),
            (lambda: bstencil.bdia_block_inverse(op["base0"], op["mask"][3]),
             lambda: bstencil.block_inverse_ref(op["base0"], op["mask"][3]))],
    }


def cuda_ms(fn) -> tuple[float, float]:
    """(device ms, host ms) per call, medians over TIMING_REPS samples.

    A sample enqueues a sleep kernel, a start event, a batch of calls and an
    end event.  The card sleeps until the host has enqueued the whole batch,
    so the events time the calls' device work back to back, without the
    host's per-call cost (wrapper checks, allocation, launch); that cost is
    the second number, the host clock around the enqueue.  A plain twin
    launches hundreds of kernels per call, and a sleeping card that holds
    more than about a thousand pending launches blocks the host, so the
    batch (at most BATCH calls) and the sleep are sized from the host time
    of one untimed call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    one_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    batch = max(1, min(BATCH, int(MAX_ENQUEUE_MS / one_ms)))
    sleep = max(SLEEP_CYCLES, int(4 * one_ms * batch * CYCLES_PER_MS))
    dev, host = [], []
    for _ in range(TIMING_REPS):
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        slept.record()
        torch.cuda._sleep(sleep)
        start.record()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms >= slept.elapsed_time(start):
            fail(f"the host took {host_ms} ms to enqueue a batch, longer "
                 "than the card slept: the device time would include gaps")
        dev.append(start.elapsed_time(end) / batch)
        host.append(host_ms / batch)
    return statistics.median(dev), statistics.median(host)


def compare(name: str, label: str, cases, dtype) -> dict:
    """Each (kernel, twin) pair of ``cases`` on the same inputs."""
    err = rel = 0.0
    for kernel, twin in cases:
        got, want = kernel(), twin()
        torch.cuda.synchronize(got.device)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{name}: shape {tuple(got.shape)} or non-finite values")
        e = float((got - want).abs().max())
        err = max(err, e)
        rel = max(rel, e / float(want.abs().max()))
    if rel > TOL[dtype]:
        fail(f"{name} {label}: relative error {rel} > {TOL[dtype]}")
    return {"max_abs_err": err, "rel_err": rel}


def timed(rec: dict, kernel, twin, nbytes: float, flops: float, dtype,
          library=None) -> None:
    """Add the kernel's, the twin's and the library call's device times and
    the kernel's bound to ``rec``."""
    rec["ms"], rec["host_ms"] = cuda_ms(kernel)
    rec["plain_ms"], rec["plain_host_ms"] = cuda_ms(twin)
    rec["library_ms"] = None if library is None else cuda_ms(library)[0]
    rec.update(bound(nbytes, flops, dtype))
    rec["gbps"] = nbytes / 1e9 / (rec["ms"] / 1e3)
    rec["hbm_share"] = rec["gbps"] / HBM_GBPS
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def scalar_work(name: str, n: int, isz: int) -> tuple:
    """(bytes, operations) of one timed call of a scalar kernel: the least
    traffic in (n,) streams — K1 7 diagonals + x + y; K2's upper sweep 3
    diagonals + rhs + dinv + y + out; K3 base0 + 3 lowers + 3 pre-shifted
    uppers + u0 + out; K4 3 lowers + u0 + 3 outputs — and its operations
    per row."""
    streams, flops = {"dia_spmv": (9, 2 * 7), "tri_sweep": (7, 2 * 3 + 1),
                      "factor_u0": (9, 3 * 3), "factor_lower": (7, 3)}[name]
    return streams * n * isz, flops * n


def block_work(name: str, nb: int, bs: int, npair: int, isz: int) -> tuple:
    """(bytes, operations) of one timed call of K5, K6 or the inverse."""
    b2 = bs * bs
    contraction = npair * (2 * b2 * (2 * bs - 1) + b2)
    return {
        "bspmv": ((7 * b2 + 2 * bs) * nb * isz, 2 * 7 * b2 * nb),
        "bfactor_dinv": ((b2 * (1 + 2 * npair) + 2 * b2) * nb * isz,
                         (contraction + gj_flops(bs)) * nb),
        "bfactor_u0": ((b2 * (1 + 2 * npair) + 2 * b2) * nb * isz,
                       contraction * nb),
        "block_inverse": (2 * b2 * nb * isz + nb, gj_flops(bs) * nb),
    }[name]


def scalar_library(name: str, op):
    """The one PyTorch call computing K1's function (``torch.mv`` on the
    CUDA CSR band), else None; K2's is timed by ``lower_timed``."""
    if name != "dia_spmv":
        return None
    csr = csr_of_band(op["offsets"], op["data"], op["mask"])
    return lambda: torch.mv(csr, op["x"])


def lower_timed(rec: dict, op, lower_kernel, n: int, dtype) -> None:
    """No single library call computes K2's upper sweep; one computes the
    unit-lower sweep rhs − L·y (3 diagonals + rhs + y + out), timed beside
    that sweep of the kernel."""
    low = csr_of_band(op["offsets"], op["data"], op["mask"], lower_only=True)
    rec["lower_ms"] = cuda_ms(lower_kernel)[0]
    rec["lower_bound_ms"] = bound(6 * n * dtype.itemsize, 2 * 3 * n,
                                  dtype)["bound_ms"]
    rec["library_ms"] = cuda_ms(lambda: torch.addmv(
        op["rhs"], low, op["y"], alpha=-1))[0]
    rec["library_of"] = "unit-lower sweep (lower_ms)"


def block_library_of(name: str, op):
    """The one PyTorch call computing K5's or the inverse's function, else
    None."""
    make = {"bspmv": block_library, "block_inverse": inverse_library}.get(name)
    return make and make(op)


def check_kernels(g: int, dtype, seed: int, timed_names=()) -> dict:
    """Each scalar kernel against its twin on the card, the kernels named
    in ``timed_names`` also timed; returns per-kernel {max_abs_err, rel_err[,
    times and bound]}."""
    op = band_operands(g, dtype, "cuda", seed)
    n, isz = g ** 3, dtype.itemsize
    out = {}
    for name, cases in kernel_cases(op).items():
        rec = compare(name, f"g={g} {dtype}", cases, dtype)
        rec["shape"] = f"g={g} n={n} {str(dtype)[6:]}"
        if name in timed_names:
            kernel, twin = cases[-1]
            timed(rec, kernel, twin, *scalar_work(name, n, isz), dtype,
                  scalar_library(name, op))
            if name == "tri_sweep":
                lower_timed(rec, op, cases[0][0], n, dtype)
        out[name] = rec
        print(f"[kernel] {name} g={g} n={n} {str(dtype)[6:]}: "
              + " ".join(f"{k}={v}" for k, v in rec.items()), flush=True)
    return out


def check_block_kernels(g: int, bs: int, dtype, seed: int,
                        timed_run: bool) -> dict:
    """K5, K6 in each mode and the block inverse against their twins on the
    card; returns per-kernel {max_abs_err, rel_err[, times and bound]}."""
    op = block_operands(g, bs, dtype, "cuda", seed)
    nb, isz = g ** 3, dtype.itemsize
    npair = len(op["pair_offs"])
    out = {}
    for name, cases in block_kernel_cases(op).items():
        rec = compare(name, f"bs={bs} g={g} {dtype}", cases, dtype)
        rec["shape"] = f"bs={bs} g={g} nb={nb} {str(dtype)[6:]}"
        if timed_run:
            kernel, twin = cases[-1]
            timed(rec, kernel, twin, *block_work(name, nb, bs, npair, isz),
                  dtype, block_library_of(name, op))
        out[name] = rec
        print(f"[kernel] {name} bs={bs} g={g} nb={nb} {str(dtype)[6:]}: "
              + " ".join(f"{k}={v}" for k, v in rec.items()), flush=True)
    return out


def block_library(op):
    """One PyTorch call computing K5's function: the CUDA BSR tensor of the
    same matrix times the flat vector, or, where this torch refuses BSR
    times a vector on CUDA, its CSR form (said on a line of its own)."""
    A = bsr_of_band(op["offsets"], op["data"], op["mask"])
    xf = op["x"].reshape(-1)
    want = bstencil.bdia_spmv_ref(op["offsets"], op["data"], op["x"])
    try:
        y = torch.mv(A, xf)
        form = "bsr"
    except (RuntimeError, NotImplementedError) as exc:
        print(f"[library] torch.mv on a CUDA BSR tensor: {exc}; timing the "
              "CSR form", flush=True)
        A = A.to_sparse_csr()
        y = torch.mv(A, xf)
        form = "csr"
    rel = float((y.reshape(want.shape) - want).abs().max()
                / want.abs().max())
    print(f"[library] bspmv yardstick: torch.mv on a CUDA {form} tensor, "
          f"relative difference to the twin {rel}", flush=True)
    return lambda: torch.mv(A, xf)


def inverse_library(op):
    """One PyTorch call computing the block inverse's function on its timed
    operand: ``torch.linalg.inv_ex`` of the (nb, bs, bs) batch of diagonal
    blocks (LU with partial pivoting, so it agrees with the Gauss–Jordan
    twin to rounding only: held to 1e-4 relative)."""
    a = op["base0"]
    b2, nb = a.shape
    bs = int(round(b2 ** 0.5))
    blocks = a.view(bs, bs, nb).permute(2, 0, 1)
    inv, info = torch.linalg.inv_ex(blocks)
    want = bstencil.block_inverse_ref(a)
    rel = float((inv.permute(1, 2, 0).reshape(b2, nb) - want).abs().max()
                / want.abs().max())
    print(f"[library] block_inverse yardstick: torch.linalg.inv_ex on the "
          f"(nb, bs, bs) blocks, {int((info != 0).sum())} singular, "
          f"relative difference to the twin {rel}", flush=True)
    if rel > 1e-4 or bool((info != 0).any()):
        fail(f"torch.linalg.inv_ex differs from the block inverse's twin "
             f"by {rel}")
    return lambda: torch.linalg.inv_ex(blocks)


def true_relres(A, b, x: torch.Tensor) -> float:
    """‖b − A x‖/‖b‖ on the host in float64."""
    sp = A.to_scipy().astype(np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    x64 = x.detach().cpu().numpy().astype(np.float64)
    return float(np.linalg.norm(b64 - sp @ x64) / np.linalg.norm(b64))


def block_system(g: int, bs: int, dtype, seed: int):
    """A host BSR system on the 7-point block band of a g³ block grid, with
    the kernel checks' entries (0.25·N(0,1), 14 on the diagonal of each
    diagonal block), and ``b = A·x_ref`` for a seeded ``x_ref``."""
    nb = g ** 3
    offsets = np.array([-g * g, -g, -1, 0, 1, g, g * g])
    idx = np.arange(nb)
    i0, j0, k0 = idx % g, (idx // g) % g, idx // (g * g)
    mask = np.stack([k0 > 0, j0 > 0, i0 > 0, np.ones(nb, bool),
                     i0 < g - 1, j0 < g - 1, k0 < g - 1])
    rows, ds = np.nonzero(mask.T)             # block by block, row by row
    rowptr = np.zeros(nb + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(mask.sum(0))
    rng = np.random.default_rng(seed)
    vals = 0.25 * rng.standard_normal((rows.shape[0], bs, bs), dtype=dtype)
    vals[ds == 3] += np.eye(bs, dtype=dtype) * 14.0
    B = BSRMatrix.from_arrays(rowptr, rows + offsets[ds], vals, bs)
    x_ref = rng.standard_normal(B.nrows)
    b = (B.to_scipy() @ x_ref).astype(dtype)
    return B, b


def expect_launches(label: str, counts: dict, want: dict) -> None:
    """Each kernel of ``want`` launched as often as it says (an int, or
    None for "at least once"); every other kernel never."""
    for name, n in counts.items():
        if name in want:
            if (want[name] is None and n == 0) or \
                    (want[name] is not None and n != want[name]):
                fail(f"{label}: {name} launched {n} times, expected "
                     f"{'at least 1' if want[name] is None else want[name]}")
        elif n:
            fail(f"{label}: {name} launched {n} times, expected none")


def krylov_solver(opts: dict):
    """The Krylov solver ``solve`` runs for ``opts``, with its keywords."""
    ksp = opts.get("ksp_type", "bicgstab")
    kw = {"nrestart": int(opts.get("restart", 30))} \
        if ksp in ("gcr", "gmres") else {}
    return getattr(solvers, ksp), kw


def steady_state(ctx, amat, b, opts: dict, reps: int = 3) -> dict:
    """Re-factor and re-solve with the context's operator, through the same
    calls solve() makes, ``reps`` times each (the first solve in a process
    also pays one-time CUDA library set-up and uploads b)."""
    prec = ctx.prec
    solver, kw = krylov_solver(opts)
    bt = torch.from_numpy(b).to(prec.device)
    factor_s, solve_s, iters = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compute_preconditioner(ctx)
        torch.cuda.synchronize()
        factor_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _, info = solver(amat, prec.apply_flat, bt, torch.zeros_like(bt),
                         tol=opts["rtol"], maxiter=opts["maxiter"], **kw)
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t0)
        iters.append(info.iters)
    return {"factor_s_steady": factor_s, "solve_s_steady": solve_s,
            "factor_s": statistics.median(factor_s),
            "solve_s": statistics.median(solve_s), "iters_repeat": iters}


def run_main(label: str, A, b, t_host: float, n_host: dict,
             opts=MAIN_OPTS, relres_max: float = MAIN_RELRES,
             reps: int = 3):
    """Solve ``A x = b`` through ``solve`` on the default device with
    ``opts`` and check it: converged, the true relative residual at most
    ``relres_max``, and ``reps`` steady re-solves taking the same
    iterations; returns the record (with the launches of the first solve)
    and the solve's context."""
    _cuda.reset_launches()
    t0 = time.perf_counter()
    x, info, ctx = solve(A, b, opts)
    torch.cuda.synchronize()
    t_solve_call = time.perf_counter() - t0
    counts = dict(_cuda.launches)
    if x.device.type != "cuda":
        fail(f"{label}: the default device ran the solve on {x.device}")
    if x.shape != (A.nrows,) or x.dtype != torch.float32:
        fail(f"{label}: x is {tuple(x.shape)} {x.dtype}")
    if not bool(torch.isfinite(x).all()):
        fail(f"{label}: non-finite solution")
    relres = true_relres(A, b, x)
    amat = operator(ctx)
    rec = {**n_host, "iters": info.iters,
           "converged": info.converged, "breakdown": info.breakdown,
           "relres_recursive": info.resnorm / info.bnorm,
           "relres_true": relres,
           "factor_s_first": ctx.timers.factor_walltime,
           "solve_s_first": ctx.timers.apply_walltime,
           "solve_call_s_first": t_solve_call, "host_assembly_s": t_host,
           **steady_state(ctx, amat, b, opts, reps),
           "launches": counts}
    print(f"[{label}] " + json.dumps(rec), flush=True)
    if not info.converged:
        fail(f"{label} did not converge: {rec}")
    if relres > relres_max:
        fail(f"{label} true relres {relres} > {relres_max}")
    if rec["iters_repeat"] != [info.iters] * reps:
        fail(f"{label}: repeated solves took {rec['iters_repeat']} "
             f"iterations, not {info.iters}")
    return rec, ctx


def operator(ctx):
    """The flat-vector SpMV of the solve's device matrix (the AMG
    hierarchy's finest level for ``amg``)."""
    D = ctx.prec.mat
    if hasattr(ctx.prec, "levels"):
        D = ctx.prec.levels[0].A_dev
    bs = getattr(D, "bs", 1)
    if bs > 1:
        return lambda v: bspmv(D, v.reshape(-1, bs)).reshape(-1)
    return lambda v: spmv(D, v)


def main_path():
    """The bench's scalar solve through the user entry point; returns the
    kernel launches it made, its iterations and the host system."""
    t0 = time.perf_counter()
    A, b, _ = poisson3d_system((MAIN_NPTS,) * 3, dist="uniform")
    A, b = A.astype(np.float32), b.astype(np.float32)
    t_host = time.perf_counter() - t0
    rec, _ = run_main("main", A, b, t_host, {"n": A.nrows, "nnz": A.nnz})
    # the plain factor route below JAX's gate (R4): no K3/K4
    expect_launches("main", rec["launches"],
                    {"dia_spmv": 2 * rec["iters"] + 1, "tri_sweep": None})
    return rec["launches"], rec, A, b


def block_main_path():
    """The bench's block size on the g=128 block band through the user
    entry point; returns the kernel launches it made and the host
    system."""
    t0 = time.perf_counter()
    B, b = block_system(BLOCK_G, BLOCK_BS, np.float32, seed=7)
    t_host = time.perf_counter() - t0
    rec, _ = run_main("block-main", B, b, t_host,
                      {"bs": B.bs, "nb": B.nbrows, "n": B.nrows,
                       "nnzb": B.nnzb}, ILU44_OPTS)
    nbuild = int(ILU44_OPTS["blasted_async_sweeps"].split(",")[0])
    # K6: nbuild − 1 Dinv-emitting sweeps and one U0-emitting sweep; the
    # block inverse before the sweeps and for the apply's diagonal
    expect_launches("block-main", rec["launches"],
                    {"bspmv": 2 * rec["iters"] + 1,
                     "bfactor_dinv": nbuild - 1, "bfactor_u0": 1,
                     "block_inverse": None})
    return rec["launches"], B, b


def device_independence(label: str, A, b, opts=None, case: str = "",
                        rtol: float = 1e-10, route: str = "",
                        iters_tol: int = 0) -> dict:
    """Same f64 solve on the card and on the CPU twins: iterations within
    ``iters_tol`` (the same, by default), x within 1e-8 and, given
    ``route``, the card's device storage of that type."""
    opts = dict(MAIN_OPTS if opts is None else opts, rtol=rtol)
    xg, ig, ctx = solve(A, b, opts, device="cuda")
    xc, ic, _ = solve(A, b, opts, device="cpu")
    xg = xg.cpu()
    rel = float(torch.linalg.norm(xg - xc) / torch.linalg.norm(xc))
    # AMG keeps the host matrix: its route is its finest level's storage
    mat = ctx.prec.levels[0].A_dev if hasattr(ctx.prec, "levels") \
        else ctx.prec.mat
    rec = {"n": A.nrows, "iters_cuda": ig.iters, "iters_cpu": ic.iters,
           "converged": [ig.converged, ic.converged], "x_rel_diff": rel,
           "relres_true_cuda": true_relres(A, b, xg),
           "route": f"{type(mat).__name__} + {type(ctx.prec).__name__}"}
    if case:
        label = f"{label}] [{case}"
    print(f"[{label}] " + json.dumps(rec), flush=True)
    if not (ig.converged and ic.converged):
        fail(f"{label}: f64 solve did not converge: {rec}")
    if route and not rec["route"].startswith(f"{route} "):
        fail(f"{label}: took {rec['route']}, expected {route}")
    if abs(ig.iters - ic.iters) > iters_tol:
        fail(f"{label}: iteration counts differ by more than {iters_tol}: "
             f"cuda {ig.iters}, cpu {ic.iters}")
    if rel > 1e-8:
        fail(f"{label}: cuda and cpu solutions differ by {rel} > 1e-8")
    return rec


def device_independence_cases() -> None:
    """[device-independence] on the seeded uniform 48³ f64 system (the
    same iterations) and on the generator's Chebyshev one, whose ILU(0)
    8,4 count moves with the summation order alone: on the CPU it reads
    43, 41, 41, 44 with 1, 2, 4, 8 threads
    (tests/test_torch_api.py::test_chebyshev_iterations_move_with_cpu_threads),
    so card and CPU are held within CHEB_ITERS_TOL iterations there."""
    A, b = seeded_poisson(CHECK_NPTS, np.float64)
    device_independence("device-independence", A, b, case="uniform, seeded b")
    A, b, _ = poisson3d_system((CHECK_NPTS,) * 3)
    device_independence("device-independence", A, b, case="chebyshev",
                        iters_tol=CHEB_ITERS_TOL)


def padded_path(label: str, A, b, main_iters: int | None):
    """Solve the host system through ``solve`` with PADDED_OPTS (padded
    CSR/BSR, ILU(0)) on the default device and check it: converged, true
    relres, no K1-K6 launch and, given ``main_iters``, the banded path's
    iteration count within one.  Prints the host set-up seconds (pad,
    upload, symbolic pass) and returns the record and the context."""
    rec, ctx = run_main(label, A, b, 0.0,
                        {"n": A.nrows, "host_system": "reused"}, PADDED_OPTS)
    expect_launches(label, rec["launches"], {})
    if main_iters is not None and abs(rec["iters"] - main_iters) > 1:
        fail(f"{label}: {rec['iters']} iterations, the banded path took "
             f"{main_iters}")
    # solve() = pad + upload + first factor (with the symbolic pass) +
    # first Krylov solve
    setup = {"pad_upload_s": rec["solve_call_s_first"]
             - rec["factor_s_first"] - rec["solve_s_first"],
             "symbolic_s": rec["factor_s_first"] - rec["factor_s"],
             "factor_s_first": rec["factor_s_first"],
             "factor_s_steady": rec["factor_s"],
             "solve_s_steady": rec["solve_s"]}
    print(f"[{label}] setup: " + json.dumps(setup), flush=True)
    return rec, ctx


def torch_mv_operand(A, device):
    """The host CSR/BSR matrix as a CUDA sparse CSR/BSR tensor, ``torch.mv``'s
    operand (the padded SpMV's library yardstick)."""
    def put(a, dtype=None):
        return torch.from_numpy(np.asarray(a)).to(device, dtype)

    crow, col = put(A.rowptr, torch.int64), put(A.colind, torch.int64)
    make = torch.sparse_csr_tensor if isinstance(A, CSRMatrix) \
        else torch.sparse_bsr_tensor
    return make(crow, col, put(A.vals), size=(A.nrows, A.nrows))


def padded_op_times(label: str, A, ctx) -> dict:
    """Device µs of one padded SpMV, one factor sweep and one apply of the
    solve's operator (torch operations, no hand-written kernel), beside the
    least bytes each must move over the memory rate, and ``torch.mv`` on the
    same CUDA CSR/BSR matrix."""
    prec = ctx.prec
    D = prec.mat
    bs, isz = prec.block_size, D.dtype.itemsize
    nb, W = D.pos.shape
    nnz, b2 = D.nnz_total, bs * bs
    P = prec.symbolic.lowerp.shape[1]
    napply = prec.napplysweeps
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((nb, bs) if bs > 1 else (nb,), generator=gen,
                    dtype=D.dtype, device="cuda")
    mv = bspmv if bs > 1 else spmv
    base = D.flat_vals()
    sweep = prec.factor_sweep_fn(base)
    ilu = prec.state.ilu
    xf = x.reshape(-1)
    lib = torch_mv_operand(A, "cuda")
    rel = float((torch.mv(lib, xf) - mv(D, x).reshape(-1)).abs().max()
                / mv(D, x).abs().max())
    # operations per entry: a pair product (bs×bs matmul) and the lower
    # entries' division (a product with the inverted diagonal block), and
    # per row the diagonal's inverse
    pair = 2 * b2 * bs - b2 if bs > 1 else 2
    lowered = pair if bs > 1 else 1
    gj = gj_flops(bs) if bs > 1 else 1
    ops = {
        # values and column ids of every padded slot, x once, y once
        "spmv": (lambda: mv(D, x), nb * W * (b2 * isz + 4) + 2 * nb * bs * isz,
                 2 * nb * W * b2, lambda: torch.mv(lib, xf)),
        # base, ilu and the result per entry, its P pair ids twice, column,
        # lower flag, and the diagonal positions
        "factor_sweep": (lambda: sweep(ilu),
                         nnz * (3 * b2 * isz + 8 * P + 5) + nb * 4,
                         nnz * (P * pair + lowered) + nb * gj,
                         None),
        # padded factor values, column ids and both masks once, r, the
        # diagonal inverse and z
        "apply": (lambda: prec.apply(x), nb * W * (b2 * isz + 6)
                  + nb * (2 * bs + b2) * isz,
                  2 * napply * 2 * nb * W * b2, None),
    }
    out = {"torch_mv_rel_diff": rel}
    for name, (fn, nbytes, flops, library) in ops.items():
        rec = {"ms": cuda_ms(fn)[0]}
        rec.update(bound(nbytes, flops, D.dtype))
        rec["library_ms"] = None if library is None else cuda_ms(library)[0]
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        out[name] = rec
    print(f"[{label}] torch ops: " + json.dumps(out), flush=True)
    if rel > TOL[D.dtype] * 10:
        fail(f"{label}: torch.mv differs from the padded SpMV by {rel}")
    return out


def tf32_check(ctx) -> None:
    """One padded block SpMV and one block factor sweep with TF32 matmuls
    allowed and not: the block contractions are broadcast products, so the
    results must be bitwise equal (ROADMAP.md fault C4)."""
    prec = ctx.prec
    D = prec.mat
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((D.nbrows, D.bs), generator=gen, dtype=D.dtype,
                    device="cuda")
    sweep = prec.factor_sweep_fn(D.flat_vals())
    got = {}
    for allow in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = allow
        got[allow] = (bspmv(D, x), sweep(prec.state.ilu))
        torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32 = False
    same = [bool(torch.equal(a, b)) for a, b in zip(got[True], got[False])]
    print(f"[tf32] bs={D.bs} padded block SpMV and factor sweep bitwise "
          f"equal with allow_tf32 True and False: {same}", flush=True)
    if not all(same):
        fail(f"[tf32] results depend on the TF32 flag: {same}")


def permuted(npts: int):
    """The npts³ Poisson system in a random order: not banded until RCM."""
    A, b, _ = poisson3d_system((npts,) * 3)
    perm = np.random.default_rng(13).permutation(A.nrows)
    sp = A.to_scipy()[perm][:, perm].tocsr()
    sp.sort_indices()
    return CSRMatrix.from_arrays(sp.indptr, sp.indices, sp.data), b[perm]


def padded_device_independence() -> None:
    """The general path's small float64 solves on the card and on the
    CPU: the same route, the same iterations and x within 1e-8.  The card
    and the CPU sum the padded rows and BiCGSTAB's dot products in their
    own orders, and with the async ILU(0) and Jacobi solves here that
    rounding grows: reordering the dot's sum alone, on the CPU, moves x by
    up to 2.4e-10 and, near rtol 1e-10, the residual history by up to 85 %
    (so the stopping step).  At rtol 1e-8 every case stops at least 6 %
    below the threshold and one step above it."""
    A, b, _ = poisson3d_system((CHECK_NPTS,) * 3)
    ilu = dict(ILU44_OPTS, prefer_dia=False)
    cases = [("ilu0 4,4", A, b, ilu, "PaddedCSR"),
             ("seqilu0", A, b, dict(ilu, blasted_pc_type="seqilu0"),
              "PaddedCSR"),
             ("jacobi padded", A, b, dict(ilu, blasted_pc_type="jacobi"),
              "PaddedCSR"),
             ("default options", A, b, {"rtol": 1e-10}, "DiaMatrix")]
    B, bb = block_system(BLOCK_CHECK_G, BLOCK_BS, np.float64, seed=9)
    cases.append(("block ilu0 4,4", B, bb, ilu, "PaddedBSR"))
    # RCM bands the permuted 8³ grid into 105 diagonals (K1 on all of
    # them); the 46³ one it leaves past the 128 of the route's limit
    Ap, bp = permuted(10)
    cases.append(("permuted 10, RCM to DIA", Ap, bp, ILU44_OPTS,
                  "DiaMatrix"))
    Ap, bp = permuted(CHECK_NPTS)
    cases.append(("permuted 48, RCM to padded", Ap, bp, ILU44_OPTS,
                  "PaddedCSR"))
    for name, M, rhs, opts, route in cases:
        device_independence("padded-device-independence", M, rhs, opts,
                            case=name, rtol=1e-8, route=route)


def check_all_kernels() -> dict:
    """Every kernel against its twin at each checked shape; the timed
    records of the main paths' shapes."""
    # K1/K2 timed at [main]'s 160³; K3/K4, which only [main-compressed]
    # launches, at its 288³ (checked at 160³ as well)
    shapes = check_kernels(MAIN_NPTS - 2, torch.float32, 1,
                           timed_names=("dia_spmv", "tri_sweep"))
    err = {k: v["max_abs_err"] for k, v in shapes.items()}
    big = check_kernels(COMPRESSED_G, torch.float32, 6,
                        timed_names=("factor_u0", "factor_lower"))
    torch.cuda.empty_cache()
    for name in ("factor_u0", "factor_lower"):
        shapes[name] = big[name]
    for name, rec in shapes.items():
        rec["max_abs_err"] = max(rec["max_abs_err"], err[name],
                                 big[name]["max_abs_err"])
    check_kernels(CHECK_NPTS - 2, torch.float64, 2)
    shapes.update(check_block_kernels(BLOCK_G, BLOCK_BS, torch.float32, 3,
                                      timed_run=True))
    check_block_kernels(96, 5, torch.float32, 4, timed_run=False)
    check_block_kernels(BLOCK_CHECK_G, BLOCK_BS, torch.float64, 5,
                        timed_run=False)
    return shapes


def seeded_poisson(npts, dtype):
    """The uniform-grid Poisson matrix of npts³ grid points (or of the
    grid ``npts`` = (nx, ny, nz) points) with the
    right-hand side b = A·x_ref, x_ref uniform in [−1, 1] from a seed.
    The generator's own b is an eigenvector of this matrix (Jacobi, GS and
    CSC-BGS converge in one step on it), and a float32 BiCGSTAB solve of
    it stopped at rtol 1e-5 leaves a true residual near 5e-5 at 160³, the
    port's and JAX's alike (``scripts/solve_f32_witness.py``; the exact
    solution rounded to float32 alone leaves 8.6e-6); this b makes every
    method iterate and lets float32 reach 1.1·rtol."""
    pts = (npts,) * 3 if isinstance(npts, int) else tuple(npts)
    A, _, _ = poisson3d_system(pts, dist="uniform")
    x_ref = np.random.default_rng(X_REF_SEED).uniform(-1.0, 1.0, A.nrows)
    b = (A.to_scipy() @ x_ref).astype(dtype)
    return A.astype(dtype), b


def expected(rule, iters: int):
    """A launch-count rule of KRYLOV_CASES: one K1/K5 per SpMV, so
    2·iters + 1 for BiCGSTAB, iters + 1 for CG; None: at least once."""
    return {"bicgstab": 2 * iters + 1, "cg": iters + 1}.get(rule, rule)


def krylov_main(A, b, B, bb) -> dict:
    """[krylov-main]: the other Krylov methods and preconditioners on the
    [main] matrix at full width (160³, float32, DIA) with a seeded b, then
    BiCGSTAB with block SGS on the [block-main] system (block-DIA).
    Returns the kernel launches of these solves."""
    total = dict.fromkeys(_cuda.launches, 0)
    for label, extra, want in KRYLOV_CASES:
        opts = dict(extra, rtol=KRYLOV_RTOL, maxiter=2000)
        rec, ctx = run_main(f"krylov-main] [{label}", A, b, 0.0,
                            {"n": A.nrows, "host_system": "reused"}, opts,
                            relres_max=KRYLOV_RELRES, reps=3)
        del ctx
        expect_launches(label, rec["launches"],
                        {k: expected(v, rec["iters"])
                         for k, v in want.items()})
        for k, v in rec["launches"].items():
            total[k] += v
    opts = {"ksp_type": "bicgstab", "blasted_pc_type": "sgs",
            "blasted_async_sweeps": "1,2", "rtol": KRYLOV_RTOL,
            "maxiter": 2000}
    rec, ctx = run_main("krylov-main] [block bicgstab+sgs", B, bb, 0.0,
                        {"bs": B.bs, "nb": B.nbrows, "host_system": "reused"},
                        opts, relres_max=KRYLOV_RELRES, reps=3)
    if type(ctx.prec.mat).__name__ != "BlockDiaMatrix":
        fail(f"block bicgstab+sgs ran on {type(ctx.prec.mat).__name__}")
    del ctx
    expect_launches("block bicgstab+sgs", rec["launches"],
                    {"bspmv": expected("bicgstab", rec["iters"])})
    for k, v in rec["launches"].items():
        total[k] += v
    torch.cuda.empty_cache()
    return total


def amg_main(A, b):
    """[amg-main]: AMG (group 4, V cycle, SGS smoother) on the [main]
    matrix at full width under CG and Richardson: converged to 1.1·rtol,
    every level DIA in float32, K1 and no other kernel launched.  Prints
    the levels, the host hierarchy seconds, the steady apply ms (host wall
    around 10 applies) and the solve seconds; returns the launches and the
    CG context (for [tf32])."""
    total = dict.fromkeys(_cuda.launches, 0)
    keep = None
    for ksp in ("cg", "richardson"):
        opts = dict(AMG_OPTS, ksp_type=ksp, rtol=KRYLOV_RTOL, maxiter=2000)
        rec, ctx = run_main(f"amg-main] [{ksp}+amg", A, b, 0.0,
                            {"n": A.nrows, "host_system": "reused"}, opts,
                            relres_max=KRYLOV_RELRES, reps=3)
        expect_launches(f"{ksp}+amg", rec["launches"], {"dia_spmv": None})
        prec = ctx.prec
        levels = [(type(lev.A_dev).__name__, str(lev.A_dev.dtype)[6:],
                   lev.n) for lev in prec.levels]
        if any(f != "DiaMatrix" or d != "float32" for f, d, _ in levels) \
                or prec._A_coarse.dtype != torch.float32:
            fail(f"{ksp}+amg: levels {levels}, coarse "
                 f"{prec._A_coarse.dtype}")
        r = torch.from_numpy(b).to("cuda")
        prec.apply(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            prec.apply(r)
        torch.cuda.synchronize()
        info = {"levels": len(levels) + 1, "level_n": [n for *_, n in levels]
                + [prec._A_coarse.shape[0]],
                "hierarchy_s": rec["factor_s_first"] - rec["factor_s"],
                "apply_ms_steady": (time.perf_counter() - t0) * 100.0,
                "solve_s_steady": rec["solve_s"]}
        print(f"[amg-main] [{ksp}+amg] " + json.dumps(info), flush=True)
        for k, v in rec["launches"].items():
            total[k] += v
        if keep is None:
            keep = ctx
    return total, keep


def cut_solve(label: str, A, b, opts: dict, route: str, want: dict):
    """One solve of a phase cut in size, through ``solve`` on the card:
    converged, true relres ≤ 1.1·rtol, the route, the kernels; prints the
    host set-up (conversion and upload), first factor (with any symbolic
    pass), steady factor and solve seconds.  Returns the context."""
    opts = dict(opts, rtol=KRYLOV_RTOL, maxiter=2000)
    rec, ctx = run_main(label, A, b, 0.0, {"n": A.nrows}, opts,
                        relres_max=KRYLOV_RELRES, reps=2)
    got = f"{type(ctx.prec.mat).__name__} + {type(ctx.prec).__name__}"
    if got != route:
        fail(f"{label}: took {got}, expected {route}")
    expect_launches(label, rec["launches"],
                    {k: expected(v, rec["iters"]) for k, v in want.items()})
    setup = {"setup_s": rec["solve_call_s_first"] - rec["factor_s_first"]
             - rec["solve_s_first"],
             "factor_s_first": rec["factor_s_first"],
             "factor_s_steady": rec["factor_s"],
             "solve_s_steady": rec["solve_s"], "iters": rec["iters"]}
    print(f"[{label}] setup: " + json.dumps(setup), flush=True)
    return ctx


def level_sgs_phase() -> None:
    """[level-sgs], cut to 64³ (n = 262,144): level-scheduled SGS runs one
    full-size masked update per level, each way (190 levels of the 7-point
    64³ grid; 484 at 162³), so one apply at 160³ would be thousands of
    launches.  Scalar on DIA and on padded CSR, block (bs = 4, 64³ block
    grid) on block-DIA; BiCGSTAB to rtol 1e-5."""
    A, b = seeded_poisson(CUT_NPTS, np.float32)
    opts = {"ksp_type": "bicgstab", "blasted_pc_type": "level_sgs"}
    cut_solve("level-sgs] [dia", A, b, opts,
              "DiaMatrix + LevelSGSPreconditioner", {"dia_spmv": "bicgstab"})
    cut_solve("level-sgs] [padded csr", A, b, dict(opts, prefer_dia=False),
              "PaddedCSR + LevelSGSPreconditioner", {})
    B, bb = block_system(CUT_NPTS - 2, BLOCK_BS, np.float32, seed=21)
    cut_solve("level-sgs] [block-dia", B, bb, opts,
              "BlockDiaMatrix + BlockLevelSGSPreconditioner",
              {"bspmv": "bicgstab"})
    torch.cuda.empty_cache()


def sai_phase():
    """[sai], cut in size: the SAI symbolic pass is host numpy over
    (n, E, V) int64 tables (E = 25, V = 7 on the 7-point stencil), about
    5.7 GB each at n = 4.1 M and several of them.  Scalar SAI and ISAI on
    padded CSR at 64³; block SAI and ISAI (bs = 4) on padded BSR at
    g = 48.  BiCGSTAB to rtol 1e-5.  Returns the block SAI context (for
    [tf32])."""
    A, b = seeded_poisson(CUT_NPTS, np.float32)
    for pc in ("sai", "isai"):
        ctx = cut_solve(f"sai] [{pc} padded csr", A, b,
                        {"ksp_type": "bicgstab", "blasted_pc_type": pc,
                         "prefer_dia": False},
                        "PaddedCSR + SAIPreconditioner", {})
        del ctx
    B, bb = block_system(SAI_BLOCK_G, BLOCK_BS, np.float32, seed=22)
    keep = None
    for pc in ("sai", "isai"):
        ctx = cut_solve(f"sai] [block {pc} padded bsr", B, bb,
                        {"ksp_type": "bicgstab", "blasted_pc_type": pc,
                         "prefer_dia": False},
                        "PaddedBSR + BlockSAIPreconditioner", {})
        keep = keep or ctx
    torch.cuda.empty_cache()
    return keep


def precinfo_phase() -> None:
    """[precinfo]: ``compute_precinfo`` of the DIA, block-DIA and padded
    ILU(0) (3 factor sweeps) of small float64 systems on the card and on
    the CPU: the PrecInfo tuples agree within 1e-10 (relative; 1e-10 of
    the initial remainder for the final one)."""
    A, _, _ = poisson3d_system((STACK_NPTS,) * 3)
    B, _ = block_system(STACK_BLOCK_G, BLOCK_BS, np.float64, seed=23)
    s = AsyncSolverSettings(prec_type=PrecType.ILU0, nbuildsweeps=3,
                            napplysweeps=3, compute_precinfo=True)
    for name, M, prefer in (("dia", A, True), ("block-dia", B, True),
                            ("padded csr", A, False)):
        got = {}
        for dev in ("cuda", "cpu"):
            D = to_device_matrix(M, device=dev, prefer_dia=prefer)
            got[dev] = (type(D).__name__,
                        np.array(create_preconditioner(D, s).compute()))
        (fg, g), (fc, c) = got["cuda"], got["cpu"]
        scale = np.maximum(np.abs(c), [1.0, abs(c[0])] + [1.0] * 4)
        rel = float(np.max(np.abs(g - c) / scale))
        print(f"[precinfo] [{name}] {fg}: cuda {g.tolist()} cpu "
              f"{c.tolist()} max diff {rel}", flush=True)
        if fg != fc or rel > 1e-10 or not np.all(np.isfinite(g)):
            fail(f"[precinfo] {name}: card and CPU differ by {rel}")


def stack_device_independence() -> None:
    """[stack-device-independence]: small float64 systems (12³ uniform
    Poisson with a seeded b, the bs = 4 g = 12 block band) solved on the
    card and on the CPU once for every new ksp_type and every new pc_type,
    AMG and the MC64-job-5 reordered ILU(0) included: the route each must
    take, the same iterations and x within 1e-8, at rtol 1e-8."""
    A, b = seeded_poisson(STACK_NPTS, np.float64)
    B, bb = block_system(STACK_BLOCK_G, BLOCK_BS, np.float64, seed=24)
    ilu = {"blasted_pc_type": "ilu0", "blasted_async_sweeps": "4,4"}
    cases = [
        ("cg+jacobi", A, b, {"ksp_type": "cg"}, "DiaMatrix"),
        ("gcr+ilu0", A, b, dict(ilu, ksp_type="gcr", restart=10),
         "DiaMatrix"),
        ("gmres+ilu0", A, b, dict(ilu, ksp_type="gmres", restart=10),
         "DiaMatrix"),
        ("richardson+amg", A, b, dict(AMG_OPTS, ksp_type="richardson"),
         "DiaMatrix"),
        ("cg+amg w", A, b, dict(AMG_OPTS, ksp_type="cg",
                                blasted_amg_cycle="w"), "DiaMatrix"),
        ("bicgstab+sgs", A, b, {"blasted_pc_type": "sgs",
                                "blasted_async_sweeps": "1,2"}, "DiaMatrix"),
        ("bicgstab+gs", A, b, {"blasted_pc_type": "gs"}, "DiaMatrix"),
        ("bicgstab+level_sgs", A, b, {"blasted_pc_type": "level_sgs"},
         "DiaMatrix"),
        ("bicgstab+cscbgs", A, b, {"blasted_pc_type": "cscbgs"},
         "DiaMatrix"),
        ("bicgstab+sai", A, b, {"blasted_pc_type": "sai",
                                "prefer_dia": False}, "PaddedCSR"),
        ("bicgstab+isai", A, b, {"blasted_pc_type": "isai",
                                 "prefer_dia": False}, "PaddedCSR"),
        ("block bicgstab+sgs", B, bb, {"blasted_pc_type": "sgs"},
         "BlockDiaMatrix"),
        ("block gmres+gs", B, bb, {"blasted_pc_type": "gs",
                                   "ksp_type": "gmres"}, "BlockDiaMatrix"),
        ("block bicgstab+level_sgs", B, bb,
         {"blasted_pc_type": "level_sgs"}, "BlockDiaMatrix"),
        ("block bicgstab+sai", B, bb, {"blasted_pc_type": "sai",
                                       "prefer_dia": False}, "PaddedBSR"),
        ("block bicgstab+isai", B, bb, {"blasted_pc_type": "isai",
                                        "prefer_dia": False}, "PaddedBSR"),
    ]
    for name, M, rhs, opts, route in cases:
        device_independence("stack-device-independence", M, rhs,
                            dict({"ksp_type": "bicgstab", "maxiter": 2000},
                                 **opts),
                            case=name, rtol=1e-8, route=route)
    # ReorderedILU0Preconditioner (no pc_type reaches it): MC64 job 5 on
    # the 12³ matrix with shuffled rows and a small diagonal added (so
    # every row stores one), BiCGSTAB on that operator
    import scipy.sparse as sps

    perm = np.random.default_rng(25).permutation(A.nrows)
    sp = (A.to_scipy()[perm] + sps.identity(A.nrows)).tocsr()
    sp.sort_indices()
    Ash = CSRMatrix.from_arrays(sp.indptr, sp.indices, sp.data)
    bsh = sp @ np.random.default_rng(X_REF_SEED).uniform(-1, 1, A.nrows)
    out = {}
    for dev in ("cuda", "cpu"):
        p = ReorderedILU0Preconditioner(
            Ash, MaxMatchingReordering(5),
            AsyncSolverSettings(prec_type=PrecType.ILU0, nbuildsweeps=4,
                                napplysweeps=4), device=dev)
        p.compute()
        D = to_device_matrix(Ash, device=dev)
        bt = torch.from_numpy(bsh).to(dev)
        x, info = solvers.bicgstab(lambda v: spmv(D, v), p.apply_flat, bt,
                                   torch.zeros_like(bt), tol=1e-8,
                                   maxiter=2000)
        out[dev] = (x.cpu(), info, type(p.mat).__name__, type(D).__name__)
    (xg, ig, rg, dg), (xc, ic, rc, _) = out["cuda"], out["cpu"]
    rel = float(torch.linalg.norm(xg - xc) / torch.linalg.norm(xc))
    rec = {"iters_cuda": ig.iters, "iters_cpu": ic.iters,
           "converged": [ig.converged, ic.converged], "x_rel_diff": rel,
           "relres_true_cuda": true_relres(Ash, bsh, xg),
           "route": f"{dg} operator, {rg} + ReorderedILU0Preconditioner"}
    print("[stack-device-independence] [reordered ilu0 mc64 job 5] "
          + json.dumps(rec), flush=True)
    if not (ig.converged and ic.converged) or ig.iters != ic.iters \
            or rel > 1e-8 or rg != rc:
        fail(f"reordered ilu0: {rec}")


def tf32_stack_check(sai_ctx, amg_ctx) -> None:
    """[tf32], the rest of the stack: one block SAI compute (the normal
    equations and the batched solve) and one AMG apply (the cycle with its
    dense LU coarse solve) must be bitwise equal with TF32 matmuls allowed
    and not; the SAI compute is first repeated with the flag off, so a
    difference is the flag's and not the solve's."""
    sai = sai_ctx.prec
    r = torch.randn(amg_ctx.prec.levels[0].n, dtype=torch.float32,
                    device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(13))
    got = {}
    for allow in (False, False, True):
        torch.backends.cuda.matmul.allow_tf32 = allow
        sai.compute()
        got.setdefault(allow, []).append((sai.state.clone(),
                                          amg_ctx.prec.apply(r)))
        torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32 = False
    (s0, a0), (s1, a1) = got[False]
    s2, a2 = got[True][0]
    same = {"sai_repeat": bool(torch.equal(s0, s1)),
            "amg_repeat": bool(torch.equal(a0, a1)),
            "sai_tf32": bool(torch.equal(s0, s2)),
            "amg_tf32": bool(torch.equal(a0, a2))}
    print(f"[tf32] block SAI compute and AMG apply bitwise equal with "
          f"allow_tf32 True and False: {same}", flush=True)
    if not all(same.values()):
        fail(f"[tf32] results depend on the TF32 flag: {same}")


def card_mesh(nshards: int, shape=None):
    """``nshards`` subdomains on the one card."""
    return make_mesh(devices=["cuda:0"] * nshards, shape=shape)


# kernel → max |kernel − twin| over the shard checks of the distributed
# phases (shard_twins); merged into the kernels' record
SHARD_ERR: dict = {}


def shard_twins(label: str, ds, s: int, seed: int) -> None:
    """Each kernel of a banded distributed route at the shape it runs
    there, on shard ``s``'s own band and state, against its twin on the
    same card tensors, bitwise.  Scalar: K1 on the shard's data, K2 as the
    ILU(0) unit-lower and upper (with dinv) sweeps and the SGS lower sweep
    (lower diagonals with dinv).  Block: K5, K6 in its Dinv and U0 modes on
    the first factor sweep's operands, and the block inverse of the
    shard's factored diagonal."""
    data, nl, offs = ds.data[s], ds.nl, ds.offsets
    d0 = offs.index(0)
    vl, di = ds._state[s]
    gen = torch.Generator(device=data.device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=data.dtype,
                           device=data.device)

    r = torch.arange(nl, device=data.device)
    mask = torch.stack([ds.mask[s][d] & (r + o >= 0) & (r + o < nl)
                        for d, o in enumerate(offs)])
    if isinstance(ds, DistBlockDiaSolver):
        x = randn(nl, ds.bs)
        base = torch.where(mask[:, None], data, 0.0)
        key = dia_pairs(offs)[d0]
        fac = (tuple(o1 for _, _, o1 in key), base[d0],
               torch.stack([base[dl] for dl, _, _ in key]),
               torch.stack([shift_last(base[du], o1) for _, du, o1 in key]),
               bstencil.block_inverse_ref(base[d0], mask[d0]))
        cases = {
            "bspmv": [(lambda: bstencil.bdia_spmv_stencil(offs, data, x),
                       lambda: bstencil.bdia_spmv_ref(offs, data, x))],
            "bfactor_dinv": [(lambda: bstencil.bdia_factor_stencil(*fac, True),
                              lambda: bstencil.bdia_factor_ref(*fac, True))],
            "bfactor_u0": [(lambda: bstencil.bdia_factor_stencil(*fac, False),
                            lambda: bstencil.bdia_factor_ref(*fac, False))],
            "block_inverse": [
                (lambda: bstencil.bdia_block_inverse(vl[d0], mask[d0]),
                 lambda: bstencil.block_inverse_ref(vl[d0], mask[d0]))]}
    else:
        x, y, rhs = randn(nl), randn(nl), randn(nl)
        lo, up = offs[:d0], offs[d0 + 1:]
        cases = {
            "dia_spmv": [(lambda: stencil.dia_spmv_stencil(offs, data, x),
                          lambda: stencil.dia_spmv_ref(offs, data, x))],
            "tri_sweep": [
                (lambda: stencil.tri_sweep_stencil(lo, vl[:d0], rhs, y),
                 lambda: stencil.tri_sweep_ref(lo, vl[:d0], rhs, y)),
                (lambda: stencil.tri_sweep_stencil(up, vl[d0 + 1:], rhs, y,
                                                   di),
                 lambda: stencil.tri_sweep_ref(up, vl[d0 + 1:], rhs, y, di)),
                (lambda: stencil.tri_sweep_stencil(lo, vl[:d0], rhs, y, di),
                 lambda: stencil.tri_sweep_ref(lo, vl[:d0], rhs, y, di))]}
    errs = {}
    for name, pairs in cases.items():
        for kernel, twin in pairs:
            got, want = kernel(), twin()
            torch.cuda.synchronize(got.device)
            if got.shape != want.shape:
                fail(f"{label} shard {s} {name}: shape {tuple(got.shape)}, "
                     f"twin {tuple(want.shape)}")
            err = float((got - want).abs().max())
            errs[name] = max(errs.get(name, 0.0), err)
            if not torch.equal(got, want):
                fail(f"{label} shard {s} {name}: not bitwise equal to its "
                     f"twin (max abs err {err})")
        SHARD_ERR[name] = max(SHARD_ERR.get(name, 0.0), errs[name])
    print(f"[{label}] shard {s} of {ds.mesh.size}, {nl} rows: kernels "
          f"bitwise equal to their twins " + json.dumps(errs), flush=True)


def dist_run(label: str, A, b, opts: dict, mesh, relres_max: float,
             reps: int = 3):
    """``solve(A, b, opts, mesh=mesh)``, checked as ``run_main`` checks a
    solve; then ``reps`` steady re-factors (the shard set-up, no host
    conversion) and re-solves, each timed between synchronisations of
    every card of the mesh.  Returns the record (with the first solve's
    launches, in all and by card, and each card's peak memory), the
    distributed solver and x."""
    cards = sorted({d.index for d in mesh.devices})
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    x, info, ctx = solve(A, b, opts, mesh=mesh)
    mesh.synchronize()
    t_call = time.perf_counter() - t0
    counts = dict(_cuda.launches)
    by_card = {k: dict(v) for k, v in _cuda.launches_by_device.items() if v}
    if x.device.type != "cuda" or x.shape != (A.nrows,) \
            or not bool(torch.isfinite(x).all()):
        fail(f"{label}: x is {tuple(x.shape)} on {x.device}, finite "
             f"{bool(torch.isfinite(x).all())}")
    ds = ctx.prec
    factor_s, solve_s, iters = [], [], []
    for _ in range(reps):
        mesh.synchronize()
        t0 = time.perf_counter()
        ds._compute()
        mesh.synchronize()
        factor_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _, inf = ds.solve(b, method=opts["ksp_type"], tol=opts["rtol"],
                          maxiter=opts["maxiter"])
        mesh.synchronize()
        solve_s.append(time.perf_counter() - t0)
        iters.append(inf.iters)
    relres = true_relres(A, b, x)
    rec = {"shards": mesh.size, "cards": cards, "route": type(ds).__name__,
           "iters": info.iters, "converged": info.converged,
           "breakdown": info.breakdown, "relres_true": relres,
           "setup_s_first": ctx.timers.factor_walltime,
           "solve_s_first": ctx.timers.apply_walltime,
           "solve_call_s_first": t_call,
           "factor_ms_steady": [1e3 * t for t in factor_s],
           "solve_ms_steady": [1e3 * t for t in solve_s],
           "factor_ms": 1e3 * statistics.median(factor_s),
           "solve_ms": 1e3 * statistics.median(solve_s),
           "iters_repeat": iters, "launches": counts,
           "launches_by_card": by_card,
           "peak_mib_by_card": {
               i: torch.cuda.max_memory_allocated(i) / 2 ** 20
               for i in cards}}
    print(f"[{label}] " + json.dumps(rec), flush=True)
    if not info.converged or relres > relres_max:
        fail(f"{label}: converged {info.converged}, true relres {relres} "
             f"(at most {relres_max})")
    if iters != [info.iters] * reps:
        fail(f"{label}: repeated solves took {iters} iterations, not "
             f"{info.iters}")
    return rec, ds, x


def dist_main(A, b) -> dict:
    """[dist-main]: the [krylov-main] system (160³, f32, seeded b) through
    ``solve(..., mesh=make_mesh(devices=["cuda:0"] * 4))`` with ILU(0) 4,4
    and BiCGSTAB at rtol 1e-5: the banded distributed route, the true
    residual within 1.1·rtol, K1 once per shard per SpMV (the interior
    pass), K2 8 times per shard per apply (4 + 4 sweeps), no K3/K4 (the
    scalar distributed factor is plain sweeps, as in JAX); then the same
    solve on a one-shard mesh.  Returns the launches of both solves."""
    opts = dict(ILU44_OPTS, rtol=KRYLOV_RTOL)
    nsw = int(opts["blasted_async_sweeps"].split(",")[1])
    total = dict.fromkeys(_cuda.launches, 0)
    recs = {}
    for nshards in (DIST_SHARDS, 1):
        rec, ds, _ = dist_run(f"dist-main] [{nshards} shard(s)", A, b,
                              opts, card_mesh(nshards), KRYLOV_RELRES)
        if rec["route"] != "DistDiaSolver":
            fail(f"dist-main: took {rec['route']}")
        it = rec["iters"]
        expect_launches(f"dist-main {nshards}", rec["launches"],
                        {"dia_spmv": nshards * (2 * it + 1),
                         "tri_sweep": nshards * 2 * nsw * 2 * it})
        for k, v in rec["launches"].items():
            total[k] += v
        recs[nshards] = rec
        shard_twins(f"dist-main] [{nshards} shard(s)", ds, 0, seed=31)
        del ds
    one, four = recs[1], recs[DIST_SHARDS]
    print("[dist-main] " + json.dumps({
        "iters_4_vs_1": [four["iters"], one["iters"]],
        "solve_ms_4_vs_1": [four["solve_ms"], one["solve_ms"]],
        "factor_ms_4_vs_1": [four["factor_ms"], one["factor_ms"]]}),
        flush=True)
    torch.cuda.empty_cache()
    return total


def dist_block_main(B, bb) -> dict:
    """[dist-block-main]: the [block-main] system (bs = 4, 128³ blocks,
    f32) over four shards: the banded block route on the compressed factor
    (K6: nbuild − 1 Dinv and one U0 sweep per shard, two block inverses per
    shard), K5 once per shard per SpMV.  Returns its launches."""
    rec, ds, _ = dist_run("dist-block-main", B, bb, ILU44_OPTS,
                          card_mesh(DIST_SHARDS), MAIN_RELRES)
    if rec["route"] != "DistBlockDiaSolver" or not ds.compressed:
        fail(f"dist-block-main: took {rec['route']}, compressed "
             f"{getattr(ds, 'compressed', None)}")
    nbuild = int(ILU44_OPTS["blasted_async_sweeps"].split(",")[0])
    P, it = DIST_SHARDS, rec["iters"]
    expect_launches("dist-block-main", rec["launches"],
                    {"bspmv": P * (2 * it + 1), "bfactor_dinv": P * (nbuild - 1),
                     "bfactor_u0": P, "block_inverse": 2 * P})
    shard_twins("dist-block-main", ds, 0, seed=32)
    del ds
    torch.cuda.empty_cache()
    return rec["launches"]


MODE_KERNELS = {"banded-dia": {"dia_spmv": None, "tri_sweep": None},
                "mesh-2d": {"dia_spmv": None, "tri_sweep": None},
                "block-dia": {"bspmv": None, "bfactor_dinv": None,
                              "bfactor_u0": None, "block_inverse": None}}


def dist_modes() -> None:
    """[dist-modes]: the six modes of the distributed dry run
    (``parallel/dryrun.py``) on four shards of the card, float32, at
    DIST_MODE_SIZES, each through ``solve(..., mesh=...)`` for the dry
    run's two iterations (three CG steps for AMG), asserting its route and
    the kernels it launches (the general modes and AMG none); then one
    distributed AMG cycle, bitwise the same with TF32 matmuls allowed and
    not (C4)."""
    for name, why in CUTS.items():
        print(f"[dist-modes] [{name}] cut to {why}", flush=True)
    cases = dryrun_cases(DIST_SHARDS, dtype=np.float32, **DIST_MODE_SIZES)
    for case in cases:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        (_, x, info, ctx), = dryrun_multichip(["cuda:0"] * DIST_SHARDS,
                                              [case])
        torch.cuda.synchronize()
        rec = {"route": type(ctx.prec).__name__, "n": case.A.nrows,
               "mesh": list(ctx.prec.mesh.shape), "iters": info.iters,
               "relres_recursive": info.resnorm / info.bnorm,
               "seconds": time.perf_counter() - t0,
               "launches": {k: v for k, v in _cuda.launches.items() if v}}
        print(f"[dist-modes] [{case.name}] " + json.dumps(rec), flush=True)
        expect_launches(case.name, dict(_cuda.launches),
                        MODE_KERNELS.get(case.name, {}))
        if case.name in ("banded-dia", "block-dia"):
            # uneven: the last shard holds the identity-padded rows
            shard_twins(f"dist-modes] [{case.name}", ctx.prec,
                        DIST_SHARDS - 1, seed=33)
        if case.name == "amg":
            ds = ctx.prec
            r = shard_vector(ds.mesh, np.pad(
                case.b, (0, ds.levels[0].n - case.b.shape[0])))
            out = []
            for allow in (True, False):
                torch.backends.cuda.matmul.allow_tf32 = allow
                out.append(ds.prec_apply(r).gather())
            torch.backends.cuda.matmul.allow_tf32 = False
            if not torch.equal(out[0], out[1]):
                fail("dist-modes: the distributed AMG cycle moved with "
                     "TF32 allowed")
            print("[tf32] distributed AMG cycle bitwise equal with TF32 "
                  "matmuls allowed and not", flush=True)
        del ctx
    torch.cuda.empty_cache()


def dist_device_independence() -> None:
    """[dist-device-independence]: the six modes at DIST_CHECK_SIZES in
    float64, and the banded mode with each banded pc_type (jacobi, gs, sgs,
    ilu0) and with sai (R3: the general route), solved to rtol 1e-8 on four
    shards of the card and on four CPU shards: the same route, the same
    iterations, x within 1e-8 (card and CPU sum in their own orders)."""
    import dataclasses

    cases = dryrun_cases(DIST_SHARDS, rtol=1e-8, maxiter=500,
                         **DIST_CHECK_SIZES)
    # the generator's b is an eigenvector of the uniform-grid Laplacian
    # (Jacobi would stop after one step): b = A·x_ref, seeded
    x_ref = np.random.default_rng(X_REF_SEED).uniform(-1.0, 1.0, 1331)
    cases = [dataclasses.replace(c, b=c.A.to_scipy() @ x_ref)
             if c.A.nrows == x_ref.shape[0] else c for c in cases]
    banded = cases[1]
    for pc in ("jacobi", "gs", "sgs"):
        cases.append(dataclasses.replace(
            banded, name=f"banded-dia {pc}",
            options=dict(banded.options, blasted_pc_type=pc)))
    cases.append(dataclasses.replace(
        banded, name="banded-dia sai (R3)", route="DistributedSolver",
        options=dict(banded.options, blasted_pc_type="sai")))
    for case in cases:
        got = {}
        for dev in ("cuda:0", "cpu"):
            mesh = make_mesh(devices=[dev] * DIST_SHARDS,
                             shape=case.mesh_shape)
            x, info, ctx = solve(case.A, case.b, case.options, mesh=mesh)
            got[dev] = (x.cpu(), info, type(ctx.prec).__name__)
        (xg, ig, rg), (xc, ic, rc) = got["cuda:0"], got["cpu"]
        rel = float(torch.linalg.norm(xg - xc) / torch.linalg.norm(xc))
        rec = {"n": case.A.nrows, "route": [rg, rc],
               "iters": [ig.iters, ic.iters],
               "converged": [ig.converged, ic.converged],
               "x_rel_diff": rel,
               "relres_true_cuda": true_relres(case.A, case.b, xg)}
        print(f"[dist-device-independence] [{case.name}] " + json.dumps(rec),
              flush=True)
        if not (ig.converged and ic.converged) or rg != rc \
                or rg != case.route or ig.iters != ic.iters or rel > 1e-8:
            fail(f"dist-device-independence {case.name}: {rec}")

def card_relres(D, b: torch.Tensor, x: torch.Tensor) -> float:
    """‖b − A x‖/‖b‖ of the device matrix ``D`` on the card in float64,
    through the plain twins (K1's or K5's; no launch is counted)."""
    bd, xd = b.double(), x.double()
    if isinstance(D, DiaMatrix):
        y = stencil.dia_spmv_ref(D.offsets, D.data.double(), xd)
    else:
        y = bstencil.bdia_spmv_ref(D.offsets, D.data.double(),
                                   xd.reshape(-1, D.bs)).reshape(-1)
    return float(torch.linalg.norm(bd - y) / torch.linalg.norm(bd))


def poisson_band_on_card(g: int, dtype) -> DiaMatrix:
    """The uniform-grid 7-point Poisson operator of ``poisson3d_system``
    with g³ interior points (h = 2/(g + 1)), built as a DIA matrix on the
    card: at g = 288 the host CSR of 167 M entries would take a minute."""
    n = g ** 3
    idx = torch.arange(n, device="cuda")
    i0, j0, k0 = idx % g, (idx // g) % g, idx // (g * g)
    mask = torch.stack([k0 > 0, j0 > 0, i0 > 0,
                        torch.ones_like(i0, dtype=torch.bool),
                        i0 < g - 1, j0 < g - 1, k0 < g - 1])
    del idx, i0, j0, k0
    inv_h2 = ((g + 1) / 2.0) ** 2
    coef = torch.full((7, 1), -inv_h2, dtype=dtype, device="cuda")
    coef[3] = 6.0 * inv_h2
    return DiaMatrix(data=torch.where(mask, coef, 0.0).contiguous(),
                     mask=mask, offsets=(-g * g, -g, -1, 0, 1, g, g * g))


def compressed_factor_twin(D: DiaMatrix, nsweeps: int) -> torch.Tensor:
    """``stencil.dia_factor_sweeps_stencil`` from the original values of
    ``D`` (FactInit ORIGINAL, no scaling) with K3's and K4's plain twins in
    place of the kernels."""
    offsets, pairs = D.offsets, dia_pairs(D.offsets)
    d0, base = offsets.index(0), D.data
    lowers = [d for d, o in enumerate(offsets) if o < 0]
    pair_offs = tuple(o1 for (_, _, o1) in pairs[d0])
    base_pl = torch.stack([base[dl] for (dl, _, _) in pairs[d0]])
    ubs = torch.stack([shift_read(base[du], o1) for (_, du, o1) in pairs[d0]])
    u0_prev = u0_last = base[d0].contiguous()
    for _ in range(nsweeps):
        u0_prev, u0_last = u0_last, stencil.factor_u0_ref(
            pair_offs, base[d0], base_pl, ubs, u0_last)
    res = base.clone()
    res[lowers] = stencil.factor_lower_ref(
        tuple(offsets[d] for d in lowers), base[lowers], u0_prev)
    res[d0] = u0_last
    return res


def main_compressed() -> dict:
    """[main-compressed]: the Poisson band of a 288³ grid in float32 (data
    and factor 0.67 GB each), past JAX's halo gate: ILU(0) 4,4 through
    ``setup_local_preconditioner`` and ``compute_preconditioner`` on the
    compressed route (K3 four times, K4 once), then BiCGSTAB at rtol 1e-5
    with b = A·x_ref, x_ref uniform in [−1, 1] from a seed (K1 once per
    SpMV, K2 in the applies); the true residual in float64 on the card
    within 1.1·rtol; two steady re-factors and re-solves.  Returns the
    launches."""
    g = COMPRESSED_G
    t0 = time.perf_counter()
    D = poisson_band_on_card(g, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(X_REF_SEED)
    x_ref = torch.rand(D.nrows, generator=gen, device="cuda") * 2.0 - 1.0
    b = stencil.dia_spmv_ref(D.offsets, D.data, x_ref)
    del x_ref
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    opts = dict(ILU44_OPTS, rtol=KRYLOV_RTOL)
    route = stencil.factor_takes_compressed_route(
        D.offsets, dia_pairs(D.offsets), True, 4, FactInit.ORIGINAL,
        D.nrows, 4)
    if not route:
        fail("main-compressed: the route rule refuses the 288³ f32 band")
    total = dict.fromkeys(_cuda.launches, 0)
    factor_s, solve_s, iters = [], [], []
    ctx = setup_local_preconditioner(D, opts)
    if not isinstance(ctx.prec, DiaILU0Preconditioner):
        fail(f"main-compressed: {type(ctx.prec).__name__}")
    for rep in range(3):
        _cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compute_preconditioner(ctx)
        torch.cuda.synchronize()
        factor_s.append(time.perf_counter() - t0)
        fac = dict(_cuda.launches)
        if rep == 0:
            # the factor of the path, bit for bit that of K3's and K4's
            # twins on the same operands at this shape
            twin = compressed_factor_twin(D, 4)
            factor_err = float((ctx.prec.state.ilu - twin).abs().max())
            if not torch.equal(ctx.prec.state.ilu, twin):
                fail(f"main-compressed: the factor differs from its plain "
                     f"twin's by {factor_err}")
            del twin
        _cuda.reset_launches()
        t0 = time.perf_counter()
        x, info = solvers.bicgstab(lambda v: spmv(D, v), ctx.prec.apply_flat,
                                   b, torch.zeros_like(b), tol=opts["rtol"],
                                   maxiter=opts["maxiter"])
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t0)
        sol = dict(_cuda.launches)
        iters.append(info.iters)
        if rep == 0:
            expect_launches("main-compressed factor", fac,
                            {"factor_u0": 4, "factor_lower": 1})
            expect_launches("main-compressed solve", sol,
                            {"dia_spmv": 2 * info.iters + 1,
                             "tri_sweep": None})
            for k in total:
                total[k] = fac[k] + sol[k]
            relres = card_relres(D, b, x)
            first = {"n": D.nrows, "g": g, "route": "compressed (K3/K4)",
                     "factor_max_abs_err_vs_twin": factor_err,
                     "factor_launches": {k: v for k, v in fac.items() if v},
                     "solve_launches": {k: v for k, v in sol.items() if v},
                     "converged": info.converged, "iters": info.iters,
                     "breakdown": info.breakdown,
                     "relres_recursive": info.resnorm / info.bnorm,
                     "relres_true": relres, "build_s": t_build}
    rec = {**first, "factor_s": factor_s, "solve_s": solve_s,
           "iters_repeat": iters,
           "factor_ms_steady": 1e3 * statistics.median(factor_s[1:]),
           "solve_ms_steady": 1e3 * statistics.median(solve_s[1:])}
    print("[main-compressed] " + json.dumps(rec), flush=True)
    if not first["converged"] or relres > KRYLOV_RELRES:
        fail(f"main-compressed: converged {first['converged']}, true "
             f"relres {relres} > {KRYLOV_RELRES}")
    if iters != [iters[0]] * 3:
        fail(f"main-compressed: repeated solves took {iters} iterations")
    del ctx, D, b, x
    torch.cuda.empty_cache()
    return total


def perturbed(D) -> np.ndarray:
    """The band values of ``D`` (float64, host) with each matrix row
    scaled by 1 + 0.05·N(0, 1), seed 99: JAX's ``_perturbed_vals`` draw
    (tests/test_update.py) taken once per row.  Drawn once per entry, as
    there, it leaves the 160³ Laplacian nearly singular (about 45 % of the
    rows lose diagonal dominance; BiCGSTAB + ILU(0) 8,4 then takes 22
    iterations at 32³ and 469 at 64³ on the CPU, and does not reach 1e-5 in
    800 at 160³ on the card)."""
    vals = D.data.cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(NEWTON_SEED)
    f = 1.0 + NEWTON_SCALE * rng.standard_normal(D.nrows)
    bs = getattr(D, "bs", 1)
    if bs == 1:
        return vals * f
    k, _, nb = vals.shape
    rows = f.reshape(nb, bs).T                  # (bs, nb): row r·bs + i
    return (vals.reshape(k, bs, bs, nb)
            * rows[None, :, None, :]).reshape(vals.shape)


def newton_case(label: str, M, b, opts: dict, want_factor: dict) -> dict:
    """One Newton step through the user entry points: ``solve``; perturb
    the device matrix's band values (``perturbed``);
    ``ctx.prec.update_values`` and
    ``compute_preconditioner`` (``want_factor``: the kernels that factor
    launches); BiCGSTAB again with the updated operator, its true residual
    (float64, on the card) within 1.1·rtol.  The factor must differ from
    the one before the update and, with FactInit ORIGINAL, equal bit for
    bit a fresh context's on the updated matrix.  Returns the launches of
    the update's factor and solve."""
    x, info, ctx = solve(M, b, opts)
    torch.cuda.synchronize()
    first_factor_s = ctx.timers.factor_walltime
    D0 = ctx.prec.mat
    ilu0 = ctx.prec.state.ilu.clone()
    t0 = time.perf_counter()
    new = perturbed(D0)
    t_perturb = time.perf_counter() - t0
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx.prec.update_values(new)
    torch.cuda.synchronize()
    t_update = time.perf_counter() - t0
    t0 = time.perf_counter()
    compute_preconditioner(ctx)
    torch.cuda.synchronize()
    factor_s = time.perf_counter() - t0
    fac = dict(_cuda.launches)
    D = ctx.prec.mat
    if D.data.data_ptr() == D0.data.data_ptr() or D.mask is not D0.mask:
        fail(f"{label}: the update did not replace the values only")
    bt = torch.from_numpy(b).to("cuda")
    _cuda.reset_launches()
    t0 = time.perf_counter()
    x2, info2 = solvers.bicgstab(operator(ctx), ctx.prec.apply_flat, bt,
                                 torch.zeros_like(bt), tol=opts["rtol"],
                                 maxiter=opts["maxiter"])
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    sol = dict(_cuda.launches)
    # the re-factor read the new values: its factor moved and, from the
    # original values, equals a fresh context's on the updated matrix
    ilu = ctx.prec.state.ilu
    refactored = not torch.equal(ilu, ilu0)
    fresh_equal = None
    if opts["blasted_async_fact_init_type"] == "init_original":
        fresh = setup_local_preconditioner(D, opts)
        compute_preconditioner(fresh)
        fresh_equal = torch.equal(fresh.prec.state.ilu, ilu)
        del fresh
    del ilu0
    relres0 = card_relres(D0, bt, x)
    relres = card_relres(D, bt, x2)
    spmv_name = "bspmv" if getattr(D, "bs", 1) > 1 else "dia_spmv"
    rec = {"fact_init": opts["blasted_async_fact_init_type"],
           "iters_before": info.iters, "iters_after": info2.iters,
           "relres_true_before": relres0, "relres_true_after": relres,
           "factor_s_first": first_factor_s,
           "factor_s_after_update": factor_s,
           "update_values_s": t_update, "perturb_host_s": t_perturb,
           "solve_s_after_update": solve_s,
           "factor_moved": refactored, "equals_fresh_factor": fresh_equal,
           "factor_launches": {k: v for k, v in fac.items() if v},
           "solve_launches": {k: v for k, v in sol.items() if v}}
    print(f"[newton] [{label}] " + json.dumps(rec), flush=True)
    if not (info.converged and info2.converged):
        fail(f"{label}: did not converge: {rec}")
    if max(relres0, relres) > KRYLOV_RELRES:
        fail(f"{label}: true relres {relres0}, {relres} > {KRYLOV_RELRES}")
    if not refactored or fresh_equal is False:
        fail(f"{label}: the factor after the update is stale: {rec}")
    expect_launches(f"{label} factor", fac, want_factor)
    expect_launches(f"{label} solve", sol,
                    {spmv_name: 2 * info2.iters + 1,
                     **({"tri_sweep": None} if spmv_name == "dia_spmv"
                        else {})})
    del ctx
    return {k: fac[k] + sol[k] for k in fac}


def newton(A, b, B, bb) -> dict:
    """[newton]: the Newton-step workflow on the seeded 160³ f32 system and
    on the bs = 4 [block-main] system, ILU(0) 8,4, once with FactInit
    ORIGINAL and once with NONE (the warm start from the previous factor,
    plain route: C2).  The scalar factor launches no kernel either way (the
    160³ band is below JAX's gate); the block factor runs K6 only with
    ORIGINAL.  Returns the launches."""
    total = dict.fromkeys(_cuda.launches, 0)
    nbuild = int(NEWTON_OPTS["blasted_async_sweeps"].split(",")[0])
    cases = [
        ("scalar original", A, b, "init_original", {}),
        ("scalar none", A, b, "init_none", {}),
        ("block original", B, bb, "init_original",
         {"bfactor_dinv": nbuild - 1, "bfactor_u0": 1,
          "block_inverse": None}),
        ("block none", B, bb, "init_none", {"block_inverse": None}),
    ]
    for label, M, rhs, init, want in cases:
        opts = dict(NEWTON_OPTS, blasted_async_fact_init_type=init)
        for k, v in newton_case(label, M, rhs, opts, want).items():
            total[k] += v
        torch.cuda.empty_cache()
    return total


def refined() -> None:
    """[refined]: ``solve_refined`` on the seeded 160³ system (float64 on
    the host, float32 inner solves on the card with ILU(0) 8,4 and the
    preconditioner of the first pass), to rtol 1e-10 in float64: the
    passes, the total iterations, the true relres."""
    t0 = time.perf_counter()
    A, b = seeded_poisson(MAIN_NPTS, np.float64)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info, ctx = solve_refined(A, b, dict(MAIN_OPTS, rtol=REFINED_RTOL),
                                 nrefine=REFINED_NREFINE)
    wall = time.perf_counter() - t0
    relres = float(np.linalg.norm(b - A.to_scipy() @ x) / np.linalg.norm(b))
    rec = {"n": A.nrows, "passes": ctx.passes, "iters_total": info.iters,
           "converged": info.converged, "breakdown": info.breakdown,
           "relres_true_f64": relres, "inner_dtype": str(ctx.prec.mat.dtype),
           "inner_device": str(ctx.prec.device), "seconds": wall,
           "host_system_s": t_host}
    print("[refined] " + json.dumps(rec), flush=True)
    if not info.converged or relres > REFINED_RTOL or \
            ctx.prec.mat.dtype != torch.float32 or \
            ctx.prec.device.type != "cuda" or not np.all(np.isfinite(x)):
        fail(f"refined: {rec}")


def mixed(A, b, main_rec: dict) -> dict:
    """[mixed]: [main]'s system and options with ``-blasted_apply_dtype
    bfloat16``: the factors stored in bfloat16, so the apply takes the
    plain shifted products in float32 (JAX's rule) and launches no K2; K1
    once per SpMV.  Prints the iterations and steady solve ms against
    [main]'s.  Returns the launches."""
    opts = dict(MAIN_OPTS, blasted_apply_dtype="bfloat16")
    rec, ctx = run_main("mixed", A, b, 0.0,
                        {"n": A.nrows, "host_system": "reused"}, opts)
    if ctx.prec.state.ilu.dtype != torch.bfloat16:
        fail(f"mixed: the factor is stored in {ctx.prec.state.ilu.dtype}")
    expect_launches("mixed", rec["launches"],
                    {"dia_spmv": 2 * rec["iters"] + 1})
    print("[mixed] " + json.dumps({
        "iters_mixed_vs_main": [rec["iters"], main_rec["iters"]],
        "solve_ms_steady_mixed_vs_main": [1e3 * rec["solve_s"],
                                          1e3 * main_rec["solve_s"]],
        "factor_ms_steady_mixed_vs_main": [1e3 * rec["factor_s"],
                                           1e3 * main_rec["factor_s"]]}),
        flush=True)
    del ctx
    torch.cuda.empty_cache()
    return rec["launches"]


def coo_of(A: CSRMatrix) -> COOMatrix:
    rows = np.repeat(np.arange(A.nrows, dtype=np.int32), np.diff(A.rowptr))
    return COOMatrix(A.nrows, A.nrows, rows, A.colind.astype(np.int32),
                     A.vals.astype(np.float64))


def io_phase(A, b, main_iters: int) -> None:
    """[io]: [main]'s float32 system and b written with the port's PETSc
    binary writer (float64 values, about 360 MB) into a temporary directory
    of the checkout, read back (each entry equal), and solved through
    ``apps.testsolve`` on the card in float32 with [main]'s options: the
    same iterations as [main].  Then a Matrix-Market round trip, cut to
    32³: text I/O of 28.5 M entries would take minutes."""
    here = os.path.dirname(os.path.abspath(__file__))
    coo = coo_of(A)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_io_",
                                     dir=here) as d:
        pm, pv = os.path.join(d, "A.pmat"), os.path.join(d, "b.pmat")
        t0 = time.perf_counter()
        write_petsc_matrix(pm, coo)
        write_petsc_vector(pv, b)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, bv = read_petsc_matrix(pm), read_petsc_vector(pv)
        t_read = time.perf_counter() - t0
        same = (np.array_equal(back.row, coo.row)
                and np.array_equal(back.col, coo.col)
                and np.array_equal(back.val.astype(np.float32), A.vals)
                and np.array_equal(bv.astype(np.float32), b))
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = testsolve.main([
                "--matrix", pm, "--rhs", pv, "--device", "cuda",
                "--dtype", "float32", "--prec", "ilu0",
                "--build-sweeps", MAIN_OPTS["blasted_async_sweeps"][0],
                "--apply-sweeps", MAIN_OPTS["blasted_async_sweeps"][2],
                "--tol", str(MAIN_OPTS["rtol"]),
                "--maxiter", str(MAIN_OPTS["maxiter"])])
        t_solve = time.perf_counter() - t0
        text = out.getvalue()
        iters = int(text.split("iters=")[1].split()[0]) \
            if "iters=" in text else -1
        rec = {"bytes": os.path.getsize(pm) + os.path.getsize(pv),
               "write_s": t_write, "read_s": t_read, "entries_equal": same,
               "testsolve_rc": rc, "testsolve_s": t_solve,
               "iters_testsolve_vs_main": [iters, main_iters],
               "testsolve_out": text.strip().splitlines()}
        print("[io] [petsc] " + json.dumps(rec), flush=True)
        if not same or rc != 0 or iters != main_iters:
            fail(f"io petsc: {rec}")
        A32, _, _ = poisson3d_system((MM_NPTS,) * 3, dist="uniform")
        m = coo_of(A32)
        mm = os.path.join(d, "A.mtx")
        t0 = time.perf_counter()
        write_matrix_market(mm, m)
        m2 = read_matrix_market(mm)
        mrec = {"n": A32.nrows, "nnz": m.nnz, "seconds":
                time.perf_counter() - t0,
                "cut": f"{MM_NPTS - 2}³: Matrix-Market text I/O of the "
                       "160³ system's 28.5 M entries would take minutes",
                "entries_equal": bool(np.array_equal(m2.row, m.row)
                                      and np.array_equal(m2.col, m.col)
                                      and np.array_equal(m2.val, m.val))}
        print("[io] [matrix-market] " + json.dumps(mrec), flush=True)
        if not mrec["entries_equal"]:
            fail(f"io matrix market: {mrec}")


# ------------------------------------------------------------ --cards 4 ----
# ``python3 chip_smoke.py --cards 4``: the distributed path across four
# cards, one shard per card of ``make_mesh()`` (cuda:0 ... cuda:3)
MC_CARDS = 4
# one face of a 160² slab: the rows of a halo-sized copy ([mc-topology])
# and of each inner face of [mc-weak] (25,600)
HALO_ROWS = (MAIN_NPTS - 2) ** 2
# [mc-weak]: interior 160 × 160 × 640 with z the slowest index, so each
# card holds a 160³ slab, [main]'s size (n = 16,384,000 in all)
MC_WEAK_NPTS = (MAIN_NPTS, MAIN_NPTS, MC_CARDS * (MAIN_NPTS - 2) + 2)
# [mc-dist-modes]: x of a mode that is not bitwise equal over the cards
# and over one card must lie within [dist-device-independence]'s bound
MC_MODES_XTOL = 1e-8


def mc_topology(mesh) -> dict:
    """[mc-topology]: how the cards are joined (``nvidia-smi topo -m``),
    which pairs have peer access, and the device time of one halo-sized
    copy (HALO_ROWS f32) from cuda:1 to cuda:0 and of one 0-d copy (a
    Krylov scalar or a dot partial) from cuda:3 to cuda:0.  PyTorch runs a
    copy between cards on the source card's stream, so each is timed
    there (``cuda_ms``, with the host's enqueue time beside it)."""
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True)
    print(f"[mc-topology] nvidia-smi topo -m (exit {topo.returncode}):\n"
          f"{topo.stdout}{topo.stderr}", flush=True)
    idx = [d.index for d in mesh.devices]
    rec = {"peer_access": {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
                           for a in idx for b in idx if a != b}}
    for key, src, shape in (("halo_copy", mesh.devices[1], (HALO_ROWS,)),
                            ("scalar_copy", mesh.devices[-1], ())):
        t = torch.ones(shape, dtype=torch.float32, device=src)
        with torch.cuda.device(src):
            ms, host_ms = cuda_ms(lambda: t.to(mesh.first))
        rec[key] = {"from": str(src), "to": str(mesh.first),
                    "bytes": t.numel() * 4, "device_us": 1e3 * ms,
                    "host_us": 1e3 * host_ms}
    print("[mc-topology] " + json.dumps(rec), flush=True)
    return rec


def mc_kernel(mesh) -> dict:
    """[mc-kernel]: every kernel on every card of the mesh at the f32
    shapes of [kernel] (K1-K4 on the 160³ band, K5, K6 in both modes and
    the block inverse at bs = 4, g = 128), each held bitwise to its twin on
    the same card, its launches counted on that card and no other, and its
    device time taken on each card (the twin's and the library call's on
    the first card only: they repeat the kernel's work, not the card's).
    Then a call made while the current device is cuda:0, on operands of
    cuda:2, must be counted on card 2; a call whose operands lie on two
    cards, and a launch of operands that are not on the current card, must
    raise.  Returns per-kernel records for the kernels line."""
    g, dtype = MAIN_NPTS - 2, torch.float32
    n, nb, isz = g ** 3, BLOCK_G ** 3, dtype.itemsize
    out = {}
    for dev in mesh.devices:
        _cuda.reset_launches()
        op = band_operands(g, dtype, dev, seed=1)
        bop = block_operands(BLOCK_G, BLOCK_BS, dtype, dev, seed=3)
        npair = len(bop["pair_offs"])
        scalar = kernel_cases(op)
        cases = {**scalar, **block_kernel_cases(bop)}
        for name, pairs in cases.items():
            rec = compare(name, f"{dev}", pairs, dtype)
            if rec["max_abs_err"] != 0.0:
                fail(f"[mc-kernel] {name} on {dev}: not bitwise equal to "
                     f"its twin ({rec})")
            kernel, twin = pairs[-1]
            with torch.cuda.device(dev):
                if dev == mesh.first:
                    if name in scalar:
                        timed(rec, kernel, twin, *scalar_work(name, n, isz),
                              dtype, scalar_library(name, op))
                        rec["shape"] = f"g={g} n={n} float32"
                    else:
                        timed(rec, kernel, twin,
                              *block_work(name, nb, BLOCK_BS, npair, isz),
                              dtype, block_library_of(name, bop))
                        rec["shape"] = (f"bs={BLOCK_BS} g={BLOCK_G} nb={nb} "
                                        "float32")
                    if name == "tri_sweep":
                        lower_timed(rec, op, pairs[0][0], n, dtype)
                    rec["ms_by_card"] = {}
                    out[name] = rec
                ms = rec["ms"] if dev == mesh.first else cuda_ms(kernel)[0]
            out[name]["ms_by_card"][dev.index] = ms
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                           rec["max_abs_err"])
        by_card = {k: dict(v) for k, v in _cuda.launches_by_device.items()
                   if v}
        if set(by_card) != set(cases) or \
                any(set(v) != {dev.index} for v in by_card.values()):
            fail(f"[mc-kernel] {dev}: launches by card {by_card}")
        print(f"[mc-kernel] {dev}: all {len(cases)} kernels bitwise equal to "
              f"their twins, launches by card {json.dumps(by_card)}",
              flush=True)
        del op, bop, scalar, cases
        torch.cuda.empty_cache()
    for name, rec in out.items():
        print(f"[mc-kernel] {name}: " + json.dumps(rec), flush=True)
    mc_cross_card(mesh, dtype)
    return out


def mc_cross_card(mesh, dtype) -> None:
    """The launch guard across cards (the end of [mc-kernel])."""
    c1, c2 = mesh.devices[1], mesh.devices[2]
    on2, on1 = (band_operands(16, dtype, c, seed=9) for c in (c2, c1))
    bon2, bon1 = (block_operands(8, BLOCK_BS, dtype, c, seed=9)
                  for c in (c2, c1))
    offs = on2["offsets"]
    _cuda.reset_launches()
    with torch.cuda.device(mesh.first):
        y = stencil.dia_spmv_stencil(offs, on2["data"], on2["x"])
        want = stencil.dia_spmv_ref(offs, on2["data"], on2["x"])
        if y.device != c2 or not torch.equal(y, want):
            fail(f"[mc-kernel] K1 on {c2} called from {mesh.first}: y on "
                 f"{y.device}, bitwise {torch.equal(y, want)}")
        raised = {}
        for label, call, exc in (
                ("K1 with data on cuda:2 and x on cuda:1",
                 lambda: stencil.dia_spmv_stencil(offs, on2["data"],
                                                  on1["x"]), TypeError),
                ("K5 with data on cuda:2 and x on cuda:1",
                 lambda: bstencil.bdia_spmv_stencil(
                     bon2["offsets"], bon2["data"], bon1["x"]), TypeError),
                ("a launch of cuda:2 operands while cuda:0 is current",
                 lambda: _cuda.launch("dia_spmv", "bt_dia_spmv", c2),
                 RuntimeError)):
            try:
                call()
            except exc as e:
                raised[label] = str(e)
            else:
                fail(f"[mc-kernel] {label} did not raise")
    by_card = {k: dict(v) for k, v in _cuda.launches_by_device.items() if v}
    if by_card != {"dia_spmv": {c2.index: 1}}:
        fail(f"[mc-kernel] cross-card checks: launches by card {by_card}")
    print("[mc-kernel] K1 on cuda:2 operands, called with cuda:0 current: "
          f"bitwise equal to its twin, launches by card {by_card}; raised: "
          + json.dumps(raised), flush=True)


def per_card(mesh, per_shard: dict) -> dict:
    """The launches by card that ``per_shard`` launches on every shard of
    ``mesh`` make (a card holding k shards launches k times as many)."""
    shards_on = {}
    for d in mesh.devices:
        shards_on[d.index] = shards_on.get(d.index, 0) + 1
    return {k: {i: c * v for i, c in shards_on.items()}
            for k, v in per_shard.items() if v}


def mc_solves(label: str, A, b, opts: dict, mesh, relres_max: float,
              route: str, per_shard, one_shard: bool, seed: int) -> dict:
    """One system solved over the cards of ``mesh``, over as many shards
    of its first card and, with ``one_shard``, over one shard: the route,
    the true residual, each card launching ``per_shard(iters)`` per shard
    it holds, x and the iterations over the cards equal to the bit to those
    over one card; then ``shard_twins`` on the last shard, which lives on
    the last card.  Returns the records by run."""
    P = mesh.size
    runs = {"cards": mesh, "one card": make_mesh(devices=[mesh.first] * P)}
    if one_shard:
        runs["one shard"] = make_mesh(devices=[mesh.first])
    recs, xs = {}, {}
    for key, m in runs.items():
        rec, ds, x = dist_run(f"{label}] [{key}", A, b, opts, m, relres_max)
        if rec["route"] != route:
            fail(f"{label} {key}: took {rec['route']}, not {route}")
        want = per_card(m, per_shard(rec["iters"]))
        if rec["launches_by_card"] != want:
            fail(f"{label} {key}: launches by card "
                 f"{rec['launches_by_card']}, expected {want}")
        if key == "cards":
            shard_twins(label, ds, P - 1, seed)
        recs[key], xs[key] = rec, x.cpu()
        del ds, x
        torch.cuda.empty_cache()
    cards, one = recs["cards"], recs["one card"]
    same = cards["iters"] == one["iters"] and torch.equal(xs["cards"],
                                                          xs["one card"])
    summary = {"iters": {k: r["iters"] for k, r in recs.items()},
               "x_bitwise_cards_vs_one_card": same,
               "factor_ms": {k: r["factor_ms"] for k, r in recs.items()},
               "solve_ms": {k: r["solve_ms"] for k, r in recs.items()},
               "peak_mib_by_card": {k: r["peak_mib_by_card"]
                                    for k, r in recs.items()}}
    print(f"[{label}] " + json.dumps(summary), flush=True)
    if not same:
        fail(f"{label}: x or the iterations over the cards differ from "
             f"those over one card ({cards['iters']} vs {one['iters']}, "
             f"max |dx| {float((xs['cards'] - xs['one card']).abs().max())})")
    return recs


def mc_dist_main(mesh, A, b) -> dict:
    """[mc-dist-main]: [dist-main]'s system (the seeded 160³ Poisson, f32,
    ILU(0) 4,4 on plain sweeps, BiCGSTAB at rtol 1e-5) over the four cards,
    over four shards of cuda:0 and over one shard: each card launches
    K1 = 2·it + 1 and K2 = 16·it per shard it holds, no K3/K4."""
    opts = dict(ILU44_OPTS, rtol=KRYLOV_RTOL)
    nsw = int(opts["blasted_async_sweeps"].split(",")[1])
    return mc_solves("mc-dist-main", A, b, opts, mesh, KRYLOV_RELRES,
                     "DistDiaSolver",
                     lambda it: {"dia_spmv": 2 * it + 1,
                                 "tri_sweep": 2 * nsw * 2 * it},
                     one_shard=True, seed=31)


def mc_dist_block_main(mesh, B, bb) -> dict:
    """[mc-dist-block-main]: [dist-block-main]'s system (bs = 4, 128³
    blocks, f32, block ILU(0) 4,4 on the compressed factor) over the four
    cards and over four shards of cuda:0: each card launches K5 = 2·it + 1,
    three K6 Dinv sweeps, one K6 U0 sweep and two block inverses per shard
    it holds."""
    nbuild = int(ILU44_OPTS["blasted_async_sweeps"].split(",")[0])
    return mc_solves("mc-dist-block-main", B, bb, ILU44_OPTS, mesh,
                     MAIN_RELRES, "DistBlockDiaSolver",
                     lambda it: {"bspmv": 2 * it + 1,
                                 "bfactor_dinv": nbuild - 1,
                                 "bfactor_u0": 1, "block_inverse": 2},
                     one_shard=False, seed=32)


def mc_weak(mesh, one_shard: dict) -> dict:
    """[mc-weak]: the uniform Poisson system of interior 160 × 160 × 640
    (MC_WEAK_NPTS) in f32 with a seeded b, ILU(0) 4,4 and BiCGSTAB at rtol
    1e-5, over the four cards: one card's [main] size on each card (a 160³
    slab, halo 25,600 rows on each inner face).  Reports the host build,
    the set-up, the iterations, the true residual, the steady factor and
    solve and the ms per iteration against [mc-dist-main]'s one-shard
    run."""
    opts = dict(ILU44_OPTS, rtol=KRYLOV_RTOL)
    nsw = int(opts["blasted_async_sweeps"].split(",")[1])
    t0 = time.perf_counter()
    A, b = seeded_poisson(MC_WEAK_NPTS, np.float32)
    t_host = time.perf_counter() - t0
    print(f"[mc-weak] host CSR of n = {A.nrows}, nnz = {A.nnz} "
          f"(apps.poisson3d_system, then b = A·x_ref in scipy): "
          f"{t_host:.3f} s", flush=True)
    rec, ds, _ = dist_run("mc-weak", A, b, opts, mesh, KRYLOV_RELRES)
    if rec["route"] != "DistDiaSolver" or ds.halo != HALO_ROWS \
            or ds.nl != (MAIN_NPTS - 2) ** 3:
        fail(f"mc-weak: route {rec['route']}, halo {ds.halo}, {ds.nl} rows "
             "a card")
    it = rec["iters"]
    want = per_card(mesh, {"dia_spmv": 2 * it + 1,
                           "tri_sweep": 2 * nsw * 2 * it})
    if rec["launches_by_card"] != want:
        fail(f"mc-weak: launches by card {rec['launches_by_card']}, "
             f"expected {want}")
    summary = {"n": A.nrows, "nnz": A.nnz, "host_build_s": t_host,
               "setup_s_first": rec["setup_s_first"], "iters": it,
               "relres_true": rec["relres_true"],
               "factor_ms": rec["factor_ms"], "solve_ms": rec["solve_ms"],
               "ms_per_iter": rec["solve_ms"] / it,
               "one_shard_160^3_ms_per_iter":
                   one_shard["solve_ms"] / one_shard["iters"],
               "peak_mib_by_card": rec["peak_mib_by_card"]}
    print("[mc-weak] " + json.dumps(summary), flush=True)
    del ds
    torch.cuda.empty_cache()
    return rec


def mc_dist_modes(mesh) -> None:
    """[mc-dist-modes]: ``dryrun_multichip`` on the four cards, all six
    modes at [dist-modes]' sizes and f32 (the banded modes at full width),
    mode 6 on the (2, 2) mesh, and the same on four shards of cuda:0: each
    mode's route, the same iterations, x equal to the bit on the banded
    modes (the same kernels on the same shards, reduced in the same order)
    and within MC_MODES_XTOL elsewhere; on the cards each banded mode
    launches its kernels on every card."""
    P = mesh.size
    for name, why in CUTS.items():
        print(f"[mc-dist-modes] [{name}] cut to {why}", flush=True)
    cases = dryrun_cases(P, dtype=np.float32, **DIST_MODE_SIZES)
    for case in cases:
        got = {}
        for key, devs in (("cards", list(mesh.devices)),
                          ("one card", [mesh.first] * P)):
            _cuda.reset_launches()
            t0 = time.perf_counter()
            (_, x, info, ctx), = dryrun_multichip(devs, [case])
            ctx.prec.mesh.synchronize()
            got[key] = {
                "x": x.cpu(), "iters": info.iters,
                "route": type(ctx.prec).__name__,
                "mesh": list(ctx.prec.mesh.shape),
                "seconds": time.perf_counter() - t0,
                "launches_by_card": {k: dict(v) for k, v in
                                     _cuda.launches_by_device.items() if v}}
            del ctx, x
        c, o = got["cards"], got["one card"]
        bitwise = bool(torch.equal(c["x"], o["x"]))
        rel = float(torch.linalg.norm(c["x"] - o["x"])
                    / torch.linalg.norm(o["x"]))
        rec = {"n": case.A.nrows, "route": c["route"], "mesh": c["mesh"],
               "iters": [c["iters"], o["iters"]], "x_bitwise": bitwise,
               "x_rel_diff": rel,
               "seconds": [c["seconds"], o["seconds"]],
               "launches_by_card": c["launches_by_card"]}
        print(f"[mc-dist-modes] [{case.name}] " + json.dumps(rec), flush=True)
        if c["route"] != o["route"] or c["iters"] != o["iters"]:
            fail(f"mc-dist-modes {case.name}: {rec}")
        if case.name in MODE_KERNELS:
            if not bitwise:
                fail(f"mc-dist-modes {case.name}: x not bitwise equal over "
                     f"the cards and over one card ({rec})")
            for k in MODE_KERNELS[case.name]:
                if set(c["launches_by_card"].get(k, {})) != \
                        {d.index for d in mesh.devices}:
                    fail(f"mc-dist-modes {case.name}: {k} not launched on "
                         f"every card ({c['launches_by_card']})")
        elif not bitwise and rel > MC_MODES_XTOL:
            fail(f"mc-dist-modes {case.name}: x differs by {rel} ({rec})")
        if case.name == "mesh-2d" and c["mesh"] != [2, P // 2]:
            fail(f"mc-dist-modes mesh-2d: mesh {c['mesh']}")
    torch.cuda.empty_cache()


def main_cards(ncards: int) -> int:
    """``--cards N``: [build] and the [mc-*] phases over the first N cards
    of ``make_mesh()``, then the kernels line, one ``nvidia-smi`` line per
    card and the last line."""
    count = torch.cuda.device_count()
    if count < ncards:
        print(f"chip_smoke: --cards {ncards} needs {ncards} CUDA devices, "
              f"torch sees {count}; nothing was checked", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()
    kind = torch.cuda.get_device_name(0)
    for i in range(count):
        print(f"[device] cuda:{i} {torch.cuda.get_device_name(i)}", flush=True)
    print(f"[device] nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _cuda.kernels_library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    mesh = make_mesh(ncards)
    if mesh.devices != tuple(torch.device("cuda", i) for i in range(ncards)):
        fail(f"make_mesh({ncards}) gave {mesh.devices}")

    phase("mc-topology", mc_topology, mesh, mesh=mesh)
    shapes = phase("mc-kernel", mc_kernel, mesh, mesh=mesh)
    A_k, b_k = seeded_poisson(MAIN_NPTS, np.float32)
    main_recs = phase("mc-dist-main", mc_dist_main, mesh, A_k, b_k,
                      mesh=mesh)
    del A_k, b_k
    B, bb = block_system(BLOCK_G, BLOCK_BS, np.float32, seed=7)
    block_recs = phase("mc-dist-block-main", mc_dist_block_main, mesh, B,
                       bb, mesh=mesh)
    del B, bb
    weak = phase("mc-weak", mc_weak, mesh, main_recs["one shard"],
                 mesh=mesh)
    phase("mc-dist-modes", mc_dist_modes, mesh, mesh=mesh)

    # the four-card solves are the main path: their launches, by card
    by_card = {name: {} for name in REPLACES}
    for rec in (main_recs["cards"], block_recs["cards"], weak):
        for name, cards in rec["launches_by_card"].items():
            for i, v in cards.items():
                by_card[name][i] = by_card[name].get(i, 0) + v
    for name, err in SHARD_ERR.items():
        shapes[name]["max_abs_err"] = max(shapes[name]["max_abs_err"], err)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "ms_by_card", "shape")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"blasted_tpu_torch/csrc/{_cuda.KERNEL_SOURCES[name]}",
         "replaces": REPLACES[name],
         "launches": sum(by_card[name].values()),
         "launches_by_card": by_card[name],
         **{k: shapes[name][k] for k in keys},
         **{k: shapes[name][k] for k in ("library_of", "lower_ms",
                                         "lower_bound_ms")
            if k in shapes[name]}}
        for name in REPLACES]}))
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def bench_phase(card: dict) -> None:
    """[bench]: every section of ``bench/roofline.py`` at ``BENCH_SMOKE``'s
    cut sizes through ``run_sections``, which fails a section that raises,
    finds a kernel off its twin on the section's operands, reads a fraction
    above 1.05 of the measured stream or of the spec, or on the card
    launched none of one of its kernels: no section may fail,
    each kernel section's yardstick must be past 4× the L2, and the
    bench's JSON line must parse with bench.py's four keys.  Prints each
    entry and each section's launches; writes no file."""
    b = BENCH_SMOKE.bench("cuda", card)
    fracs, failed = roofline.run_sections(b, BENCH_SMOKE)
    if failed:
        fail(f"bench: sections {failed} failed: "
             f"{ {p: b.detail[p + '_FAILED'] for p in failed} }")
    for name, rec in sorted(b.detail.items()):
        if "ms_per_iter" in rec:
            print(f"[bench] {name}: {rec['ms_per_iter'] * 1e3:.1f} µs/iter, "
                  f"{rec['bytes_model']} B, {rec['frac_measured_stream']:.3f}"
                  f" of the stream, {rec['frac_spec_hbm']:.3f} of spec",
                  flush=True)
        elif "gb_per_s" in rec:
            if not rec["past_4x_l2"]:
                fail(f"bench: {name}'s {rec['bytes']} B are under 4× L2")
            print(f"[bench] {name}: {rec['gb_per_s']:.0f} GB/s by "
                  f"{rec['by']} ({rec['bytes']} B, past 4× L2: "
                  f"{rec['past_4x_l2']})", flush=True)
        elif name.endswith("_vs_twin"):
            print(f"[bench] {name}: max_abs_err {rec['max_abs_err']}, "
                  f"rel_err {rec['rel_err']} (≤ {rec['rtol']})", flush=True)
        elif name.endswith("_launches"):
            print(f"[bench] {name}: {json.dumps(rec['kernels'])}",
                  flush=True)
    solve = b.detail["solve_bicgstab_diailu0"]
    print(f"[bench] solve: {solve['iters']} iterations, true relres "
          f"{solve['true_relres_f64']:.3e}, {solve['seconds']:.4f} s",
          flush=True)
    line = json.loads(bench_common.summary_line(fracs))
    if set(line) != {"metric", "value", "unit", "vs_baseline"} \
            or not 0.0 < line["value"] <= bench_common.MAX_FRACTION:
        fail(f"bench: summary line {line}")
    print(f"[bench] line: {json.dumps(line)}", flush=True)


def phase(name: str, fn, *args, mesh=None):
    """Run one phase and print its elapsed seconds, taken after
    synchronising the current card or, given ``mesh``, every card of it."""
    t0 = time.perf_counter()
    out = fn(*args)
    if mesh is None:
        torch.cuda.synchronize()
    else:
        mesh.synchronize()
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(MC_CARDS,),
                    help="run [build] and the [mc-*] phases over this many "
                         "cards, one shard per card, instead of the one-card "
                         "phases")
    args = ap.parse_args(argv)
    card = bench_common.require_card("chip_smoke")   # exits 2 without CUDA
    if args.cards is not None:
        return main_cards(args.cards)
    kind, smi = card["device"], card["nvidia_smi"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _cuda.kernels_library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    print(f"[build] native host library: {native.status()} "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)

    shapes = phase("kernel", check_all_kernels)
    torch.cuda.empty_cache()
    phase("bench", bench_phase, card)
    torch.cuda.empty_cache()

    # each path launched only its own kernels (expect_launches)
    scalar, main_rec, A_main, b_main = phase("main", main_path)
    main_iters = main_rec["iters"]
    mixed_counts = phase("mixed", mixed, A_main, b_main, main_rec)
    compressed_counts = phase("main-compressed", main_compressed)
    block, B_main, bb_main = phase("block-main", block_main_path)
    phase("device-independence", device_independence_cases)
    B, bb = block_system(BLOCK_CHECK_G, BLOCK_BS, np.float64, seed=8)
    phase("block-device-independence", device_independence,
          "block-device-independence", B, bb)

    # the general path: padded storage, torch gathers, no K1-K6 launch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, ctx = padded_path("padded-main", A_main, b_main, main_iters)
    padded_op_times("padded-main", A_main, ctx)
    del ctx
    torch.cuda.empty_cache()
    print(f"[phase] padded-main: {time.perf_counter() - t0:.3f} s",
          flush=True)
    t0 = time.perf_counter()
    _, ctx = padded_path("padded-block-main", B_main, bb_main, None)
    padded_op_times("padded-block-main", B_main, ctx)
    tf32_check(ctx)
    del ctx
    torch.cuda.empty_cache()
    print(f"[phase] padded-block-main: {time.perf_counter() - t0:.3f} s",
          flush=True)
    phase("padded-device-independence", padded_device_independence)
    phase("io", io_phase, A_main, b_main, main_iters)

    # the rest of the solver stack on the [main] matrix with a seeded b
    A_k, b_k = seeded_poisson(MAIN_NPTS, np.float32)
    del A_main, b_main
    krylov_counts = phase("krylov-main", krylov_main, A_k, b_k, B_main, bb_main)
    newton_counts = phase("newton", newton, A_k, b_k, B_main, bb_main)
    dist_block_counts = phase("dist-block-main", dist_block_main, B_main,
                              bb_main)
    del B_main, bb_main
    amg_counts, amg_ctx = phase("amg-main", amg_main, A_k, b_k)
    dist_counts = phase("dist-main", dist_main, A_k, b_k)
    del A_k, b_k
    phase("dist-modes", dist_modes)
    phase("dist-device-independence", dist_device_independence)
    phase("level-sgs", level_sgs_phase)
    sai_ctx = phase("sai", sai_phase)
    phase("tf32 stack", tf32_stack_check, sai_ctx, amg_ctx)
    del sai_ctx, amg_ctx
    torch.cuda.empty_cache()
    phase("precinfo", precinfo_phase)
    phase("stack-device-independence", stack_device_independence)
    phase("refined", refined)
    for name, err in SHARD_ERR.items():
        shapes[name]["max_abs_err"] = max(shapes[name]["max_abs_err"], err)
    counts = {name: scalar[name] + block[name] + krylov_counts[name]
              + amg_counts[name] + dist_counts[name]
              + dist_block_counts[name] + mixed_counts[name]
              + compressed_counts[name] + newton_counts[name]
              for name in scalar}

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"blasted_tpu_torch/csrc/{_cuda.KERNEL_SOURCES[name]}",
         "replaces": REPLACES[name],
         **{k: counts[name] if k == "launches" else shapes[name][k]
            for k in keys},
         **{k: shapes[name][k] for k in ("shape", "library_of", "lower_ms",
                                         "lower_bound_ms")
            if k in shapes[name]}}
        for name in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
