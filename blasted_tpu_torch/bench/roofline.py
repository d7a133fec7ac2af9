"""Single-card roofline benchmark of the port: the scalar and point-block
kernels and an end-to-end solve against the card's streaming bandwidth.

The counterpart of ``bench.py`` on an NVIDIA H100, with its sections, sizes,
byte models and knobs, each run through the port's own entry points so
that the CUDA kernels run::

    python3 -m blasted_tpu_torch.bench.roofline

- ``scalar`` (g = 320, n = 32,768,000; ``bench.py:141-357``): the band is
  made on the card from a seeded ``torch.Generator`` with bench.py's
  diagonal dominance.  SpMV is K1 (``ops/stencil.py::dia_spmv_stencil``)
  chained on the band scaled once by c = 1/(4k), so the timed loop is K1
  alone (bench.py scales each product); the factor K3 then K4 through
  ``dia_factor_sweeps_stencil``, called directly with no route gate, as
  bench.py does; the apply pair K2 lower, then K2 upper with dinv
  (``tri_sweep_stencil``); the bf16 apply (a detail) the port's plain
  shifted products, with no K2, as JAX's ``stencil_gate`` route is.
- ``block4`` / ``block5`` (bs = 4 at g = 128, bs = 5 at g = 96;
  ``bench.py:359-561``): K5 (``bdia_spmv_stencil``, chained on the band
  scaled once by 1/(4k²)), the compressed block
  factor K6 (``bdia_factor_sweeps_compressed`` with the diagonal mask
  full), and the apply pair after the block inverse kernel: K7's lower,
  then its upper mode (``ops/bdia.py``'s sweep functions).
- ``csr`` (g = 160, not bench.py's 110; ``bench.py:563-611``): the
  padded-CSR SpMV, K9 (``ops/spmv.py::spmv`` →
  ``ops/padded.py::padded_spmv``), a detail outside the min; its working
  set is printed beside the L2.  K9 moves bench.py's bytes, whose 85 MB at
  g = 110 stay under four times the 50 MB L2: chained K9 calls read 1.47
  of the measured stream there, a cached reading the fraction check
  refuses; at g = 160 (the padded main path's n) they are 5.2× the L2.
- ``solve`` (npts = 162; ``bench.py:613-697``): ``poisson3d_system``
  uniform in float32, 8 plain factor sweeps (K8, ``dia_factor_sweep`` over
  one pruned plan, bench.py's ``dia_factor_sweep_tuple``), 4 apply sweeps
  (K2), BiCGSTAB (K1) to rtol 1e-5, on
  the host clock, with the true relative residual in float64.

The knobs are bench.py's environment variables with its defaults
(``BENCH_I1``, ``BENCH_I2``, ``BENCH_REPS``, ``BENCH_PARTS``,
``BENCH_SCALAR_G``, ``BENCH_BLOCK_G4``, ``BENCH_BLOCK_G5``, ``BENCH_CSR_G``,
``BENCH_NPTS``, ``BENCH_SOLVE_SWEEPS``, ``BENCH_SOLVE_TOL``,
``BENCH_SOLVE_MAXITER``).  Before it times a kernel, a section holds one
call of it, outside the launch counts, against its plain twin on the
section's own operands (``*_vs_twin`` in the detail, to ``TWIN_RTOL``).
Each section resets the kernel launch counts and records them; a kernel
section on the card that launched none of one of its kernels fails, as
does a section that raises, finds a kernel off its twin or reads an
impossible fraction (``common.py``).  A failed section counts 0.0 toward
the min.

The last line of standard output is bench.py's JSON line; the detail goes
to ``chiprun_out/bench_torch_detail.json`` (git-ignored), rewritten after
every section, and to standard error.  The exit code is 1 when a section
failed, 2 without a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..apps import poisson3d_system
from ..factory import to_device_matrix
from ..ops import _cuda
from ..ops.bdia import cols_of, soa_unit_lower_sweep, soa_upper_solve_sweep
from ..ops.bstencil import (
    bdia_block_inverse,
    bdia_factor_ref,
    bdia_factor_stencil,
    bdia_lower_sweep_ref,
    bdia_lower_sweep_stencil,
    bdia_spmv_ref,
    bdia_spmv_stencil,
    bdia_upper_sweep_ref,
    bdia_upper_sweep_stencil,
    block_inverse_ref,
)
from ..ops.padded import col_table, padded_spmv_ref
from ..ops.spmv import spmv
from ..ops.stencil import (
    PlainSweepPlan,
    dia_factor_sweeps_stencil,
    dia_spmv_ref,
    dia_spmv_stencil,
    factor_lower_ref,
    factor_lower_stencil,
    factor_stencil_eligible,
    factor_u0_ref,
    factor_u0_stencil,
    plain_factor_sweep_ref,
    plain_factor_sweep_stencil,
    tri_sweep_ref,
    tri_sweep_stencil,
)
from ..ops.sweeps import (
    lower_mv,
    unit_lower_sweep,
    upper_mv,
    upper_solve_sweep,
)
from ..precond.bdia_ilu0 import bdia_factor_sweeps_compressed
from ..precond.dia_ilu0 import dia_factor_sweep, dia_pairs
from ..solvers import bicgstab
from ..sparse.csr import PaddedCSR
from ..sparse.bdia import shift_last
from ..sparse.dia import DiaMatrix, shift_read
from .common import (
    L2_BYTES,
    SPEC_BW,
    Bench,
    cpu_card,
    host_seconds,
    launched,
    require_card,
    summary_line,
    write_detail,
)

__all__ = ["Settings", "SECTIONS", "REQUIRED", "scalar_models",
           "block_models", "csr_models", "band_mask", "bench_scalar",
           "bench_block", "bench_csr", "bench_solve", "run_sections",
           "rehearse_on_cpu", "main"]

SECTIONS = ("scalar", "block4", "block5", "csr", "solve")
IN_MIN = ("scalar", "block4", "block5")
# the kernels each kernel section must launch on the card
_BLOCK_KERNELS = ("bspmv", "bfactor_dinv", "bfactor_u0", "block_inverse",
                  "bdia_lower_sweep", "bdia_upper_sweep")
REQUIRED = {"scalar": ("dia_spmv", "tri_sweep", "factor_u0", "factor_lower"),
            "block4": _BLOCK_KERNELS, "block5": _BLOCK_KERNELS,
            "csr": ("padded_spmv",),
            "solve": ("dia_spmv", "tri_sweep", "plain_factor_sweep")}
ISZ = 4                       # float32
SOLVE_BUILD_SWEEPS = 8        # bench.py:645
# the true residual may reach 1.1·rtol in float64 and 7.8·rtol in float32:
# at npts = 162 the float32 solve stops on its recursive residual with a
# true one of 5.20e-5 on the card and 5.16e-5 in JAX's bench_solve
# (scripts/solve_f32_witness.py), six times the 8.6e-6 of the exact
# solution rounded to float32; the bound is 1.5× the larger reading
RELRES_FACTOR = {np.dtype(np.float64): 1.1, np.dtype(np.float32): 7.8}
CSR_SLOPE = dict(i1=1, i2=5, reps=2)   # bench.py:602


@dataclass(frozen=True)
class Settings:
    """bench.py's knobs, defaults included (``csr_g`` excepted, see the
    module docstring)."""

    i1: int = 4
    i2: int = 54
    reps: int = 5
    parts: tuple = SECTIONS
    scalar_g: int = 320
    block_g4: int = 128
    block_g5: int = 96
    csr_g: int = 160          # bench.py: 110, under 4× the L2 for K9
    npts: int = 162
    solve_sweeps: int = 4
    solve_tol: float = 1e-5
    solve_maxiter: int = 800

    @classmethod
    def from_env(cls, env=None) -> "Settings":
        env = os.environ if env is None else env
        d = cls()

        def get(name, cast, default):
            return cast(env.get(name, default))

        parts = tuple(p for p in env.get("BENCH_PARTS",
                                         ",".join(SECTIONS)).split(",") if p)
        unknown = [p for p in parts if p not in SECTIONS]
        if unknown:
            raise ValueError(f"BENCH_PARTS: unknown sections {unknown}; "
                             f"known: {','.join(SECTIONS)}")
        return cls(
            i1=get("BENCH_I1", int, d.i1), i2=get("BENCH_I2", int, d.i2),
            reps=get("BENCH_REPS", int, d.reps), parts=parts,
            scalar_g=get("BENCH_SCALAR_G", int, d.scalar_g),
            block_g4=get("BENCH_BLOCK_G4", int, d.block_g4),
            block_g5=get("BENCH_BLOCK_G5", int, d.block_g5),
            csr_g=get("BENCH_CSR_G", int, d.csr_g),
            npts=get("BENCH_NPTS", int, d.npts),
            solve_sweeps=get("BENCH_SOLVE_SWEEPS", int, d.solve_sweeps),
            solve_tol=get("BENCH_SOLVE_TOL", float, d.solve_tol),
            solve_maxiter=get("BENCH_SOLVE_MAXITER", int, d.solve_maxiter))

    def stamp(self) -> dict:
        s = asdict(self)
        s["parts"] = ",".join(self.parts)
        return s

    def bench(self, device, card: dict) -> Bench:
        return Bench(device, card, self.stamp(), self.i1, self.i2, self.reps)


# ------------------------------------------------------------ byte models --

def _offsets(g: int) -> tuple:
    return (-g * g, -g, -1, 0, 1, g, g * g)


def scalar_models(g: int) -> dict:
    """The scalar section's sizes and byte models (``bench.py:156-164``,
    ``:248``, ``:282``, ``:314``, ``:350``)."""
    offsets = _offsets(g)
    n, k = g ** 3, len(offsets)
    npairs = len(dia_pairs(offsets)[offsets.index(0)])
    kl = sum(1 for o in offsets if o < 0)
    ku = sum(1 for o in offsets if o > 0)
    return {"n": n, "k": k, "nnz": n + 2 * (g - 1) * g * g * 3,
            "spmv": (k + 2) * n * ISZ,
            "factor": (3 + 2 * npairs) * n * ISZ,
            "apply": ((kl + 3) + (ku + 4)) * n * ISZ,
            "apply_bf16": ((kl + 3) + (ku + 4)) * n * 2}


def block_models(bs: int, g: int) -> dict:
    """The block section's sizes and byte models (``bench.py:390-403``,
    ``:458``, ``:496``, ``:523``, ``:554``).  nnz is the structural block
    count (the mask's sum, in closed form) times bs²."""
    offsets = _offsets(g)
    nb, k = g ** 3, len(offsets)
    npairs = len(dia_pairs(offsets)[offsets.index(0)])
    kl = sum(1 for o in offsets if o < 0)
    ku = sum(1 for o in offsets if o > 0)
    return {"nb": nb, "k": k,
            "nnz": (nb + 2 * (g - 1) * g * g * 3) * bs * bs,
            "bspmv": (k * bs * bs + 2 * bs) * nb * ISZ,
            "factor": (3 + 2 * npairs) * nb * bs * bs * ISZ,
            "apply": ((kl + ku + 1) * bs * bs + 6 * bs) * nb * ISZ}


def csr_models(g: int) -> dict:
    """The padded-CSR section's sizes (``bench.py:575-577``) and byte model
    (``:604``: column indices, values, x and y at 4 bytes), the bytes K9
    reads and writes too (its int32 column ids, ``ops/padded.py``)."""
    n, W = g ** 3, 7
    return {"n": n, "W": W, "nnz": n * W,
            "bytes_model": (2 * W + 2) * n * ISZ,
            "operand_bytes": (2 * W + 2) * n * ISZ}


# ------------------------------------------------------------- operands ----

def band_mask(g: int, device) -> torch.Tensor:
    """The (7, g³) structural mask of the 7-point band of a g³ grid, in
    ``_offsets(g)``'s order (``bench.py:168-172``)."""
    n = g ** 3
    idx = torch.arange(n, device=device)
    i0, j0, k0 = idx % g, (idx // g) % g, idx // (g * g)
    full = torch.ones(n, dtype=torch.bool, device=device)
    return torch.stack([k0 > 0, j0 > 0, i0 > 0, full,
                        i0 < g - 1, j0 < g - 1, k0 < g - 1])


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# --------------------------------------------------------------- scalar ----

def bench_scalar(b: Bench, g: int) -> list:
    """The scalar section: yardstick, K1 SpMV, K3/K4 factor, K2 apply pair,
    bf16 apply (detail).  Returns the three fractions of the min."""
    dev = b.device
    m = scalar_models(g)
    offsets, n, k = _offsets(g), m["n"], m["k"]
    d0 = offsets.index(0)
    mask = band_mask(g, dev)
    data = 0.25 * torch.randn(k, n, generator=_generator(dev, 0), device=dev)
    data[d0] += 2.0 * k                         # diagonally dominant
    data = torch.where(mask, data, 0.0)
    x = torch.randn(n, generator=_generator(dev, 1), device=dev)
    print(f"[scalar] n={n} (g={g}) nnz={m['nnz']} diags={k} "
          f"dtype={data.dtype} state={(k + 1) * n * ISZ / 1e6:.0f}MB",
          file=sys.stderr)

    stream_bw = b.stream("scalar_stream", data)
    # c = 1/(4k) keeps the chained products finite (bench.py:240-246); it
    # scales the band once, so the timed loop is K1 alone
    data_c = data * (1.0 / (4.0 * k))
    b.held("scalar_dia_spmv_vs_twin",
           lambda: dia_spmv_stencil(offsets, data_c, x),
           lambda: dia_spmv_ref(offsets, data_c, x))

    def mk_spmv(iters):
        def run():
            u = x
            for _ in range(iters):
                u = dia_spmv_stencil(offsets, data_c, u)
            return u.sum()
        return run

    t, s = b.slope(mk_spmv)
    frac_spmv = b.record("scalar_spmv", t, m["spmv"], stream_bw, m["nnz"], s)
    del data_c

    pairs = dia_pairs(offsets)
    if not factor_stencil_eligible(offsets, pairs):
        raise ValueError("the 7-point band must take the compressed factor")
    # K3's and K4's first calls as dia_factor_sweeps_stencil makes them
    lowers = [d for d, o in enumerate(offsets) if o < 0]
    lower_offs = tuple(offsets[d] for d in lowers)
    pair_offs = tuple(o1 for (_, _, o1) in pairs[d0])
    base_pl = torch.stack([data[dl] for (dl, _, _) in pairs[d0]])
    ubs = torch.stack([shift_read(data[du], o1) for (_, du, o1) in pairs[d0]])
    base0, base_l = data[d0].contiguous(), data[lowers]
    b.held("scalar_factor_u0_vs_twin",
           lambda: factor_u0_stencil(pair_offs, base0, base_pl, ubs, base0),
           lambda: factor_u0_ref(pair_offs, base0, base_pl, ubs, base0))
    b.held("scalar_factor_lower_vs_twin",
           lambda: factor_lower_stencil(lower_offs, base_l, base0),
           lambda: factor_lower_ref(lower_offs, base_l, base0))
    del base_pl, ubs, base0, base_l

    def mk_fact(iters):
        def run():
            return dia_factor_sweeps_stencil(offsets, pairs, d0, data, data,
                                             iters)[d0].sum()
        return run

    t, s = b.slope(mk_fact)
    frac_fact = b.record("scalar_ilu0_factor", t, m["factor"], stream_bw,
                         m["nnz"], s)

    ilu = dia_factor_sweeps_stencil(offsets, pairs, d0, data, data, 8)
    dinv = 1.0 / torch.where(ilu[d0] == 0, 1.0, ilu[d0])
    lo, up = offsets[:d0], offsets[d0 + 1:]
    L, U = ilu[:d0], ilu[d0 + 1:]
    y0 = torch.zeros_like(x)
    b.held("scalar_tri_sweep_lower_vs_twin",
           lambda: tri_sweep_stencil(lo, L, x, y0),
           lambda: tri_sweep_ref(lo, L, x, y0))
    b.held("scalar_tri_sweep_upper_vs_twin",
           lambda: tri_sweep_stencil(up, U, x, x, dinv),
           lambda: tri_sweep_ref(up, U, x, x, dinv))
    del y0

    def mk_apply(iters):
        def run():
            y = torch.zeros_like(x)
            for _ in range(iters):
                y1 = tri_sweep_stencil(lo, L, x, y)
                y = tri_sweep_stencil(up, U, x, y1, dinv)
            return y.sum()
        return run

    t_apply, s = b.slope(mk_apply)
    frac_apply = b.record("scalar_ilu0_apply_pair", t_apply, m["apply"],
                          stream_bw, m["nnz"], s)

    # bf16 factors and vectors (bench.py:319-351): a factor of another
    # dtype than float32/float64 takes the plain shifted products, no K2
    bf = torch.bfloat16
    ilu_bf = ilu.to(bf)
    D_bf = DiaMatrix(data=ilu_bf, mask=mask, offsets=offsets)
    x_bf, dinv_bf = x.to(bf), dinv.to(bf)
    del data, ilu

    def mk_apply_bf(iters):
        def run():
            y = torch.zeros_like(x_bf)
            for _ in range(iters):
                y1 = x_bf - lower_mv(D_bf, ilu_bf, y)
                y = dinv_bf * (x_bf - upper_mv(D_bf, ilu_bf, y1))
            return y.float().sum()
        return run

    t_bf, s = b.slope(mk_apply_bf)
    b.record("scalar_ilu0_apply_pair_bf16", t_bf, m["apply_bf16"], stream_bw,
             m["nnz"], s)
    b.detail["scalar_ilu0_apply_pair_bf16"]["speedup_vs_f32"] = t_apply / t_bf
    return [frac_spmv, frac_fact, frac_apply]


# ---------------------------------------------------------------- block ----

def bench_block(b: Bench, bs: int, g: int) -> list:
    """The block section at block size ``bs``: yardstick, K5 SpMV, K6
    factor, SoA apply pair after the block inverse kernel.  Returns the
    three fractions of the min."""
    dev = b.device
    m = block_models(bs, g)
    offsets, nb, k = _offsets(g), m["nb"], m["k"]
    d0 = offsets.index(0)
    pairs = dia_pairs(offsets)
    lower = [d for d, o in enumerate(offsets) if o < 0]
    upper = [d for d, o in enumerate(offsets) if o > 0]
    mask = band_mask(g, dev)
    data = 0.25 * torch.randn(k, bs * bs, nb, generator=_generator(dev, 0),
                              device=dev)
    data[d0, ::bs + 1] += 2.0 * k               # block-diagonally dominant
    data = torch.where(mask[:, None, :], data, 0.0)
    x = torch.randn(nb, bs, generator=_generator(dev, 1), device=dev)
    name = f"block{bs}"
    print(f"[{name}] nb={nb} (g={g}) nnz={m['nnz']} "
          f"state={k * nb * bs * bs * ISZ / 1e6:.0f}MB", file=sys.stderr)

    stream_bw = b.stream(f"{name}_stream", data)
    # c = 1/(4k²) scales the band once, so the timed loop is K5 alone
    data_c = data * (1.0 / (4.0 * k * k))
    b.held(f"{name}_bspmv_vs_twin",
           lambda: bdia_spmv_stencil(offsets, data_c, x),
           lambda: bdia_spmv_ref(offsets, data_c, x))

    def mk_bspmv(iters):
        def run():
            u = x
            for _ in range(iters):
                u = bdia_spmv_stencil(offsets, data_c, u)
            return u.sum()
        return run

    t, s = b.slope(mk_bspmv)
    frac_bspmv = b.record(f"{name}_bspmv", t, m["bspmv"], stream_bw,
                          m["nnz"], s)
    del data_c
    # K6's first calls, in each mode, as bdia_factor_sweeps_compressed
    # makes them with the diagonal mask full
    pair_offs = tuple(o1 for (_, _, o1) in pairs[d0])
    base_l = torch.stack([data[dl] for (dl, _, _) in pairs[d0]])
    ubs = torch.stack([shift_last(data[du], o1) for (_, du, o1) in pairs[d0]])
    dinv0 = block_inverse_ref(data[d0], mask[d0])
    for mode, out_dinv in (("dinv", True), ("u0", False)):
        b.held(f"{name}_bfactor_{mode}_vs_twin",
               lambda o=out_dinv: bdia_factor_stencil(
                   pair_offs, data[d0], base_l, ubs, dinv0, o),
               lambda o=out_dinv: bdia_factor_ref(
                   pair_offs, data[d0], base_l, ubs, dinv0, o))
    del base_l, ubs, dinv0

    def mk_fact(iters):
        def run():
            out = bdia_factor_sweeps_compressed(offsets, pairs, d0, mask,
                                                data, data, iters,
                                                diag_mask_full=True)
            return out[d0].sum()
        return run

    t, s = b.slope(mk_fact)
    frac_fact = b.record(f"{name}_ilu0_factor", t, m["factor"], stream_bw,
                         m["nnz"], s)

    ilu = bdia_factor_sweeps_compressed(offsets, pairs, d0, mask, data, data,
                                        8, diag_mask_full=True)
    b.held(f"{name}_block_inverse_vs_twin",
           lambda: bdia_block_inverse(ilu[d0], mask[d0]),
           lambda: block_inverse_ref(ilu[d0], mask[d0]))
    dinv = bdia_block_inverse(ilu[d0], mask[d0])
    del data
    zc = cols_of(x)
    # K7's two modes on the apply's own operands: the first pair of sweeps
    # of the timed loop (y from zero, then the upper on y1 as y and z)
    y1 = bdia_lower_sweep_ref(ilu, offsets, lower, zc, torch.zeros_like(zc))
    b.held(f"{name}_bdia_lower_sweep_vs_twin",
           lambda: bdia_lower_sweep_stencil(ilu, offsets, lower, zc, y1),
           lambda: bdia_lower_sweep_ref(ilu, offsets, lower, zc, y1))
    b.held(f"{name}_bdia_upper_sweep_vs_twin",
           lambda: bdia_upper_sweep_stencil(ilu, dinv, offsets, upper, y1,
                                            y1),
           lambda: bdia_upper_sweep_ref(ilu, dinv, offsets, upper, y1, y1))
    del y1

    def mk_apply(iters):
        def run():
            y = torch.zeros_like(zc)
            for _ in range(iters):
                y1 = soa_unit_lower_sweep(ilu, offsets, lower, zc, y, bs)
                y = soa_upper_solve_sweep(ilu, dinv, offsets, upper, y1, y1,
                                          bs)
            return y.sum()
        return run

    t, s = b.slope(mk_apply)
    frac_apply = b.record(f"{name}_ilu0_apply_pair", t, m["apply"],
                          stream_bw, m["nnz"], s)
    return [frac_bspmv, frac_fact, frac_apply]


# ------------------------------------------------------------ padded CSR ---

def bench_csr(b: Bench, g: int) -> None:
    """The padded-CSR SpMV (K9) on the 7-point structure with random
    values made on the device (a detail, outside the min), held against
    its twin first, normalised to this run's scalar stream if it was
    measured, else to the spec."""
    dev = b.device
    m = csr_models(g)
    n, W = m["n"], m["W"]
    offs = torch.tensor(_offsets(g), device=dev)
    rows = torch.arange(n, device=dev)[:, None]
    cols = rows + offs[None, :]
    valid = (cols >= 0) & (cols < n)
    vals = 0.1 * torch.randn(n, W, generator=_generator(dev, 2), device=dev)
    vals = torch.where(valid, vals, 0.0)
    x = torch.randn(n, generator=_generator(dev, 3), device=dev)
    nnz = int(valid.sum())
    pos = torch.where(valid, torch.cumsum(valid.reshape(-1), 0)
                      .reshape(n, W) - 1, nnz)
    rowptr = torch.cat([valid.new_zeros(1, dtype=torch.int32),
                        torch.cumsum(valid.sum(1), 0).to(torch.int32)])
    A = PaddedCSR(pos=pos, colind=torch.where(valid, cols, n), vals_pad=vals,
                  diag_vals=vals[:, 3].contiguous(),
                  diagind=pos[:, 3].contiguous(),
                  lower_mask=valid & (cols < rows),
                  upper_mask=valid & (cols > rows), rowptr=rowptr,
                  nnz_total=nnz)
    del rows, cols, valid
    b.held("csr_padded_spmv_vs_twin", lambda: spmv(A, x),
           lambda: padded_spmv_ref(A.vals_pad, col_table(A), x))
    ws = m["operand_bytes"]
    print(f"[csr] padded-gather SpMV n={n} W={W}: working set "
          f"{ws / 1e6:.0f} MB, {ws / L2_BYTES:.1f}× the {L2_BYTES / 2**20:.0f}"
          f" MiB L2", file=sys.stderr)

    def mk(iters):
        def run():
            u = x
            for _ in range(iters):
                u = spmv(A, u)
            return u.sum()
        return run

    t, s = b.slope(mk, **CSR_SLOPE)
    scalar = b.detail.get("scalar_stream")
    sbw = scalar["gb_per_s"] * 1e9 if scalar else None
    b.record("csr_padded_spmv", t, m["bytes_model"], sbw or SPEC_BW,
             m["nnz"], s)
    b.detail["csr_padded_spmv"].update(
        gather_gelem_per_s=m["nnz"] / t / 1e9, normalised_to=(
            "scalar_stream" if sbw else "spec"),
        operand_bytes=ws, l2_bytes=L2_BYTES, past_4x_l2=ws >= 4 * L2_BYTES)


# ---------------------------------------------------------------- solve ----

def bench_solve(b: Bench, npts: int, napply: int, tol: float, maxiter: int,
                samples: int, dtype=np.float32) -> torch.Tensor:
    """BiCGSTAB + DIA-ILU(0) (8 plain factor sweeps, ``napply`` apply
    sweeps) on the uniform ``npts``³ Poisson system in ``dtype``: host clock
    around each solve, ending in a synchronise; ``samples`` timed solves
    after an untimed one.  Records bench.py's fields plus the median, the
    sample count and the true relative residual in float64, and returns x.
    Fails unless the solve converged to a true residual of at most
    ``RELRES_FACTOR``·``tol``."""
    dev = b.device
    A64, rhs, _ = poisson3d_system((npts,) * 3, dist="uniform")
    A = A64.astype(dtype)
    D = to_device_matrix(A, device=dev)
    if not isinstance(D, DiaMatrix):
        raise TypeError(f"the Poisson system took {type(D).__name__}")
    offsets, nnz = D.offsets, A.nnz
    k, d0 = len(offsets), D.d0
    pairs = dia_pairs(offsets)
    mask_t = tuple(None if (bool(D.mask[d].all()) or offsets[d] < 0)
                   else D.mask[d] for d in range(k))
    print(f"[solve] n={D.nrows} nnz={nnz}", file=sys.stderr)

    plan = PlainSweepPlan(offsets, pairs, d0, mask_t, prune=True,
                          device=dev)
    b.held("solve_plain_factor_sweep_vs_twin",
           lambda: plain_factor_sweep_stencil(plan, D.data, D.data),
           lambda: plain_factor_sweep_ref(plan, D.data, D.data))
    ilu = D.data
    for _ in range(SOLVE_BUILD_SWEEPS):
        ilu = dia_factor_sweep(plan, D.data, ilu)
    dinv = 1.0 / torch.where(ilu[d0] == 0, 1.0, ilu[d0])
    bvec = torch.as_tensor(rhs, dtype=D.dtype, device=dev)

    def prec(r):
        y = torch.zeros_like(r)
        for _ in range(napply):
            y = unit_lower_sweep(D, ilu, r, y)
        z = torch.zeros_like(r)
        for _ in range(napply):
            z = upper_solve_sweep(D, ilu, dinv, y, z)
        return z

    def run():
        return bicgstab(lambda v: spmv(D, v), prec, bvec,
                        torch.zeros_like(bvec), tol=tol, maxiter=maxiter)

    times, (x, info) = host_seconds(run, dev, samples)
    A_sp = A.to_scipy().astype(np.float64)
    xh = x.double().cpu().numpy()
    true_relres = float(np.linalg.norm(A_sp @ xh - rhs)
                        / np.linalg.norm(rhs))
    best, med = min(times), float(np.median(times))
    bound = RELRES_FACTOR[np.dtype(dtype)] * tol
    b.entry("solve_bicgstab_diailu0", seconds=best, median_seconds=med,
            samples=len(times), iters=int(info.iters),
            converged=bool(info.converged),
            relres=info.resnorm / info.bnorm,
            true_relres_f64=true_relres, true_relres_bound=bound,
            npts=npts, dtype=str(D.dtype).removeprefix("torch."),
            nbuildsweeps=SOLVE_BUILD_SWEEPS, tol=tol, maxiter=maxiter,
            napplysweeps=napply,
            gnnz_iters_per_s=nnz * info.iters / best / 1e9)
    print(f"[solve] BiCGSTAB+ILU0({napply} sweeps) n={D.nrows}: {best:.4f} s "
          f"best, {med:.4f} s median of {len(times)}, {info.iters} iters, "
          f"converged={info.converged} true relres={true_relres:.3e}",
          file=sys.stderr)
    if not info.converged or true_relres > bound:
        raise RuntimeError(f"solve: converged={info.converged}, true relres "
                           f"{true_relres:.3e} against {bound:g}")
    return x


# ------------------------------------------------------------------ run ----

def _run_part(b: Bench, s: Settings, part: str):
    if part == "scalar":
        return bench_scalar(b, s.scalar_g)
    if part in ("block4", "block5"):
        return bench_block(b, int(part[-1]),
                           s.block_g4 if part == "block4" else s.block_g5)
    if part == "csr":
        return bench_csr(b, s.csr_g)
    return bench_solve(b, s.npts, s.solve_sweeps, s.solve_tol,
                       s.solve_maxiter, max(2, s.reps - 2))


def run_sections(b: Bench, s: Settings, after=None) -> tuple:
    """Run the sections of ``s.parts`` in bench.py's order, each with the
    launch counts reset before it and recorded after it
    (``detail[part + "_launches"]``).  A section that raises, or on the
    card launched none of one of its kernels, is recorded as failed
    (``detail[part + "_FAILED"]``) and counts 0.0 toward the min, as
    bench.py's ``guarded`` does.  ``after(part)`` runs after each section.
    Returns (the fractions of the min, the failed sections)."""
    fracs, failed = [], []
    for part in SECTIONS:
        if part not in s.parts:
            continue
        _cuda.reset_launches()
        try:
            out = _run_part(b, s, part)
            counts = launched()
            missing = [name for name in REQUIRED.get(part, ())
                       if b.device.type == "cuda" and not counts.get(name)]
            if missing:
                raise RuntimeError(f"{part}: launched none of {missing}")
        except Exception as e:                       # noqa: BLE001
            traceback.print_exc()
            b.detail[f"{part}_FAILED"] = repr(e)[:300]
            print(f"[{part}] SECTION FAILED: {e!r}", file=sys.stderr)
            out = [0.0]
            failed.append(part)
        b.entry(f"{part}_launches", kernels=launched())
        if part in IN_MIN:
            fracs += out
        if b.device.type == "cuda":
            torch.cuda.empty_cache()
        if after is not None:
            after(part)
    return fracs, failed


def rehearse_on_cpu(s: Settings) -> tuple:
    """Every section of ``s`` on the CPU, through the kernels' plain twins:
    (fractions, failed sections, detail).  No device number comes from
    this, and nothing is written."""
    b = s.bench("cpu", cpu_card())
    fracs, failed = run_sections(b, s)
    return fracs, failed, b.detail


def main() -> int:
    s = Settings.from_env()
    card = require_card("roofline")
    t0 = time.perf_counter()
    _cuda.kernels_library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    b = s.bench("cuda", card)
    prefixes = [f"{p}_" for p in s.parts]
    fracs, failed = run_sections(
        b, s, after=lambda part: write_detail(b.detail, prefixes))
    print(json.dumps(b.detail, indent=1, sort_keys=True), file=sys.stderr)
    if failed:
        print(f"roofline: failed sections {failed}", file=sys.stderr)
    print(summary_line(fracs), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
