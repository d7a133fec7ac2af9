"""Sweep kernels of the preconditioners, format-dispatched.

Port of ``blasted_tpu/ops/sweeps.py`` (reference:
src/kernels/kernels_sgs.hpp:17-76, kernels_ilu_apply.hpp:15-94,
kernels_relaxation.hpp:17-54).  One sweep is a synchronous, data-parallel
update of all rows: sweep k reads sweep k−1's values (Jacobi on the
triangular systems).  On DIA storage the ILU apply sweeps are kernel K2
(the plain DIA product for a factor stored in another dtype, as in JAX) and
the other products the DIA streams of ``ops/dia.py``; on block-DIA they are
the SoA products of ``ops/bdia.py``.  On the padded forms the ILU apply
sweeps are kernel K10 and every other product is K9 on the masked triangle
(``ops/padded.py``; XLA gathers in JAX); the diagonal products contract
with the exact broadcast products of ``ops/spmv.py``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..sparse.bdia import BlockDiaMatrix
from ..sparse.dia import DiaMatrix
from .bdia import bdia_mv
from .dia import dia_mv
from .padded import col_table, padded_lower_sweep, padded_upper_sweep
from .spmv import bmv, padded_mv
from .stencil import tri_sweep_stencil

__all__ = [
    "lower_mv", "upper_mv", "fgs_sweep", "bgs_sweep", "jacobi_sweep",
    "unit_lower_sweep", "upper_solve_sweep",
    "block_lower_mv", "block_upper_mv", "block_fgs_sweep", "block_bgs_sweep",
    "block_jacobi_sweep", "block_unit_lower_sweep", "block_upper_solve_sweep",
    "run_sweeps", "invert_diag_blocks", "triangle",
]


def triangle(A, vals: torch.Tensor, part: str) -> torch.Tensor:
    """``vals`` in padded A's layout (scalar (n, W) or block
    (nbrows, W, bs, bs)) with every entry outside its strictly-lower
    (``part="lower"``) or strictly-upper (``"upper"``) part set to zero."""
    mask = A.lower_mask if part == "lower" else A.upper_mask
    if vals.dim() > 2:
        mask = mask[:, :, None, None]
    return torch.where(mask, vals, 0.0)


# ---------------------------------------------------------------- scalar ----


def lower_mv(A, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(L x)_i over the strictly-lower entries of ``vals`` (A's layout)."""
    if isinstance(A, DiaMatrix):
        return dia_mv(A, vals, x, "lower")
    return padded_mv(A, triangle(A, vals, "lower"), x)


def upper_mv(A, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(U x)_i over the strictly-upper entries of ``vals``."""
    if isinstance(A, DiaMatrix):
        return dia_mv(A, vals, x, "upper")
    return padded_mv(A, triangle(A, vals, "upper"), x)


def fgs_sweep(A, dinv: torch.Tensor, r: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """Forward GS sweep: y ← D⁻¹ (r − L y)
    (reference: kernels_sgs.hpp scalar_fgs, :17-29)."""
    return dinv * (r - lower_mv(A, A.vals_pad, y))


def bgs_sweep(A, dinv: torch.Tensor, y: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """Backward GS sweep: z ← y − D⁻¹ (U z)
    (reference: kernels_sgs.hpp scalar_bgs, :32-44)."""
    return y - dinv * upper_mv(A, A.vals_pad, z)


def jacobi_sweep(A, dinv: torch.Tensor, b: torch.Tensor, xl: torch.Tensor,
                 xu: torch.Tensor | None = None) -> torch.Tensor:
    """Relaxation sweep x ← D⁻¹ (b − L xl − U xu)
    (reference: kernels_relaxation.hpp scalar_relax, :40-54)."""
    if xu is None:
        xu = xl
    return dinv * (b - lower_mv(A, A.vals_pad, xl)
                   - upper_mv(A, A.vals_pad, xu))


def unit_lower_sweep(A, ilu: torch.Tensor, z: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """ILU forward sweep on L y = z with unit diagonal: y ← z − L y
    (reference: kernels_ilu_apply.hpp scalar_unit_lower_triangular).
    On DIA, sorted offsets make the strictly-lower diagonals the rows
    ``[:d0]`` of K2's operand; on padded CSR it is K10's lower mode.  A factor stored in another dtype than the
    vector's (``apply_dtype``) takes the plain shifted product instead, in
    the vector's dtype: the JAX package's rule
    (``blasted_tpu/precond/dia_ilu0.py:309``), fixed by the dtypes."""
    if isinstance(A, DiaMatrix):
        if ilu.dtype == z.dtype:
            d0 = A.d0
            return tri_sweep_stencil(A.offsets[:d0], ilu[:d0], z, y)
        return z - lower_mv(A, ilu, y)
    return padded_lower_sweep(triangle(A, ilu, "lower"), col_table(A), z, y)


def upper_solve_sweep(A, ilu: torch.Tensor, ilu_dinv: torch.Tensor,
                      y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """ILU backward sweep on U z = y: z ← u_ii⁻¹ (y − U z)
    (reference: kernels_ilu_apply.hpp scalar_upper_triangular); on DIA
    over the strictly-upper rows ``[d0+1:]`` through K2, or, for a factor
    in another dtype than the vector's, the plain product (see
    :func:`unit_lower_sweep`); on the padded forms K10's upper mode."""
    if isinstance(A, DiaMatrix):
        if ilu.dtype == z.dtype:
            d0 = A.d0
            return tri_sweep_stencil(A.offsets[d0 + 1:], ilu[d0 + 1:], y, z,
                                     ilu_dinv)
        return ilu_dinv * (y - upper_mv(A, ilu, z))
    return padded_upper_sweep(triangle(A, ilu, "upper"), col_table(A),
                              ilu_dinv, y, z)


# ----------------------------------------------------------------- block ----

def block_lower_mv(A, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(L x) over strictly-lower blocks; x is (nbrows, bs)."""
    if isinstance(A, BlockDiaMatrix):
        return bdia_mv(A, vals, x, "lower")
    return padded_mv(A, triangle(A, vals, "lower"), x)


def block_upper_mv(A, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(U x) over strictly-upper blocks; x is (nbrows, bs)."""
    if isinstance(A, BlockDiaMatrix):
        return bdia_mv(A, vals, x, "upper")
    return padded_mv(A, triangle(A, vals, "upper"), x)


def _dmul(dblocks: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Batched (n, bs, bs) @ (n, bs)."""
    return bmv(dblocks, seg)


def block_fgs_sweep(A, dinv: torch.Tensor, r: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """y ← D⁻¹ (r − L y), block form (reference: kernels_sgs.hpp block_fgs,
    :47-59)."""
    return _dmul(dinv, r - block_lower_mv(A, A.vals_pad, y))


def block_bgs_sweep(A, dinv: torch.Tensor, y: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """z ← y − D⁻¹ (U z), block form (reference: kernels_sgs.hpp block_bgs,
    :62-76)."""
    return y - _dmul(dinv, block_upper_mv(A, A.vals_pad, z))


def block_jacobi_sweep(A, dinv: torch.Tensor, b: torch.Tensor,
                       xl: torch.Tensor,
                       xu: torch.Tensor | None = None) -> torch.Tensor:
    """x ← D⁻¹ (b − L xl − U xu) (reference: kernels_relaxation.hpp
    block_relax_kernel, :17-37)."""
    if xu is None:
        xu = xl
    s = b - block_lower_mv(A, A.vals_pad, xl) \
        - block_upper_mv(A, A.vals_pad, xu)
    return _dmul(dinv, s)


def block_unit_lower_sweep(A, ilu: torch.Tensor, z: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """y ← z − L y (unit block diagonal; reference: kernels_ilu_apply.hpp
    block_unit_lower_triangular, :54-67); K10's lower mode on padded
    BSR."""
    if isinstance(A, BlockDiaMatrix):
        return z - block_lower_mv(A, ilu, y)
    return padded_lower_sweep(triangle(A, ilu, "lower"), col_table(A), z, y)


def block_upper_solve_sweep(A, ilu: torch.Tensor, ilu_dinv: torch.Tensor,
                            y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """z ← U_ii⁻¹ (y − U z), diagonal blocks pre-inverted (reference:
    kernels_ilu_apply.hpp block_upper_triangular, :79-94); K10's upper
    mode on padded BSR."""
    if isinstance(A, BlockDiaMatrix):
        return _dmul(ilu_dinv, y - block_upper_mv(A, ilu, z))
    return padded_upper_sweep(triangle(A, ilu, "upper"), col_table(A),
                              ilu_dinv, y, z)


# ----------------------------------------------------------- sweep loops ----

def run_sweeps(nsweeps: int, sweep_fn: Callable, x0: torch.Tensor):
    """Run a fixed number of synchronous sweeps: x_{k+1} = sweep_fn(x_k)."""
    x = x0
    for _ in range(nsweeps):
        x = sweep_fn(x)
    return x


def invert_diag_blocks(dblocks: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (n, bs, bs) blocks (reference: Eigen .inverse()
    per block, solverops_jacobi.cpp:43-45): the unrolled pivoted
    Gauss–Jordan for bs ≤ 8 (the reference's point-block sizes), as the JAX
    package does, and ``torch.linalg.inv`` beyond, where it calls
    ``jnp.linalg.inv``."""
    if dblocks.shape[-1] > 8:
        return torch.linalg.inv(dblocks)
    return _gauss_jordan_inverse(dblocks)


def _gauss_jordan_inverse(a: torch.Tensor) -> torch.Tensor:
    """Unrolled batched Gauss–Jordan with partial pivoting on (n, bs, bs):
    the row of the first maximal |pivot| among rows ≥ col is selected by a
    one-hot mask, swapped in with ``where``, scaled (a zero pivot divides
    by 1) and eliminated from every other row."""
    bs = a.shape[-1]
    eye = torch.eye(bs, dtype=a.dtype, device=a.device).expand(a.shape)
    M = torch.cat([a, eye], dim=-1)                     # (n, bs, 2bs)
    rows = torch.arange(bs, device=a.device)
    for col in range(bs):
        cand = torch.where(rows[None, :] >= col, M[:, :, col].abs(), -1.0)
        r = torch.argmax(cand, dim=1)                   # first maximum
        sel = rows[None, :] == r[:, None]               # (n, bs) one-hot
        colhot = rows == col
        pivrow = torch.sum(torch.where(sel[:, :, None], M, 0.0), dim=1)
        currow = M[:, col, :]
        M = torch.where(colhot[None, :, None], pivrow[:, None, :], M)
        M = torch.where((sel & ~colhot[None, :])[:, :, None],
                        currow[:, None, :], M)
        piv = M[:, col, col]
        pn = M[:, col, :] / torch.where(piv == 0, 1.0, piv)[:, None]
        fac = M[:, :, col]
        M = torch.where(colhot[None, :, None], pn[:, None, :],
                        M - fac[:, :, None] * pn[:, None, :])
    return M[:, :, bs:].contiguous()
