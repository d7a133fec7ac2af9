"""Sparse matrix-vector products, format-dispatched.

Port of ``blasted_tpu/ops/spmv.py:23-66`` (reference:
src/blas/matvecs.cpp:24-182): the DIA branch of ``spmv`` is kernel K1, the
block-DIA branch of ``bspmv`` kernel K5, and the padded CSR/BSR forms
kernel K9 (``ops/padded.py``; XLA gathers in JAX, no Pallas kernel).  Block
contractions here are broadcast multiplies and sums, never matmuls, so
float32 stays exact float32 whatever the TF32 flags say (ROADMAP.md fault
C4).
"""

from __future__ import annotations

import torch

from ..sparse.bdia import BlockDiaMatrix
from ..sparse.dia import DiaMatrix
from .bdia import bdia_spmv
from .dia import dia_spmv
from .padded import col_table, padded_spmv

__all__ = ["spmv", "gemv3", "padded_mv", "block_matvec", "bmv", "bspmv",
           "bgemv3"]


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A x (reference: matvecs.cpp csr_matrix_apply, :24-47): DIA
    through K1, padded CSR through K9."""
    if isinstance(A, DiaMatrix):
        return dia_spmv(A, x)
    return padded_mv(A, A.vals_pad, x)


def padded_mv(A, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_w vals[i, w]·x[col(i, w)] over the padded rows of ``A``: ``vals``
    is scalar (n, W) or block (nbrows, W, bs, bs) in A's padded layout
    (K9)."""
    return padded_spmv(vals, col_table(A), x)


def gemv3(A, a, x: torch.Tensor, b, y: torch.Tensor) -> torch.Tensor:
    """z = a·A·x + b·y (reference: matvecs.cpp csr_gemv3, :49-75)."""
    return a * spmv(A, x) + b * y


def bmv(blocks: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
    """Batched block·segment products ``(…, bs, bs) × (…, bs) → (…, bs)``."""
    return (blocks * segs.unsqueeze(-2)).sum(-1)


def block_matvec(blocks: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
    """``blocks`` (n, W, bs, bs) times ``segs`` (n, W, bs), summed over the
    row width → (n, bs) (the JAX ``einsum('rwij,rwj->ri')``)."""
    return bmv(blocks, segs).sum(1)


def bspmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A x on (nbrows, bs) block vectors: block-DIA through K5, padded
    BSR through K9."""
    if isinstance(A, BlockDiaMatrix):
        return bdia_spmv(A, x)
    return padded_mv(A, A.vals_pad, x)


def bgemv3(A, a, x: torch.Tensor, b, y: torch.Tensor) -> torch.Tensor:
    """z = a·A·x + b·y in block-segment form."""
    return a * bspmv(A, x) + b * y
