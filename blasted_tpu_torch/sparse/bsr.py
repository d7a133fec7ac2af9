"""Block-sparse-row (BSR) storage: the host container (numpy) and its
padded device form (torch).

Port of ``BSRMatrix`` and ``PaddedBSR`` from
``blasted_tpu/sparse/bsr.py:24-259`` (reference:
include/srmatrixdefs.hpp:37-79, include/blockmatrices.hpp:165-456): values
as an ``(nnzb, bs, bs)`` array, row-major within a block; ``from_arrays``
takes flat values in either intra-block order (the reference's
RowMajor/ColMajor split, include/blasted_config.hpp:30-37).  As with CSR,
the port keeps BSR as a host container: the banded point-block path
converts it to block-DIA tensors on a device
(:func:`blasted_tpu_torch.sparse.bdia.bdia_from_bsr`), the general path
pads it into :class:`PaddedBSR` (:meth:`BSRMatrix.pad`), whose block
vectors are ``(nbrows, bs)`` as on the block-DIA path.  The assembly and
query methods (``submit_blocks``, ``update_blocks``, ``diag_entries``, …;
``blasted_tpu/sparse/bsr.py:97-155``) are host numpy, as for CSR.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .csr import (
    _add_at,
    _compute_diagind,
    _entry_positions,
    _is_equal,
    _keep_col_table,
    _tensors,
    _zero_diagonal_row,
    as_device,
    extend_zero,
    gather_padded,
    pad_pattern,
    take,
)

__all__ = ["BSRMatrix", "PaddedBSR", "padded_bsr_from_numpy"]


@dataclass(frozen=True)
class BSRMatrix:
    """Block CSR matrix; ``vals[k]`` is the bs×bs block of the k-th stored
    block."""

    rowptr: np.ndarray   # (nbrows+1,) int32
    colind: np.ndarray   # (nnzb,) int32, sorted within each block row
    vals: np.ndarray     # (nnzb, bs, bs) float
    diagind: np.ndarray  # (nbrows,) int32 — position of each diagonal block

    @property
    def nbrows(self) -> int:
        return self.diagind.shape[0]

    @property
    def bs(self) -> int:
        return self.vals.shape[-1]

    @property
    def nnzb(self) -> int:
        return self.colind.shape[0]

    @property
    def nrows(self) -> int:
        return self.nbrows * self.bs

    @property
    def dtype(self):
        return self.vals.dtype

    @staticmethod
    def from_arrays(rowptr, colind, vals, bs: int, diagind=None,
                    order: str = "C") -> "BSRMatrix":
        """Wrap raw BSR arrays.  ``vals`` may be flat ``(nnzb*bs*bs,)``;
        ``order`` gives the intra-block layout of flat input ('C' row-major,
        'F' column-major)."""
        rowptr = np.asarray(rowptr, dtype=np.int32)
        colind = np.asarray(colind, dtype=np.int32)
        vals = np.asarray(vals)
        nnzb = colind.shape[0]
        if vals.ndim == 1:
            vals = vals.reshape(nnzb, bs, bs)
            if order == "F":
                vals = vals.transpose(0, 2, 1)
        if diagind is None:
            diagind = _compute_diagind(rowptr, colind)
        else:
            diagind = np.asarray(diagind, dtype=np.int32)
        return BSRMatrix(rowptr=rowptr, colind=colind, vals=vals,
                         diagind=diagind)

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.bsr_matrix((self.vals, self.colind, self.rowptr),
                              shape=(self.nrows, self.nrows))

    def with_vals(self, vals) -> "BSRMatrix":
        """Same sparsity, new ``(nnzb, bs, bs)`` values."""
        return BSRMatrix(self.rowptr, self.colind, np.asarray(vals),
                         self.diagind)

    def astype(self, dtype) -> "BSRMatrix":
        """Value-dtype cast sharing the index arrays."""
        return self.with_vals(self.vals.astype(dtype))

    def pad(self, width: int | None = None, *,
            device="cuda") -> "PaddedBSR":
        """The padded device form on ``device`` (the card unless asked)."""
        return PaddedBSR.from_bsr(self, width, device=device)

    # -- assembly / value updates (reference: blockmatrices.hpp:283-344) --

    def scale_all(self, factor) -> "BSRMatrix":
        """All blocks times ``factor`` (reference: scaleAll)."""
        return self.with_vals(self.vals * factor)

    def block_positions(self, brows, bcols) -> np.ndarray:
        """Positions of blocks (brows[k], bcols[k]) in the nnzb array."""
        return _entry_positions(self.rowptr, self.colind, self.nbrows,
                                brows, bcols)

    def submit_blocks(self, brows, bcols, blocks) -> "BSRMatrix":
        """Overwrite blocks; ``blocks`` is ``(k, bs, bs)`` (reference:
        submitBlock, blockmatrices.hpp:283-300)."""
        out = self.vals.copy()
        out[self.block_positions(brows, bcols)] = np.asarray(blocks)
        return self.with_vals(out)

    def update_blocks(self, brows, bcols, blocks) -> "BSRMatrix":
        """Accumulate blocks; duplicates accumulate (reference:
        updateBlock, blockmatrices.ipp:354)."""
        return self.with_vals(_add_at(self.vals,
                                      self.block_positions(brows, bcols),
                                      blocks))

    def update_diag_blocks(self, brows, blocks) -> "BSRMatrix":
        """Accumulate into diagonal blocks (reference: updateDiagBlock,
        blockmatrices.ipp:370)."""
        pos = self.diagind[np.asarray(brows, dtype=np.int64)]
        return self.with_vals(_add_at(self.vals, pos, blocks))

    # -- diagnostic queries (reference: blockmatrices.hpp:419-445; the
    #    scalar diagonal is the diagonals of the diagonal blocks) ----------

    def diag_entries(self) -> np.ndarray:
        dblocks = self.vals[self.diagind]
        return np.diagonal(dblocks, axis1=-2, axis2=-1).reshape(-1)

    def zero_diagonal_row(self) -> int:
        return _zero_diagonal_row(self.diag_entries())

    def num_zero_diagonals(self) -> int:
        return int((self.diag_entries() == 0).sum())

    def diagonal_product(self) -> float:
        return float(self.diag_entries().prod())

    def diagonal_abs_sum(self) -> float:
        return float(np.abs(self.diag_entries()).sum())

    def abs_min_diagonal(self) -> float:
        return float(np.abs(self.diag_entries()).min())

    def abs_max_diagonal(self) -> float:
        return float(np.abs(self.diag_entries()).max())

    def is_equal(self, other, tol: float) -> tuple:
        return _is_equal(self, other, tol)


@dataclass(frozen=True)
class PaddedBSR:
    """Fixed-row-width device form of a BSR matrix (see
    :class:`~blasted_tpu_torch.sparse.csr.PaddedCSR`); the JAX package's
    fields, as tensors on one device (``nnz_total`` a Python int)."""

    pos: torch.Tensor          # (nbrows, W) int64, sentinel nnzb
    colind: torch.Tensor       # (nbrows, W) int64, sentinel nbrows
    vals_pad: torch.Tensor     # (nbrows, W, bs, bs)
    diag_blocks: torch.Tensor  # (nbrows, bs, bs)
    diagind: torch.Tensor      # (nbrows,) int64
    lower_mask: torch.Tensor   # (nbrows, W) bool
    upper_mask: torch.Tensor   # (nbrows, W) bool
    rowptr: torch.Tensor       # (nbrows+1,) int32
    nnz_total: int             # number of stored blocks

    @property
    def nbrows(self) -> int:
        return self.pos.shape[0]

    @property
    def width(self) -> int:
        return self.pos.shape[1]

    @property
    def bs(self) -> int:
        return self.vals_pad.shape[-1]

    @property
    def nrows(self) -> int:
        return self.nbrows * self.bs

    @property
    def dtype(self) -> torch.dtype:
        return self.vals_pad.dtype

    @property
    def device(self) -> torch.device:
        return self.vals_pad.device

    @staticmethod
    def from_bsr(A: BSRMatrix, width: int | None = None, *,
                 device="cuda") -> "PaddedBSR":
        device = as_device(device)
        pos, cols, lower, upper = pad_pattern(A.rowptr, A.colind, width)
        t = _tensors(device, pos=pos, colind=cols, lower_mask=lower,
                     upper_mask=upper, rowptr=A.rowptr,
                     diagind=A.diagind.astype(np.int64), vals=A.vals)
        vals = t.pop("vals")
        return PaddedBSR(vals_pad=gather_padded(vals, t["pos"]),
                         diag_blocks=take(vals, t["diagind"]),
                         nnz_total=A.nnzb, **t)

    def gather_x(self, x: torch.Tensor) -> torch.Tensor:
        """Block segments ``x[colind]`` → (nbrows, W, bs) for an (nbrows, bs)
        block vector; sentinel slots read 0."""
        return take(extend_zero(x), self.colind)

    def repad_vals(self, vals: torch.Tensor) -> torch.Tensor:
        """Pad a new (nnzb, bs, bs) value tensor into (nbrows, W, bs, bs)."""
        return gather_padded(vals, self.pos)

    def flat_vals(self) -> torch.Tensor:
        """The flat (nnzb, bs, bs) values, scattered back from the padded
        form (padded slots land in the dropped overflow block ``nnzb``)."""
        nnzb, bs = self.nnz_total, self.bs
        flat = self.vals_pad.new_zeros((nnzb + 1, bs, bs))
        flat.index_copy_(0, self.pos.reshape(-1),
                         self.vals_pad.reshape(-1, bs, bs))
        return flat[:nnzb]

    def with_new_vals(self, vals) -> "PaddedBSR":
        """Same sparsity, new (nnzb, bs, bs) values (a tensor or numpy
        array); see :meth:`PaddedCSR.with_new_vals`."""
        vals = torch.as_tensor(vals, device=self.device)
        new = dataclasses.replace(self, vals_pad=gather_padded(vals, self.pos),
                                  diag_blocks=take(vals, self.diagind))
        _keep_col_table(self, new)
        return new


def padded_bsr_from_numpy(pos, colind, vals_pad, diag_blocks, diagind,
                          lower_mask, upper_mask, rowptr, nnz_total,
                          device) -> PaddedBSR:
    """Build a :class:`PaddedBSR` on ``device`` from numpy arrays — e.g. the
    fields of a ``blasted_tpu.sparse.bsr.PaddedBSR``."""
    return PaddedBSR(nnz_total=int(np.asarray(nnz_total)), **_tensors(
        as_device(device), pos=np.asarray(pos, np.int64),
        colind=np.asarray(colind, np.int64), vals_pad=vals_pad,
        diag_blocks=diag_blocks, diagind=np.asarray(diagind, np.int64),
        lower_mask=np.asarray(lower_mask, bool),
        upper_mask=np.asarray(upper_mask, bool),
        rowptr=np.asarray(rowptr, np.int32)))
