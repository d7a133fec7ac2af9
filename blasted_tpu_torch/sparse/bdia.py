"""Block-DIA storage on a torch device — the point-block banded path.

Port of ``blasted_tpu/sparse/bdia.py``.  Banded point-block matrices (the
7-point block band of structured-grid CFD Jacobians at bs = 4 or 5, the
reference's focus) have a handful of block-column offsets, and every kernel
is a shifted block product,

    y[i] = Σ_d data[d, i] @ x[i + off_d]      (no gathers, no scatters).

Layout: ``offsets`` a sorted tuple of Python ints; ``data`` one contiguous
``(k, bs², nb)`` tensor with ``data[d, i·bs + j, r]`` the entry (i, j) of
the block A[r, r + offsets[d]] (row-major within a block, 0 outside the
band) — the JAX package's component-major form (``as_bdia_soa``), there a
nested tuple of ``(nb,)`` streams; ``mask`` a ``(k, nb)`` bool tensor of
*structural* blocks, so band fill stays out of the ILU(0) pattern; and
``diag_mask_full``, the host-computed flag "every diagonal block is
stored", which picks the factor's kernel route.  Block vectors are
``(nb, bs)`` tensors.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.profiling import annotate, count
from .bsr import BSRMatrix
from .dia import as_device, values_tensor

__all__ = ["BlockDiaMatrix", "bdia_from_bsr", "try_bdia_from_bsr",
           "bdia_from_numpy", "bdia_pad_identity", "block_pattern_csr",
           "shift_last"]


@dataclass(frozen=True)
class BlockDiaMatrix:
    """Block-diagonal-format sparse matrix with a structural mask."""

    data: torch.Tensor    # (k, bs², nb) float, 0 outside the band/pattern
    mask: torch.Tensor    # (k, nb) bool, structural blocks
    offsets: tuple        # (k,) sorted Python ints
    diag_mask_full: bool | None = None   # None: unknown, see resolved_...

    def __post_init__(self):
        k = len(self.offsets)
        if list(self.offsets) != sorted(set(self.offsets)):
            raise ValueError(f"offsets must be sorted and distinct: "
                             f"{self.offsets}")
        if self.data.dim() != 3 or self.data.shape[0] != k:
            raise ValueError(f"data must be (k={k}, bs², nb), got "
                             f"{tuple(self.data.shape)}")
        bs = int(round(self.data.shape[1] ** 0.5))
        if bs * bs != self.data.shape[1]:
            raise ValueError(f"{self.data.shape[1]} component streams is not "
                             "a square block size")
        if not self.data.is_contiguous():
            raise ValueError("data must be contiguous")
        if self.mask.shape != (k, self.data.shape[2]) or \
                self.mask.dtype != torch.bool:
            raise ValueError("mask must be a (k, nb) bool tensor")
        if self.mask.device != self.data.device:
            raise ValueError("data and mask must be on one device")

    @property
    def nbrows(self) -> int:
        return self.data.shape[2]

    @property
    def bs(self) -> int:
        return int(round(self.data.shape[1] ** 0.5))

    @property
    def nrows(self) -> int:
        return self.nbrows * self.bs

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def d0(self) -> int:
        """Index of the main block diagonal in ``offsets``."""
        return self.offsets.index(0)

    @property
    def diag_blocks(self) -> torch.Tensor:
        """The (nb, bs, bs) diagonal blocks (setup-time use)."""
        bs = self.bs
        return self.data[self.d0].view(bs, bs, -1).permute(2, 0, 1)

    @property
    def vals_pad(self) -> torch.Tensor:
        """The value operand of the format-dispatched sweeps (the JAX
        package's name, shared with the padded forms)."""
        return self.data

    def resolved_diag_mask_full(self) -> bool:
        """The carried flag, else a check of the main-diagonal mask."""
        if self.diag_mask_full is not None:
            return self.diag_mask_full
        return bool(self.mask[self.d0].all())

    def with_new_data(self, data) -> "BlockDiaMatrix":
        """Same band structure, new values masked to the structural
        pattern, on this matrix's device and in its dtype (see
        :meth:`DiaMatrix.with_new_data`).  ``data`` is this layout's
        ``(k, bs², nb)`` or a stacked ``(k, nb, bs, bs)`` array or tensor;
        as in the JAX package (``as_bdia_soa``), a 3-D operand is always
        component-major."""
        k, bs = self.ndiags, self.bs
        data = values_tensor(data, self.device, self.dtype)
        if data.dim() == 4:
            data = data.permute(0, 2, 3, 1).reshape(k, bs * bs, -1)
        if tuple(data.shape) != tuple(self.data.shape):
            raise ValueError(f"cannot interpret block-DIA values of shape "
                             f"{tuple(data.shape)}")
        return BlockDiaMatrix(
            data=torch.where(self.mask[:, None, :], data, 0.0).contiguous(),
            mask=self.mask, offsets=self.offsets,
            diag_mask_full=self.diag_mask_full)

    def to_scipy(self):
        import scipy.sparse as sps

        bs = self.bs
        data = self.data.cpu().numpy()
        mask = self.mask.cpu().numpy()
        rows, cols, vals = [], [], []
        for d, o in enumerate(self.offsets):
            i = np.nonzero(mask[d])[0]
            for ib in range(bs):
                for jb in range(bs):
                    rows.append(i * bs + ib)
                    cols.append((i + o) * bs + jb)
                    vals.append(data[d, ib * bs + jb, i])
        n = self.nrows
        return sps.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)).tocsr()


def shift_last(t: torch.Tensor, o: int) -> torch.Tensor:
    """``s`` with ``s[..., r] = t[..., r + o]``, zero beyond the ends — the
    block form of :func:`~blasted_tpu_torch.sparse.dia.shift_read`, along
    the last (block-row) axis of component streams."""
    if o == 0:
        return t
    n = t.shape[-1]
    out = torch.zeros_like(t)
    if abs(o) >= n:
        return out
    if o > 0:
        out[..., :n - o] = t[..., o:]
    else:
        out[..., -o:] = t[..., :n + o]
    return out


def _diag_mask_full(offsets, mask: np.ndarray) -> bool:
    offsets = [int(o) for o in offsets]
    return 0 in offsets and bool(mask[offsets.index(0)].all())


def bdia_from_numpy(offsets, data, mask, device) -> BlockDiaMatrix:
    """Build a :class:`BlockDiaMatrix` on ``device`` from numpy arrays — e.g.
    the fields of a ``blasted_tpu.sparse.bdia.BlockDiaMatrix`` (nested
    tuples: k diagonals × bs² component streams of ``(nb,)``, and k masks),
    or the stacked ``(k, bs², nb)`` / ``(k, nb)`` arrays, so both packages
    can be handed the same matrix."""
    device = as_device(device)
    data = np.asarray(data)
    mask = np.asarray(mask, dtype=bool)
    return BlockDiaMatrix(
        data=torch.from_numpy(np.ascontiguousarray(data)).to(device),
        mask=torch.from_numpy(mask).to(device),
        offsets=tuple(int(o) for o in offsets),
        diag_mask_full=_diag_mask_full(offsets, mask))


def _block_offsets(B: BSRMatrix):
    """Block row and block-column offset of every stored block, and the
    sorted distinct offsets."""
    rowptr = np.asarray(B.rowptr)
    rows = np.repeat(np.arange(B.nbrows), np.diff(rowptr))
    offs = np.asarray(B.colind).astype(np.int64) - rows
    return rows, offs, np.unique(offs)


def _bdia_from_blocks(B: BSRMatrix, rows, offs, uniq, device):
    """Every stored block lands on the block diagonal of its offset;
    ``np.searchsorted`` maps each block's offset to its diagonal index (the
    JAX package loops over the blocks in Python there,
    ``blasted_tpu/sparse/bdia.py:241``; same result).  The blocks are placed
    block-row-major on the host and turned component-major on the device."""
    device = as_device(device)
    nb, b2 = B.nbrows, B.bs * B.bs
    k = uniq.shape[0]
    dsel = np.searchsorted(uniq, offs)
    blocks = np.zeros((k, nb, b2), dtype=B.vals.dtype)
    mask = np.zeros((k, nb), dtype=bool)
    blocks[dsel, rows] = np.asarray(B.vals).reshape(-1, b2)
    mask[dsel, rows] = True
    data = torch.from_numpy(blocks).to(device).transpose(1, 2).contiguous()
    return BlockDiaMatrix(data=data, mask=torch.from_numpy(mask).to(device),
                          offsets=tuple(int(o) for o in uniq),
                          diag_mask_full=_diag_mask_full(uniq, mask))


def bdia_from_bsr(B: BSRMatrix, device="cuda") -> BlockDiaMatrix:
    """BSR → block-DIA on ``device``."""
    return _bdia_from_blocks(B, *_block_offsets(B), device)


def try_bdia_from_bsr(B: BSRMatrix, device="cuda",
                      max_diags: int = 32) -> BlockDiaMatrix | None:
    """Block-DIA form of ``B`` if it has at most ``max_diags`` distinct
    block-column offsets, else ``None``.  A ``setup.bdia_from_bsr`` span;
    counts its calls and host seconds in ``utils.profiling.counters``
    (``setup.bdia_from_bsr``, ``setup.bdia_from_bsr_s``)."""
    t0 = time.perf_counter()
    try:
        with annotate("setup.bdia_from_bsr"):
            rows, offs, uniq = _block_offsets(B)
            if uniq.shape[0] > max_diags:
                return None
            return _bdia_from_blocks(B, rows, offs, uniq, device)
    finally:
        count("setup.bdia_from_bsr")
        count("setup.bdia_from_bsr_s", time.perf_counter() - t0)


def bdia_pad_identity(A: BlockDiaMatrix, nb_pad: int) -> BlockDiaMatrix:
    """Append decoupled identity block rows (cf. ``dia_pad_identity``).
    The padded rows extend the main diagonal with stored blocks, so the
    ``diag_mask_full`` flag carries over."""
    nb = A.nbrows
    if nb_pad == nb:
        return A
    bs, k, extra = A.bs, A.ndiags, nb_pad - nb
    data = A.data.new_zeros((k, bs * bs, extra))
    data[A.d0, ::bs + 1] = 1.0
    mask = torch.zeros((k, extra), dtype=torch.bool, device=A.device)
    mask[A.d0] = True
    return BlockDiaMatrix(data=torch.cat([A.data, data], dim=2),
                          mask=torch.cat([A.mask, mask], dim=1),
                          offsets=A.offsets, diag_mask_full=A.diag_mask_full)


def block_pattern_csr(A: BlockDiaMatrix):
    """Block-granularity sparsity pattern as (indptr, indices) — for level
    scheduling."""
    import scipy.sparse as sps

    nb = A.nbrows
    mask = A.mask.cpu().numpy()
    rows, cols = [], []
    for d, o in enumerate(A.offsets):
        i = np.nonzero(mask[d])[0]
        rows.append(i)
        cols.append(i + o)
    sp = sps.coo_matrix(
        (np.ones(sum(len(r) for r in rows)),
         (np.concatenate(rows), np.concatenate(cols))), shape=(nb, nb)).tocsr()
    sp.sort_indices()
    return sp.indptr, sp.indices
