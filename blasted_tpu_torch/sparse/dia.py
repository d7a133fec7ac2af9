"""DIA (diagonal) storage on a torch device — the banded fast path.

Port of ``blasted_tpu/sparse/dia.py``.  Banded matrices (the 7-point
Poisson stencil of the main path, structured-grid Jacobians) have a handful
of distinct column offsets, and every kernel of the solve — SpMV, the ILU
apply sweeps and the Chow–Patel factor sweep — becomes shifted streaming
arithmetic over the diagonals: no gathers, no scatters.

Layout: ``offsets`` a sorted tuple of Python ints; ``data`` one stacked
``(k, n)`` tensor with ``data[d, i] = A[i, i + offsets[d]]`` (row-index
aligned, 0 outside the band); ``mask`` a ``(k, n)`` bool tensor marking
*structural* nonzeros, so band-fill positions stay out of the ILU(0)
pattern.  The JAX package keeps a tuple of ``(n,)`` streams instead, a
workaround for the TPU's (8, 128) tiling of the last two axes; on a GPU a
row of a contiguous ``(k, n)`` tensor is itself a contiguous stream, and
because ``offsets`` are sorted the strictly-lower and strictly-upper
diagonals are the contiguous slices ``data[:d0]`` and ``data[d0 + 1:]``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.profiling import count
from .csr import CSRMatrix, as_device

__all__ = ["DiaMatrix", "dia_from_csr", "try_dia_from_csr", "dia_from_numpy",
           "dia_pad_identity", "shift_read", "as_device", "values_tensor"]


@dataclass(frozen=True)
class DiaMatrix:
    """Diagonal-format sparse matrix with a structural mask."""

    data: torch.Tensor   # (k, n) float, 0 outside the band/pattern
    mask: torch.Tensor   # (k, n) bool, structural nonzeros
    offsets: tuple       # (k,) sorted Python ints

    def __post_init__(self):
        k = len(self.offsets)
        if list(self.offsets) != sorted(set(self.offsets)):
            raise ValueError(f"offsets must be sorted and distinct: "
                             f"{self.offsets}")
        if self.data.dim() != 2 or self.data.shape[0] != k:
            raise ValueError(f"data must be (k={k}, n), got "
                             f"{tuple(self.data.shape)}")
        if self.mask.shape != self.data.shape or \
                self.mask.dtype != torch.bool:
            raise ValueError("mask must be a bool tensor shaped like data")
        if self.mask.device != self.data.device:
            raise ValueError("data and mask must be on one device")

    @property
    def nrows(self) -> int:
        return self.data.shape[1]

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
        """Index of the main diagonal in ``offsets``."""
        return self.offsets.index(0)

    @property
    def diag_vals(self) -> torch.Tensor:
        return self.data[self.d0]

    @property
    def vals_pad(self) -> torch.Tensor:
        """The value operand of the format-dispatched sweeps (the JAX
        package's name, shared with the padded forms)."""
        return self.data

    @property
    def nnz(self) -> int:
        return int(self.mask.sum())

    def with_new_data(self, data) -> "DiaMatrix":
        """Same band structure, new values masked to the structural
        pattern, on this matrix's device and in its dtype — the value-update
        path (reference: blasted_petsc.cpp:314-327).  ``data`` is a stacked
        ``(k, n)`` tensor or numpy array, or a sequence of k ``(n,)``
        diagonals (the JAX package's tuple form)."""
        data = values_tensor(data, self.device, self.dtype)
        if tuple(data.shape) != tuple(self.data.shape):
            raise ValueError(f"new DIA values have shape {tuple(data.shape)}"
                             f", expected {tuple(self.data.shape)}")
        return DiaMatrix(data=torch.where(self.mask, data, 0.0),
                         mask=self.mask, offsets=self.offsets)

    def to_scipy(self):
        import scipy.sparse as sps

        n = self.nrows
        data = self.data.cpu().numpy()
        mask = self.mask.cpu().numpy()
        rows, cols, vals = [], [], []
        for d, o in enumerate(self.offsets):
            i = np.nonzero(mask[d])[0]
            rows.append(i)
            cols.append(i + o)
            vals.append(data[d][i])
        return sps.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)).tocsr()


def values_tensor(data, device, dtype) -> torch.Tensor:
    """A value operand (a tensor, a numpy array, or a sequence of either,
    stacked) as one contiguous tensor on ``device`` in ``dtype``."""
    if isinstance(data, (tuple, list)):
        data = torch.stack([torch.as_tensor(np.asarray(v)) if
                            not isinstance(v, torch.Tensor) else v
                            for v in data])
    elif not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data))
    return data.to(device=device, dtype=dtype).contiguous()


def dia_from_numpy(offsets, data, mask, device) -> DiaMatrix:
    """Build a :class:`DiaMatrix` on ``device`` from numpy arrays — e.g. the
    fields of a ``blasted_tpu.sparse.dia.DiaMatrix`` (its tuple of ``(n,)``
    streams, or a stacked ``(k, n)`` array), so both packages can be handed
    the same matrix."""
    device = as_device(device)
    data = np.stack([np.asarray(v) for v in data])
    mask = np.stack([np.asarray(m, dtype=bool) for m in mask])
    return DiaMatrix(data=torch.from_numpy(data).to(device),
                     mask=torch.from_numpy(mask).to(device),
                     offsets=tuple(int(o) for o in offsets))


def _entry_offsets(A: CSRMatrix):
    """Row index and column offset of every stored entry, and the sorted
    distinct offsets."""
    rowptr = np.asarray(A.rowptr)
    rows = np.repeat(np.arange(rowptr.shape[0] - 1), np.diff(rowptr))
    offs = np.asarray(A.colind).astype(np.int64) - rows
    return rows, offs, np.unique(offs)


def _dia_from_entries(A: CSRMatrix, rows, offs, uniq, device) -> DiaMatrix:
    """Every stored entry lands on the diagonal of its column offset;
    ``np.searchsorted`` maps each entry's offset to its diagonal index (the
    JAX package uses a per-nonzero Python loop there,
    ``blasted_tpu/sparse/dia.py:131``; same result)."""
    vals = np.asarray(A.vals)
    shape = (uniq.shape[0], A.nrows)
    data = np.zeros(shape, dtype=vals.dtype)
    mask = np.zeros(shape, dtype=bool)
    dsel = np.searchsorted(uniq, offs)
    data[dsel, rows] = vals
    mask[dsel, rows] = True
    return dia_from_numpy(uniq, data, mask, device)


def dia_from_csr(A: CSRMatrix, device="cuda") -> DiaMatrix:
    """CSR → DIA on ``device``."""
    return _dia_from_entries(A, *_entry_offsets(A), device)


def try_dia_from_csr(A: CSRMatrix, device="cuda",
                     max_diags: int = 64) -> DiaMatrix | None:
    """DIA form of ``A`` if it has at most ``max_diags`` distinct column
    offsets, else ``None``.  Counts its calls and host seconds in
    ``utils.profiling.counters`` (``setup.dia_from_csr``,
    ``setup.dia_from_csr_s``)."""
    t0 = time.perf_counter()
    try:
        rows, offs, uniq = _entry_offsets(A)
        if uniq.shape[0] > max_diags:
            return None
        return _dia_from_entries(A, rows, offs, uniq, device)
    finally:
        count("setup.dia_from_csr")
        count("setup.dia_from_csr_s", time.perf_counter() - t0)


def dia_pad_identity(A: DiaMatrix, n_pad: int) -> DiaMatrix:
    """Append ``n_pad − nrows`` decoupled identity rows (main diagonal 1,
    every other diagonal structurally absent): an uneven row partition of
    the distributed banded path is padded up to a multiple of the shard
    count (cf. ``parallel.partition.pad_csr_identity``)."""
    n = A.nrows
    if n_pad == n:
        return A
    extra = (A.ndiags, n_pad - n)
    data = A.data.new_zeros(extra)
    data[A.d0] = 1.0
    mask = torch.zeros(extra, dtype=torch.bool, device=A.device)
    mask[A.d0] = True
    return DiaMatrix(data=torch.cat([A.data, data], dim=1),
                     mask=torch.cat([A.mask, mask], dim=1),
                     offsets=A.offsets)


def shift_read(x: torch.Tensor, o: int) -> torch.Tensor:
    """``s`` with ``s[i] = x[i + o]`` along axis 0, zero beyond the ends."""
    if o == 0:
        return x
    n = x.shape[0]
    out = torch.zeros_like(x)
    if abs(o) >= n:
        return out
    if o > 0:
        out[:n - o] = x[o:]
    else:
        out[-o:] = x[:n + o]
    return out
