"""Compressed-sparse-row storage: the host container (numpy) and its padded
device form (torch).

Port of ``CSRMatrix``, ``extend_zero``, ``gather_padded`` and ``PaddedCSR``
from ``blasted_tpu/sparse/csr.py:35-347`` (reference:
include/srmatrixdefs.hpp:37-79).  The port keeps CSR as a host container:
the banded main path converts it to DIA tensors on a device
(:func:`blasted_tpu_torch.sparse.dia.dia_from_csr`), the general path pads
it into :class:`PaddedCSR` (:meth:`CSRMatrix.pad`).  The assembly and
query methods of ``blasted_tpu/sparse/csr.py:110-173`` (``submit_entries``,
``update_entries``, ``diag_entries``, …) are host numpy here too.

``PaddedCSR`` pads every row to the widest row's length ``W`` (ELL style),
so SpMV and every sweep is one ``(n, W)`` gather, a product and a reduction
over the width.  Sentinels as in the JAX package: padded slots hold
``pos == nnz`` and ``colind == n``; gathers read arrays extended by one
trailing zero, so padded slots contribute exactly 0.  Index tensors are
int64 on the device (the JAX package's are int32): torch gathers take int64
and would convert int32 indices at every call.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["CSRMatrix", "PaddedCSR", "extend_zero", "gather_padded",
           "padded_csr_from_numpy", "pad_pattern", "as_device", "take",
           "col_table"]


def as_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device where torch
    sees none raises here instead of running elsewhere.
    The port's entry points default to ``"cuda"``: the CPU runs only when a
    caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: torch sees no CUDA device; "
                           "pass device='cpu' to run on the CPU")
    return dev


@dataclass(frozen=True)
class CSRMatrix:
    """Scalar CSR matrix with stored diagonal locations."""

    rowptr: np.ndarray   # (n+1,) int32
    colind: np.ndarray   # (nnz,)  int32, sorted within each row
    vals: np.ndarray     # (nnz,)  float
    diagind: np.ndarray  # (n,)    int32 — position of a_ii within vals

    @property
    def nrows(self) -> int:
        return self.diagind.shape[0]

    @property
    def nnz(self) -> int:
        return self.colind.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    @staticmethod
    def from_arrays(rowptr, colind, vals, diagind=None) -> "CSRMatrix":
        """Wrap raw CSR arrays; compute ``diagind`` if not given
        (reference: src/rawsrmatrixutils.cpp:29-97)."""
        rowptr = np.asarray(rowptr, dtype=np.int32)
        colind = np.asarray(colind, dtype=np.int32)
        vals = np.asarray(vals)
        if diagind is None:
            diagind = _compute_diagind(rowptr, colind)
        else:
            diagind = np.asarray(diagind, dtype=np.int32)
        return CSRMatrix(rowptr=rowptr, colind=colind, vals=vals,
                         diagind=diagind)

    @staticmethod
    def from_scipy(sp) -> "CSRMatrix":
        sp = sp.tocsr()
        sp.sort_indices()
        return CSRMatrix.from_arrays(sp.indptr, sp.indices, sp.data)

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.csr_matrix((self.vals, self.colind, self.rowptr),
                              shape=(self.nrows, self.nrows))

    def with_vals(self, vals) -> "CSRMatrix":
        """Same sparsity, new values (reference: ILU factors sharing the
        matrix's index arrays, include/solverops_ilu0.hpp:74-78)."""
        return CSRMatrix(self.rowptr, self.colind, np.asarray(vals),
                         self.diagind)

    def astype(self, dtype) -> "CSRMatrix":
        """Value-dtype cast sharing the index arrays."""
        return self.with_vals(self.vals.astype(dtype))

    def pad(self, width: int | None = None, *,
            device="cuda") -> "PaddedCSR":
        """The padded device form on ``device`` (the card unless asked)."""
        return PaddedCSR.from_csr(self, width, device=device)

    # -- assembly / value updates (reference: blockmatrices.hpp:283-344);
    #    host numpy, each returning a new container sharing the indices --

    def scale_all(self, factor) -> "CSRMatrix":
        """All values times ``factor`` (reference: scaleAll)."""
        return self.with_vals(self.vals * factor)

    def entry_positions(self, rows, cols) -> np.ndarray:
        """Positions of entries (rows[k], cols[k]) in the nnz array
        (reference: inner_search, helper_algorithms.hpp:38-52)."""
        return _entry_positions(self.rowptr, self.colind, self.nrows,
                                rows, cols)

    def submit_entries(self, rows, cols, vals) -> "CSRMatrix":
        """Overwrite entries (rows[k], cols[k]) = vals[k] (reference:
        submitBlock, blockmatrices.hpp:283-300)."""
        out = self.vals.copy()
        out[self.entry_positions(rows, cols)] = np.asarray(vals)
        return self.with_vals(out)

    def update_entries(self, rows, cols, vals) -> "CSRMatrix":
        """Accumulate vals[k] into entries (rows[k], cols[k]); duplicate
        pairs accumulate (reference: updateBlock, blockmatrices.ipp:354)."""
        return self.with_vals(_add_at(self.vals,
                                      self.entry_positions(rows, cols), vals))

    def update_diag_entries(self, rows, vals) -> "CSRMatrix":
        """Accumulate into diagonal entries (reference: updateDiagBlock,
        blockmatrices.ipp:370)."""
        pos = self.diagind[np.asarray(rows, dtype=np.int64)]
        return self.with_vals(_add_at(self.vals, pos, vals))

    # -- diagnostic queries (reference: blockmatrices.hpp:419-445) --------

    def diag_entries(self) -> np.ndarray:
        """The scalar diagonal entries a_ii."""
        return self.vals[self.diagind]

    def zero_diagonal_row(self) -> int:
        """First row with a zero diagonal, −1 if none (reference:
        zeroDiagonalRow)."""
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
        """5 booleans: equal nrows, rowptr, colind, vals within ``tol``,
        diagind (reference: isEqual, blockmatrices.hpp:429)."""
        return _is_equal(self, other, tol)


def _add_at(vals: np.ndarray, pos: np.ndarray, add) -> np.ndarray:
    out = vals.copy()
    np.add.at(out, pos, np.asarray(add, dtype=vals.dtype))
    return out


def _zero_diagonal_row(diag: np.ndarray) -> int:
    z = np.nonzero(diag == 0)[0]
    return int(z[0]) if z.size else -1


def _is_equal(a, b, tol: float) -> tuple:
    same_n = a.nrows == b.nrows
    same_rp = same_n and bool(np.array_equal(a.rowptr, b.rowptr))
    same_ci = same_rp and bool(np.array_equal(a.colind, b.colind))
    same_v = same_ci and bool(np.all(np.abs(np.asarray(a.vals)
                                            - np.asarray(b.vals)) <= tol))
    same_di = same_n and bool(np.array_equal(a.diagind, b.diagind))
    return (same_n, same_rp, same_ci, same_v, same_di)


def _entry_positions(rowptr, colind, n: int, rows, cols) -> np.ndarray:
    """Positions of (rows[k], cols[k]) in the nnz array by one searchsorted
    over row-major (row, col) keys; raises if an entry is not in the
    pattern (the reference asserts in updateBlock)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    all_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rowptr))
    keys = all_rows * n + np.asarray(colind).astype(np.int64)
    want = rows * n + cols
    pos = np.searchsorted(keys, want)
    ok = (pos < keys.shape[0]) & \
        (keys[np.minimum(pos, keys.shape[0] - 1)] == want)
    if not ok.all():
        bad = int(np.nonzero(~ok)[0][0])
        raise ValueError(f"entry ({rows[bad]}, {cols[bad]}) not in the "
                         "sparsity pattern")
    return pos.astype(np.int32)


def _compute_diagind(rowptr: np.ndarray, colind: np.ndarray) -> np.ndarray:
    """Position of each row's diagonal entry (one global searchsorted over
    the row-major-sorted (row, col) keys)."""
    n = rowptr.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rowptr))
    key_all = rows * n + colind.astype(np.int64)
    want = np.arange(n, dtype=np.int64) * (n + 1)
    pos = np.searchsorted(key_all, want)
    ok = (pos < key_all.shape[0]) & \
        (key_all[np.minimum(pos, key_all.shape[0] - 1)] == want)
    if not ok.all():
        missing = int(np.nonzero(~ok)[0][0])
        raise ValueError(f"Row {missing} has no diagonal entry")
    return pos.astype(np.int32)


def extend_zero(t: torch.Tensor) -> torch.Tensor:
    """Append one zero entry (or block) so sentinel gathers read 0."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` along the first axis for an index tensor of any shape, as
    a gather of single elements.  On CUDA, torch gathers rows of several
    elements (advanced indexing, ``index_select`` and ``gather`` alike)
    with a kernel that runs one block per row, ~30× below the memory rate
    for 16- and 64-byte rows; so a row is read as whole 16- or 8-byte words
    (a bit-exact view) and gathered word by word."""
    flat = idx.reshape(-1)
    if t.dim() == 1:
        return t.index_select(0, flat).view(idx.shape)
    rows = t.reshape(t.shape[0], -1).contiguous()
    nbytes = rows.shape[1] * rows.element_size()
    word = torch.complex128 if nbytes % 16 == 0 else \
        torch.int64 if nbytes % 8 == 0 else rows.dtype
    words = rows.view(word)
    k = words.shape[1]
    if k > 1:
        flat = (flat[:, None] * k
                + torch.arange(k, device=flat.device)).reshape(-1)
    out = words.reshape(-1).index_select(0, flat).view(rows.dtype)
    return out.view(*idx.shape, *t.shape[1:])


def col_table(P) -> torch.Tensor:
    """The int32 (rows, W) column ids of the padded matrix ``P`` (sentinel
    = rows), which the padded kernels read (``ops/padded.py``): built at the
    first call and kept on ``P``; ``with_new_vals`` hands it to the updated
    matrix, so it is built once per sparsity pattern."""
    t = P.__dict__.get("_col32")
    if t is None:
        rows = P.colind.shape[0]
        if rows > 2 ** 31 - 1:
            raise ValueError(f"{rows} rows do not fit int32 column ids")
        t = P.colind.to(torch.int32).contiguous()
        object.__setattr__(P, "_col32", t)
    return t


def _keep_col_table(old, new) -> None:
    """Hand ``old``'s cached :func:`col_table` to ``new``, the same
    sparsity with new values."""
    if "_col32" in old.__dict__:
        object.__setattr__(new, "_col32", old._col32)


def gather_padded(values: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Gather an nnz-indexed value tensor, scalar ``(nnz,)`` or block
    ``(nnz, bs, bs)``, into padded ``(n, W, ...)`` form; the sentinel
    ``nnz`` reads the appended zero."""
    return take(extend_zero(values), pos)


def pad_pattern(rowptr: np.ndarray, colind: np.ndarray,
                width: int | None):
    """Host (numpy) index arrays of the padded form of a (block) CSR
    pattern: ``pos`` and ``cols`` (n, W) with the sentinels ``nnz`` and
    ``n``, and the strictly-lower and strictly-upper masks."""
    rowptr = np.asarray(rowptr)
    colind = np.asarray(colind)
    n = rowptr.shape[0] - 1
    nnz = colind.shape[0]
    rownnz = np.diff(rowptr)
    W = int(rownnz.max()) if width is None else int(width)
    if W < int(rownnz.max()):
        raise ValueError(f"width {W} < max row nnz {rownnz.max()}")
    pos = np.full((n, W), nnz, dtype=np.int64)
    cols = np.full((n, W), n, dtype=np.int64)
    # slot j of row i is rowptr[i] + j where j < rownnz[i]
    slot = np.arange(W)[None, :]
    valid = slot < rownnz[:, None]
    flat = rowptr[:-1][:, None] + slot
    pos[valid] = flat[valid]
    cols[valid] = colind[flat[valid]]
    rows = np.arange(n)[:, None]
    return pos, cols, (cols < rows) & valid, (cols > rows) & valid


def _tensors(device, **arrays) -> dict:
    """Numpy arrays as tensors on ``device`` (read-only arrays copied)."""
    return {k: torch.from_numpy(np.require(v, requirements=("C", "W")))
            .to(device) for k, v in arrays.items()}


@dataclass(frozen=True)
class PaddedCSR:
    """Fixed-row-width (ELL-style) device form of a CSR matrix: the JAX
    package's fields, as tensors on one device (``nnz_total`` a Python
    int)."""

    pos: torch.Tensor         # (n, W) int64 — index into the nnz array, sentinel nnz
    colind: torch.Tensor      # (n, W) int64 — column index, sentinel n
    vals_pad: torch.Tensor    # (n, W) float — matrix values, 0 at padding
    diag_vals: torch.Tensor   # (n,)  float  — a_ii
    diagind: torch.Tensor     # (n,)  int64  — position of a_ii in the nnz array
    lower_mask: torch.Tensor  # (n, W) bool  — strictly-lower entries
    upper_mask: torch.Tensor  # (n, W) bool  — strictly-upper entries
    rowptr: torch.Tensor      # (n+1,) int32 — kept for the symbolic passes
    nnz_total: int            # number of stored nonzeros

    @property
    def nrows(self) -> int:
        return self.pos.shape[0]

    @property
    def width(self) -> int:
        return self.pos.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals_pad.dtype

    @property
    def device(self) -> torch.device:
        return self.vals_pad.device

    @staticmethod
    def from_csr(A: CSRMatrix, width: int | None = None, *,
                 device="cuda") -> "PaddedCSR":
        device = as_device(device)
        pos, cols, lower, upper = pad_pattern(A.rowptr, A.colind, width)
        t = _tensors(device, pos=pos, colind=cols, lower_mask=lower,
                     upper_mask=upper, rowptr=A.rowptr,
                     diagind=A.diagind.astype(np.int64), vals=A.vals)
        vals = t.pop("vals")
        return PaddedCSR(vals_pad=gather_padded(vals, t["pos"]),
                         diag_vals=take(vals, t["diagind"]), nnz_total=A.nnz,
                         **t)

    def gather_x(self, x: torch.Tensor) -> torch.Tensor:
        """``x[colind]`` in padded form; sentinel slots read 0."""
        return take(extend_zero(x), self.colind)

    def repad_vals(self, vals: torch.Tensor) -> torch.Tensor:
        """Pad a new nnz-value tensor (e.g. ILU factors) into (n, W) form."""
        return gather_padded(vals, self.pos)

    def flat_vals(self) -> torch.Tensor:
        """The flat ``(nnz,)`` values, scattered back from the padded form.
        Every padded slot writes the overflow slot ``nnz`` (duplicate
        indices, no defined winner), which is dropped; live positions are
        distinct."""
        nnz = self.nnz_total
        flat = self.vals_pad.new_zeros((nnz + 1,))
        flat.index_copy_(0, self.pos.reshape(-1), self.vals_pad.reshape(-1))
        return flat[:nnz]

    def with_new_vals(self, vals) -> "PaddedCSR":
        """Same sparsity, new flat ``(nnz,)`` values (a tensor or numpy
        array) — the value-update path of the PCSetUp-every-Newton-step
        pattern (reference: blasted_petsc.cpp:314-327).  Only the
        value-derived fields are rebuilt; cached index tables carry over."""
        vals = torch.as_tensor(vals, device=self.device)
        new = dataclasses.replace(self, vals_pad=gather_padded(vals, self.pos),
                                  diag_vals=take(vals, self.diagind))
        _keep_col_table(self, new)
        return new


def flat_colind(P) -> np.ndarray:
    """Host (nnz,) column of every stored entry (block) of a padded form."""
    pos = P.pos.cpu().numpy()
    cols = P.colind.cpu().numpy()
    colind = np.zeros(P.nnz_total, dtype=np.int32)
    valid = pos < P.nnz_total
    colind[pos[valid]] = cols[valid]
    return colind


def padded_csr_from_numpy(pos, colind, vals_pad, diag_vals, diagind,
                          lower_mask, upper_mask, rowptr, nnz_total,
                          device) -> PaddedCSR:
    """Build a :class:`PaddedCSR` on ``device`` from numpy arrays — e.g. the
    fields of a ``blasted_tpu.sparse.csr.PaddedCSR`` — so both packages can
    be handed the same device matrix."""
    return PaddedCSR(nnz_total=int(np.asarray(nnz_total)), **_tensors(
        as_device(device), pos=np.asarray(pos, np.int64),
        colind=np.asarray(colind, np.int64), vals_pad=vals_pad,
        diag_vals=diag_vals, diagind=np.asarray(diagind, np.int64),
        lower_mask=np.asarray(lower_mask, bool),
        upper_mask=np.asarray(upper_mask, bool),
        rowptr=np.asarray(rowptr, np.int32)))
