"""Reordering and scaling of sparse matrices and vectors.

Port of ``blasted_tpu/precond/reordering.py`` (reference:
include/reorderingscaling.hpp:29-120, src/reorderingscaling.cpp
applyOrdering for matrices :76-160 and vectors :204-240, applyScaling
:268-340), host-side numpy and scipy.  Convention (reorderingscaling.hpp
:34-38): with row permutation ``rp``, FORWARD makes block-row rp[i] of the
original block-row i of the reordered matrix; INVERSE undoes it.  Entries
inside dense blocks are not touched.

- :class:`RCMReordering` — symmetric reverse Cuthill–McKee, which reduces
  the bandwidth and so feeds the DIA path;
- :class:`MaxMatchingReordering` — the open-algorithm analogue of MC64's
  five jobs (the reference wraps the proprietary Fortran routine);
- :class:`MaxDiagonalScaling` — symmetric equilibration toward a dominant
  diagonal, with an optional maximum-product row permutation;
- :class:`ReorderedILU0Preconditioner` — ILU(0) of the reordered matrix
  on a device, with the vector permutations around its apply.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.bsr import BSRMatrix
from ..sparse.csr import CSRMatrix
from ..utils.profiling import annotate

__all__ = ["Reordering", "RCMReordering", "MaxMatchingReordering",
           "MaxDiagonalScaling", "ReorderedILU0Preconditioner",
           "apply_ordering_matrix", "apply_ordering_vector",
           "apply_scaling_matrix_", "FORWARD", "INVERSE", "ROW", "COLUMN"]

FORWARD = "forward"
INVERSE = "inverse"
ROW = "row"
COLUMN = "column"


class Reordering:
    """Permutation holder and appliers (reference:
    reorderingscaling.hpp:42-120)."""

    def __init__(self):
        self.rp = None   # row permutation
        self.cp = None   # column permutation

    def set_ordering(self, rp=None, cp=None):
        """(reference: setOrdering)"""
        self.rp = None if rp is None else np.asarray(rp, dtype=np.int64)
        self.cp = None if cp is None else np.asarray(cp, dtype=np.int64)

    @property
    def is_row_reordering(self) -> bool:
        return self.rp is not None

    @property
    def is_col_reordering(self) -> bool:
        return self.cp is not None

    def compute(self, A) -> None:
        """Compute the ordering from a matrix; the base is abstract."""
        raise NotImplementedError

    def apply_to_matrix(self, A, mode=FORWARD):
        """A new CSR/BSR matrix with rows and columns permuted (rows
        re-sorted by column, as the reference does)."""
        return apply_ordering_matrix(A, self.rp, self.cp, mode)

    def apply_to_vector(self, v, mode=FORWARD, direction=ROW, bs: int = 1):
        """(reference: applyOrdering(vec), reorderingscaling.cpp:204-240)"""
        p = self.rp if direction == ROW else self.cp
        return apply_ordering_vector(v, p, mode, bs)


def apply_ordering_matrix(A, rp, cp, mode=FORWARD):
    if isinstance(A, BSRMatrix):
        # permute block rows and columns on the block structure directly
        n = A.nbrows
        rows = np.repeat(np.arange(n), np.diff(A.rowptr))
        if rp is not None:
            irp = np.empty(n, dtype=np.int64)
            irp[rp] = np.arange(n)
            rows = (irp[rows] if mode == FORWARD else
                    np.asarray(rp, dtype=np.int64)[rows])
        cols = A.colind.astype(np.int64)
        if cp is not None:
            icp = np.empty(n, dtype=np.int64)
            icp[cp] = np.arange(n)
            cols = icp[cols] if mode == FORWARD else np.asarray(cp)[cols]
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], A.vals[order]
        new_rowptr = np.zeros(n + 1, dtype=np.int32)
        np.add.at(new_rowptr[1:], rows, 1)
        new_rowptr = np.cumsum(new_rowptr, dtype=np.int32)
        return BSRMatrix.from_arrays(new_rowptr, cols.astype(np.int32), vals,
                                     A.bs)
    sp = A.to_scipy().tocsr()
    n = sp.shape[0]
    if rp is not None:
        if mode == FORWARD:
            sp = sp[np.asarray(rp)]
        else:
            irp = np.empty(n, dtype=np.int64)
            irp[np.asarray(rp)] = np.arange(n)
            sp = sp[irp]
    if cp is not None:
        cp = np.asarray(cp)
        if mode == FORWARD:
            sp = sp.tocsc()[:, cp].tocsr()             # new[:, j] = old[:, cp[j]]
        else:
            sp = sp.tocsc()[:, np.argsort(cp)].tocsr()  # new[:, cp[j]] = old[:, j]
    sp.sort_indices()
    return CSRMatrix.from_scipy(sp)


def apply_scaling_matrix_(A, row_scale, col_scale, mode=FORWARD):
    """S_r · A · S_c with per-scalar-row and -column scalings (reference:
    ``ReorderingScaling::applyScaling``, reorderingscaling.cpp:268-340).
    FORWARD scales, INVERSE unscales; blocks scale entrywise as
    val[i,j](a,b) *= s_r[i·bs+a] · s_c[j·bs+b]."""
    import scipy.sparse as sps

    rs = np.asarray(row_scale, dtype=np.float64)
    cs = np.asarray(col_scale, dtype=np.float64)
    if mode == INVERSE:
        rs, cs = 1.0 / rs, 1.0 / cs
    if isinstance(A, BSRMatrix):
        bs = A.bs
        vals = np.array(A.vals, copy=True)
        rows = np.repeat(np.arange(A.nbrows), np.diff(A.rowptr))
        rsb = rs.reshape(A.nbrows, bs)
        csb = cs.reshape(A.nbrows, bs)
        vals *= rsb[rows][:, :, None] * csb[A.colind][:, None, :]
        return BSRMatrix.from_arrays(A.rowptr, A.colind, vals, bs,
                                     diagind=A.diagind)
    sp = A.to_scipy().tocsr()
    out = (sps.diags(rs) @ sp @ sps.diags(cs)).tocsr()
    out.sort_indices()
    return CSRMatrix.from_scipy(out)


def apply_ordering_vector(v, p, mode=FORWARD, bs: int = 1):
    if p is None:
        return np.asarray(v).copy()
    v = np.asarray(v)
    seg = v.reshape(-1, bs)
    if mode == FORWARD:
        out = seg[p]          # entry i of the result = entry p[i] of v
    else:
        out = np.empty_like(seg)
        out[p] = seg
    return out.reshape(v.shape)


class RCMReordering(Reordering):
    """Symmetric reverse-Cuthill-McKee (bandwidth-minimising) ordering."""

    def compute(self, A) -> None:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        sp = A.to_scipy().tocsr()
        perm = np.asarray(reverse_cuthill_mckee(sp, symmetric_mode=True),
                          dtype=np.int64)
        self.set_ordering(perm, perm)


class ReorderedILU0Preconditioner:
    """ILU(0) on a reordered copy of the matrix, with vector permutations
    around the apply (reference: ReorderedAsyncILU0_SRPreconditioner,
    solverops_ilu0.cpp:398-476 — recomputes the reordering at every compute
    and factorizes the reordered copy).  The reordered matrix and its ILU(0)
    live on ``device`` (the card unless asked).

    With forward reordering Ã = A[rp][:, cp], the preconditioner solve
    M z ≈ r becomes z = P_c · M̃⁻¹ · P_r r: P_r gathers rows forward and
    P_c scatters the solution back (the inverse column apply).  A
    reordering without a column permutation (MC64's) leaves the solution
    unscattered; the JAX class scatters it by the row permutation there,
    which is not the inverse of Ã (ROADMAP.md §3)."""

    def __init__(self, A, reordering: Reordering, settings=None,
                 prefer_dia: bool = True, *, device="cuda"):
        from ..config import AsyncSolverSettings, PrecType
        from ..sparse.csr import as_device

        self.A = A
        self.reord = reordering
        self.settings = settings or AsyncSolverSettings(
            prec_type=PrecType.ILU0)
        self.prefer_dia = prefer_dia
        self.device = as_device(device)
        self.inner = None

    @property
    def mat(self):
        """The device matrix of the inner (reordered) preconditioner."""
        return self.inner.mat

    def compute(self):
        from ..factory import create_preconditioner, to_device_matrix

        self.reord.compute(self.A)
        At = self.reord.apply_to_matrix(self.A, FORWARD)
        D = to_device_matrix(At, device=self.device,
                             prefer_dia=self.prefer_dia)
        self.inner = create_preconditioner(D, self.settings)
        self._rp, self._cp = (
            None if p is None else torch.from_numpy(p).to(self.device)
            for p in (self.reord.rp, self.reord.cp))
        return self.inner.compute()

    def update_values(self, vals):
        """New values for the original (unpermuted) matrix; the next
        compute() recomputes the reordering and re-factorizes."""
        with annotate("precond.update"):
            if isinstance(vals, torch.Tensor):
                vals = vals.cpu().numpy()
            self.A = self.A.with_vals(vals)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        if self._rp is not None:
            r = r[self._rp]                      # forward row gather
        zt = self.inner.apply(r)
        if self._cp is None:
            return zt
        # inverse column apply: z[cp[j]] = z̃[j]
        return torch.zeros_like(zt).index_copy_(0, self._cp, zt)

    apply_flat = apply

    def apply_relax(self, b, x):
        raise NotImplementedError


class MaxMatchingReordering(Reordering):
    """Open-algorithm analogue of MC64's five jobs (reference: the ``MC64``
    subclass of ReorderingScaling, reorderingscaling.hpp and the mc64ad_
    wrapper in src/reorderingscaling.cpp, HAVE_MC64 only; job semantics per
    the HSL MC64 spec, exercised in tests/mat_ops/testmc64.cpp):

    1. maximise the number of nonzero diagonal entries (maximum-cardinality
       bipartite matching),
    2. maximise the smallest |diagonal| entry (bottleneck matching by a
       binary search over the magnitudes with perfect-matching checks),
    3. the same objective as 2 (MC64 jobs 2 and 3 differ in algorithm only),
    4. maximise the diagonal |sum| (maximum-weight assignment),
    5. maximise the diagonal |product| (assignment on −log|a|), plus the
       symmetric equilibration s = 1/√|ã_ii| of the permuted matrix in
       place of MC64's dual scalings.

    Produces a row permutation: FORWARD application puts the matched entry
    of column i on the diagonal of row i."""

    def __init__(self, job: int = 5):
        super().__init__()
        if job not in (1, 2, 3, 4, 5):
            raise ValueError("MC64-analogue job must be in 1..5")
        self.job = job
        self.row_scale = None
        self.col_scale = None

    @staticmethod
    def _matching_to_rp(rows_m, cols_m, n) -> np.ndarray:
        rp = np.full(n, -1, dtype=np.int64)
        rp[cols_m] = rows_m                   # rp[col] = matched row
        missing_rows = np.setdiff1d(np.arange(n), rows_m, assume_unique=False)
        rp[rp < 0] = missing_rows             # structurally singular leftover
        return rp

    def _cardinality(self, sp, n) -> None:
        import scipy.sparse.csgraph as csg

        m = csg.maximum_bipartite_matching(sp, perm_type="row")
        cols = np.flatnonzero(m >= 0)
        self.set_ordering(self._matching_to_rp(m[cols], cols, n), None)

    def compute(self, A) -> None:
        import scipy.sparse.csgraph as csg

        # a copy: to_scipy() may wrap the container's arrays
        sp = A.to_scipy().tocsr().copy()
        sp.eliminate_zeros()
        n = sp.shape[0]

        if self.job == 1:
            self._cardinality(sp, n)
            return

        if self.job in (2, 3):
            # bottleneck: the largest t such that {|a| >= t} has a perfect
            # matching
            vals = np.unique(np.abs(sp.data))
            lo, hi = 0, len(vals) - 1
            best = None
            while lo <= hi:
                mid = (lo + hi) // 2
                filt = sp.copy()
                filt.data = np.where(np.abs(filt.data) >= vals[mid],
                                     1.0, 0.0)
                filt.eliminate_zeros()
                m = csg.maximum_bipartite_matching(filt.tocsr(),
                                                   perm_type="row")
                if (m >= 0).all():
                    best = m
                    lo = mid + 1
                else:
                    hi = mid - 1
            if best is None:        # structurally singular: job 1's answer
                self._cardinality(sp, n)
                return
            self.set_ordering(self._matching_to_rp(best, np.arange(n), n),
                              None)
            return

        # jobs 4 and 5: a full assignment on transformed weights, kept
        # strictly positive (the sparse LAP treats stored zeros as missing
        # edges): Σ(C − |a|) minimal maximises Σ|a| (job 4), Σ(−log|a|)
        # minimal maximises Π|a| (job 5)
        w = abs(sp)
        if self.job == 4:
            C = float(w.data.max()) * (1.0 + 1e-12) + 1.0
            w.data = C - w.data
        else:
            tiny = np.finfo(np.float64).tiny
            w.data = 1.0 + np.log(float(w.data.max()) + tiny) \
                - np.log(w.data + tiny)
        rows_m, cols_m = csg.min_weight_full_bipartite_matching(w.tocsr())
        self.set_ordering(self._matching_to_rp(rows_m, cols_m, n), None)

        if self.job == 5:
            d = np.abs(sp[self.rp].diagonal())
            d[d == 0] = 1.0
            self.row_scale = 1.0 / np.sqrt(d)
            self.col_scale = 1.0 / np.sqrt(d)

    def apply_scaling_matrix(self, A, mode=FORWARD):
        """S_r · A · S_c with the job-5 scalings on an (already
        row-permuted) matrix (reference: reorderingscaling.cpp:268-340)."""
        if self.row_scale is None:
            raise ValueError("no scalings computed (job 5 only)")
        return apply_scaling_matrix_(A, self.row_scale, self.col_scale, mode)

    def apply_scaling_vector(self, v, mode=FORWARD, direction=ROW):
        """(reference: applyScaling(vec), reorderingscaling.cpp:300-340)"""
        if self.row_scale is None:
            raise ValueError("no scalings computed (job 5 only)")
        s = self.row_scale if direction == ROW else self.col_scale
        if mode == INVERSE:
            s = 1.0 / s
        return np.asarray(v) * s


class MaxDiagonalScaling(Reordering):
    """Symmetric equilibration s_i = 1/√|a_ii|, with an optional row
    permutation maximising the diagonal product — the open-algorithm
    stand-in for the reference's MC64 wrapper (reference:
    solverops_ilu0.hpp MC64, HAVE_MC64 only)."""

    def __init__(self, permute: bool = False):
        super().__init__()
        self.permute = permute
        self.row_scale = None
        self.col_scale = None

    def compute(self, A) -> None:
        sp = A.to_scipy().tocsr()
        d = np.abs(sp.diagonal())
        d[d == 0] = 1.0
        self.row_scale = 1.0 / np.sqrt(d)
        self.col_scale = 1.0 / np.sqrt(d)
        if self.permute:
            import scipy.sparse.csgraph as csg

            # maximum-product bipartite matching on −log|a_ij|: row rp[i]
            # carries the matched entry of column i
            logs = sp.copy()
            logs.data = -np.log(np.abs(logs.data) + 1e-300)
            rows_m, cols_m = csg.min_weight_full_bipartite_matching(
                logs.tocsr())
            rp = np.empty(sp.shape[0], dtype=np.int64)
            rp[cols_m] = rows_m
            self.set_ordering(rp, None)

    def apply_scaling_matrix(self, A, mode=FORWARD):
        return apply_scaling_matrix_(A, self.row_scale, self.col_scale, mode)

    def apply_scaling_vector(self, v, direction=ROW, mode=FORWARD):
        s = self.row_scale if direction == ROW else self.col_scale
        if mode == INVERSE:
            s = 1.0 / s
        return np.asarray(v) * s
