"""Block-DIA products: the SpMV (K5) and the apply sweeps (K7) on column
streams.

Port of ``blasted_tpu/ops/bdia.py:31-103`` (reference: the per-row Eigen
block products of src/blas/matvecs.cpp:107-182 and
kernels_ilu_apply.hpp:54-94).  Each selected block diagonal contributes
``data[d, r] @ x[r + off_d]``.  Block vectors are ``(nb, bs)`` at the API
boundary and travel inside sweep loops as one ``(bs, nb)`` tensor of column
streams (the JAX package's tuple of bs columns).  ``bdia_spmv`` is kernel K5
and the apply sweeps are kernel K7 (CUDA on a CUDA tensor, the twin on a
CPU tensor; ``ops/bstencil.py``), which the JAX package leaves to XLA: it
has no Pallas kernel for them.  Per element the sums run in the JAX order
(over the diagonals, then over j), so the numbers are the same.  The other
products here (``soa_mv_streams``, ``soa_dinv_mul``, the twins' bodies)
are torch operations: each diagonal shifts the column streams once, and
one operation covers all bs output rows.
"""

from __future__ import annotations

import torch

from ..sparse.bdia import BlockDiaMatrix
from .bstencil import (
    bdia_lower_sweep_ref,
    bdia_lower_sweep_stencil,
    bdia_spmv_stencil,
    bdia_upper_sweep_ref,
    bdia_upper_sweep_stencil,
    soa_dinv_mul,
    soa_mv_streams,
)

__all__ = ["cols_of", "stack_cols", "soa_mv_streams", "soa_dinv_mul",
           "soa_unit_lower_sweep", "soa_upper_solve_sweep", "bdia_mv",
           "bdia_spmv"]


def cols_of(x: torch.Tensor) -> torch.Tensor:
    """(nb, bs) block vector → (bs, nb) column streams."""
    return x.t().contiguous()


def stack_cols(cols: torch.Tensor) -> torch.Tensor:
    """(bs, nb) column streams → (nb, bs) block vector."""
    return cols.t().contiguous()


def soa_unit_lower_sweep(data, offsets, lower, z_cols, y_cols, bs: int):
    """One ``y ← z − L y`` sweep on column streams (unit block diagonal;
    reference: kernels_ilu_apply.hpp block_unit_lower_triangular, :54-67):
    K7's lower mode.  A factor stored in another dtype than the vectors'
    (``apply_dtype``) takes the twin's products in the vectors' dtype and
    launches no K7, as the scalar apply takes no K2 (``ops/sweeps.py``):
    the rule is fixed by the dtypes, never by a failed launch."""
    if data.dtype != z_cols.dtype:
        return bdia_lower_sweep_ref(data, offsets, lower, z_cols, y_cols)
    return bdia_lower_sweep_stencil(data, offsets, lower, z_cols, y_cols)


def soa_upper_solve_sweep(data, dinv, offsets, upper, y_cols, z_cols,
                          bs: int):
    """One ``z ← U_ii⁻¹ (y − U z)`` sweep on column streams (diagonal
    pre-inverted; reference: kernels_ilu_apply.hpp block_upper_triangular,
    :79-94): K7's upper mode, with :func:`soa_unit_lower_sweep`'s dtype
    rule."""
    if data.dtype != y_cols.dtype:
        return bdia_upper_sweep_ref(data, dinv, offsets, upper, y_cols,
                                    z_cols)
    return bdia_upper_sweep_stencil(data, dinv, offsets, upper, y_cols,
                                    z_cols)


def bdia_mv(A: BlockDiaMatrix, data: torch.Tensor, x: torch.Tensor,
            which: str) -> torch.Tensor:
    """Σ over the selected block diagonals of ``data`` (A's layout) times
    the (nb, bs) block vector ``x``; which: 'all' | 'lower' | 'upper'."""
    sel_fn = {"all": lambda o: True, "lower": lambda o: o < 0,
              "upper": lambda o: o > 0}[which]
    sel = [d for d, o in enumerate(A.offsets) if sel_fn(o)]
    return stack_cols(soa_mv_streams(data, A.offsets, sel, cols_of(x), A.bs))


def bdia_spmv(A: BlockDiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x on (nb, bs) block vectors through K5, whatever the band
    width (the TPU's halo-width gate has no counterpart on the card)."""
    return bdia_spmv_stencil(A.offsets, A.data, x)
