"""Least bytes of the block-DIA kernels, for their roofline shares: the
byte bounds of the port's kernel table (``PERF.md`` §6), as values a block
row.

Each count reads every input once and writes every output once, in the
kernels' layouts: (bs², nb) block slabs and (bs, nb) vector streams of the
band's dtype.  For k block diagonals, block size bs and p fill pairs:

- K5 (``bdia_spmv_kernel``): the k block diagonals, x and y:
  k·bs² + 2·bs;
- K7 (``bdia_sweep_kernel``), lower mode: the lower block diagonals, the
  right-hand side, the iterate and the output: lowers·bs² + 3·bs; upper
  mode: the upper ones, the inverse diagonal blocks and the same three
  vectors: uppers·bs² + bs² + 3·bs;
- K6 (``bdia_factor_kernel``): the centre's base values, the p pair
  lowers' base values and the p pre-shifted pair uppers, the previous
  inverse diagonal and the output: bs² + 2p·bs² + 2·bs²;
- the block inverse (``bdia_block_inverse_kernel``): 2·bs² values and one
  mask byte.
"""

from __future__ import annotations

from benchmark.metrics._bytes import HBM_BYTES_PER_S

__all__ = ["STAR5", "spmv_values", "sweep_values", "factor_values",
           "inverse_bytes", "least_seconds"]

#: The 2D 5-point block star (ex19's band): 5 block diagonals, 2 lower and
#: 2 upper, and 2 fill pairs, both on the centre.
STAR5 = {"diags": 5, "lowers": 2, "uppers": 2, "pairs": 2}


def spmv_values(diags: int, bs: int) -> int:
    return diags * bs * bs + 2 * bs


def sweep_values(mode: str, diags: int, bs: int) -> int:
    """K7's values a block row; ``diags`` the mode's block diagonals."""
    extra = {"lower": 0, "upper": bs * bs}[mode]
    return diags * bs * bs + extra + 3 * bs


def factor_values(pairs: int, bs: int) -> int:
    return bs * bs + 2 * pairs * bs * bs + 2 * bs * bs


def inverse_bytes(bs: int, itemsize: int) -> int:
    return 2 * bs * bs * itemsize + 1


def least_seconds(bytes_per_row: float, nb: int) -> float:
    """The least time one launch over ``nb`` block rows can take at the
    card's bandwidth."""
    return bytes_per_row * nb / HBM_BYTES_PER_S
