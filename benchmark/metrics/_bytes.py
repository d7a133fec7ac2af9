"""Least bytes and the card's peak for the roofline shares (a frozen copy
of the scalar byte models of ``chip_smoke.py``'s ``scalar_work`` and
``blasted_tpu_torch/bench/roofline.py``'s ``scalar_models``).

Each count reads every input byte once and writes every output byte once,
in (n,) streams of the band's dtype:

- K2 (``tri_sweep_kernel``), one ILU(0) apply sweep on the 7-point band:
  the upper mode reads its 3 diagonals, the right-hand side, the inverse
  diagonal and the iterate and writes the new iterate (7 streams); the
  unit-lower mode has no inverse diagonal (6 streams);
- K8 (``plain_factor_sweep_kernel``), one Chow–Patel sweep of the pruned
  (tuple) form: the base of the 3 lowers and the diagonal, the 7 rows of
  the iterate and the 7 rows of its fresh output (18 streams).
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "STREAMS", "least_seconds"]

#: One NVIDIA H100 SXM's HBM3 bandwidth by its data sheet, at 700 W.
HBM_BYTES_PER_S = 3.35e12

#: (n,) streams moved by one launch, by kernel and mode.
STREAMS = {"tri_sweep.upper": 7, "tri_sweep.lower": 6,
           "plain_factor_sweep": 18}


def least_seconds(kernel: str, n: int, itemsize: int) -> float:
    """The least time one launch can take at the card's bandwidth."""
    return STREAMS[kernel] * n * itemsize / HBM_BYTES_PER_S
