"""dia_from_csr_s: host seconds of one call of the program's
``sparse/dia.py::try_dia_from_csr`` in set-up (the host CSR to the band on
the card), from the program's counters."""

from benchmark.metrics._spans import counter_mean


def read(run):
    return counter_mean("setup.dia_from_csr")
