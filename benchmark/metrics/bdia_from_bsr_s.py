"""bdia_from_bsr_s: host seconds of one call of the program's
``sparse/bdia.py::try_bdia_from_bsr`` in set-up (the host BSR to the block
band on the card), from the program's counters; nothing from a program
without them."""

from benchmark.metrics._spans import counter_mean


def read(run):
    return counter_mean("setup.bdia_from_bsr")
