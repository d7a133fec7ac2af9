"""zero_start_sweep_roofline: K12's (``zero_start_sweep_kernel``, the
zero-start sweep at the head of each ILU(0) apply chain from zero) share
of its roofline in the traced systems, in %: the least time of a launch at
the card's bandwidth over its mean device time.  An apply runs one
unit-lower launch (the 3 lower diagonals, the right-hand side and the
output: 5 streams) and one upper launch (the 3 upper diagonals, the
right-hand side, the inverse diagonal and the output: 6 streams), so a
launch's least bytes are 5.5 streams of the card's rows.  A program
without the kernel reads nothing."""

from benchmark.metrics._bytes import HBM_BYTES_PER_S

KERNEL = "zero_start_sweep_kernel"

#: (n,) streams moved by one launch, by mode.
STREAMS = {"lower": 5, "upper": 6}


def read(run):
    if run.trace is None:
        return None
    hits = [v for name, v in run.trace["kernels"].items() if KERNEL in name]
    launches = sum(c for c, _ in hits)
    if not launches:
        return None
    seconds = sum(s for _, s in hits) / launches
    streams = 0.5 * (STREAMS["lower"] + STREAMS["upper"])
    least = streams * run.rows_per_card * run.itemsize / HBM_BYTES_PER_S
    return 100.0 * least / seconds
