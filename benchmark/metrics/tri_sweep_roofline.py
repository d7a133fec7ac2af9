"""tri_sweep_roofline: K2's (``tri_sweep_kernel``) share of its roofline
in the traced systems, in %: the least time of a launch at the card's
bandwidth over its mean device time.  An ILU(0) apply runs as many
unit-lower (6 streams) as upper (7 streams) sweeps, so a launch's least
bytes are 6.5 streams of the card's rows."""

from benchmark.metrics._bytes import least_seconds

KERNEL = "tri_sweep_kernel"


def read(run):
    if run.trace is None:
        return None
    hits = [v for name, v in run.trace["kernels"].items() if KERNEL in name]
    launches = sum(c for c, _ in hits)
    if not launches:
        return None
    seconds = sum(s for _, s in hits) / launches
    least = 0.5 * (least_seconds("tri_sweep.lower", run.rows_per_card,
                                 run.itemsize)
                   + least_seconds("tri_sweep.upper", run.rows_per_card,
                                   run.itemsize))
    return 100.0 * least / seconds
