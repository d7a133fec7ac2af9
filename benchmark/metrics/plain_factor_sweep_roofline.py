"""plain_factor_sweep_roofline: K8's (``plain_factor_sweep_kernel``) share
of its roofline in the traced systems, in %: the least time of a launch
at the card's bandwidth (18 streams of the card's rows) over its mean
device time."""

from benchmark.metrics._bytes import least_seconds

KERNEL = "plain_factor_sweep_kernel"


def read(run):
    if run.trace is None:
        return None
    hits = [v for name, v in run.trace["kernels"].items() if KERNEL in name]
    launches = sum(c for c, _ in hits)
    if not launches:
        return None
    seconds = sum(s for _, s in hits) / launches
    return 100.0 * least_seconds("plain_factor_sweep", run.rows_per_card,
                                 run.itemsize) / seconds
