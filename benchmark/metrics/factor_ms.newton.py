"""factor_ms.newton: mean span of ``api.compute_preconditioner`` per system
(the re-factor after a value update), in ms (host clock, synchronised at
both ends); nothing where the mix does not re-factor."""

from benchmark.metrics._end_to_end import mean


def read(run):
    t = run.spans.get("factor")
    return mean(t) * 1e3 if t else None
