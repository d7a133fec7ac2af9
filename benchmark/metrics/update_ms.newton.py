"""update_ms.newton: mean span of ``Preconditioner.update_values`` per
system, in ms (the benchmark's span, host clock, synchronised at both
ends); nothing where the mix does not update values."""

from benchmark.metrics._end_to_end import mean


def read(run):
    t = run.spans.get("update")
    return mean(t) * 1e3 if t else None
