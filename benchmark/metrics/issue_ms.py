"""issue_ms: the host's time to enqueue one Krylov iteration, in ms: the
program's mean ``krylov.iter`` span less its ``sync.flag`` child (the
flag read), in the traced systems."""

from benchmark.metrics._spans import iteration_split


def read(run):
    split = iteration_split(run)
    if split is None:
        return None
    iters, iter_ns, flag_ns = split
    return (iter_ns - flag_ns) / iters / 1e6
