"""flag_wait_ms: how long the host waits, per Krylov iteration, for the
card to drain what the iteration queued, in ms: the program's ``sync.flag``
spans (the host read of the done flag) summed over its ``krylov.iter``
spans, in the traced systems."""

from benchmark.metrics._spans import iteration_split


def read(run):
    split = iteration_split(run)
    if split is None:
        return None
    iters, _, flag_ns = split
    return flag_ns / iters / 1e6
