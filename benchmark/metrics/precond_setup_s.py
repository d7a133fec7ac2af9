"""precond_setup_s: host seconds of set-up's preconditioner phase, the
program's ``api.setup_local_preconditioner`` and the context's first
``api.compute_preconditioner`` (the first factor, the card synchronised),
from the program's counters."""

from benchmark.metrics._spans import counter_mean


def read(run):
    return counter_mean("setup.precond")
