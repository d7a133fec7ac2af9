"""block_factor_ms: host time a system inside the program's block factor
spans, in ms: ``precond.block_factor`` (the factor sweeps of
``BlockDiaILU0Preconditioner.compute``) and ``precond.block_inverse`` (the
inverse diagonal blocks the applies read), summed over the traced systems
and divided by their number.  The spans close when the host has issued
the work; nothing where the program has no such spans."""

from benchmark.metrics._block_spans import span_seconds

SPANS = ("precond.block_factor", "precond.block_inverse")


def read(run):
    seconds = span_seconds(run, SPANS)
    if seconds is None:
        return None
    return 1e3 * seconds / run.trace["systems"]
