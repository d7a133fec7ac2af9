"""block_apply_ms: device time of one block ILU(0) apply, in ms: the device
seconds of the apply sweeps (``bdia_sweep_kernel``, K7, which run only
inside the program's ``precond.block_apply`` spans) in the traced systems
over the number of those spans.  The apply's two fills and two transposes
are generic device operations that the trace's summary does not tie to a
span, and are left out.  Nothing without a device trace or without the
spans."""

from benchmark.metrics._block_spans import span_count

KERNEL = "bdia_sweep_kernel"


def read(run):
    applies = span_count(run, "precond.block_apply")
    if not applies:
        return None
    seconds = sum(s for name, (_, s) in run.trace["kernels"].items()
                  if KERNEL in name)
    return 1e3 * seconds / applies if seconds else None
