"""ops_per_iter: device operations (kernels, copies and sets) per Krylov
iteration: every device operation of the traced systems' device trace over
the program's ``krylov.iter`` spans of the same systems (a newton cell's
value update and re-factor, about ten operations a system, are in the
numerator too)."""

from benchmark.metrics._spans import iteration_split


def read(run):
    split = iteration_split(run)
    if split is None:
        return None
    ops = sum(count for count, _ in run.trace["kernels"].values())
    return ops / split[0] if ops else None
