"""block_krylov_iters: mean Krylov iterations per system on the
block-banded route (``SolveInfo.iters``, the program's count)."""

from benchmark.metrics._end_to_end import mean


def read(run):
    if not run.iters:
        return None
    return mean(run.iters)
