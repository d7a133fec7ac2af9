"""krylov_update_roofline: K14's (BiCGSTAB's fused vector updates,
``krylov_p_update_kernel``, ``krylov_s_update_kernel`` and
``krylov_xr_update_kernel``) share of its roofline in the traced systems,
in %: the least time of one iteration's three launches at the card's
bandwidth over the sum of the three kernels' mean device times.  The p
pass reads r, p and v and writes p (4 streams), the s pass reads r and v
and writes s (3), the x-and-r pass reads x, y, z, s and t and writes x and
r (7): 14 (n,) streams an iteration, of ``rows_per_card · block_size``
values each, all counted at the HBM bandwidth.  That bound holds where the
vectors exceed the card's 50 MB L2, as the Bratu cells' 67 MB f32 vectors
do; ex19's 33.5 MB f64 vectors fit it, so a pass there can read an operand
the SpMV has just left in L2, and the ex19 cell does not list the metric.
A program without all three kernels reads nothing."""

from benchmark.metrics._bytes import HBM_BYTES_PER_S
from benchmark.metrics._kernel_time import mean_launch_seconds

#: (n,) streams moved by one launch, by kernel.
STREAMS = {"krylov_p_update_kernel": 4, "krylov_s_update_kernel": 3,
           "krylov_xr_update_kernel": 7}


def read(run):
    seconds = 0.0
    for kernel in STREAMS:
        mean = mean_launch_seconds(run, kernel)
        if mean is None:
            return None
        seconds += mean
    n = run.rows_per_card * run.block_size
    least = sum(STREAMS.values()) * n * run.itemsize / HBM_BYTES_PER_S
    return 100.0 * least / seconds
