"""bdia_spmv_roofline: K5's (``bdia_spmv_kernel``) share of its roofline in
the traced systems, in %: the least time of a launch at the card's
bandwidth (the 5-point block star's k·bs² + 2·bs values a block row) over
its mean device time."""

from benchmark.metrics._block_bytes import STAR5, least_seconds, spmv_values
from benchmark.metrics._kernel_time import mean_launch_seconds


def read(run):
    seconds = mean_launch_seconds(run, "bdia_spmv_kernel")
    if seconds is None:
        return None
    values = spmv_values(STAR5["diags"], run.block_size)
    return 100.0 * least_seconds(values * run.itemsize,
                                 run.rows_per_card) / seconds
