"""bdia_factor_roofline: K6's (``bdia_factor_kernel``, one compressed block
Chow–Patel sweep, both modes) share of its roofline in the traced systems,
in %: the least time of a launch at the card's bandwidth (bs² + 2p·bs² +
2·bs² values a block row, p = 2 pairs on the 5-point block star) over its
mean device time."""

from benchmark.metrics._block_bytes import STAR5, factor_values, least_seconds
from benchmark.metrics._kernel_time import mean_launch_seconds


def read(run):
    seconds = mean_launch_seconds(run, "bdia_factor_kernel")
    if seconds is None:
        return None
    values = factor_values(STAR5["pairs"], run.block_size)
    return 100.0 * least_seconds(values * run.itemsize,
                                 run.rows_per_card) / seconds
