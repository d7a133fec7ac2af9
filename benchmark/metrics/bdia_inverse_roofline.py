"""bdia_inverse_roofline: the block inverse kernel's
(``bdia_block_inverse_kernel``) share of its roofline in the traced
systems, in %: the least time of a launch at the card's bandwidth (2·bs²
values and a mask byte a block row) over its mean device time."""

from benchmark.metrics._block_bytes import inverse_bytes, least_seconds
from benchmark.metrics._kernel_time import mean_launch_seconds


def read(run):
    seconds = mean_launch_seconds(run, "bdia_block_inverse_kernel")
    if seconds is None:
        return None
    return 100.0 * least_seconds(inverse_bytes(run.block_size, run.itemsize),
                                 run.rows_per_card) / seconds
