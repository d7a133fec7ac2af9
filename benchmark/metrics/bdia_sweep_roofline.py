"""bdia_sweep_roofline: K7's (``bdia_sweep_kernel``, the block ILU(0) apply
sweep) share of its roofline in the traced systems, in %: the mean of the
lower mode's and the upper mode's shares, each the least time of a launch
at the card's bandwidth over the mode's mean device time (an apply runs
as many launches of each)."""

from benchmark.metrics._block_bytes import STAR5, least_seconds, sweep_values
from benchmark.metrics._kernel_time import mean_launch_seconds

KERNEL = "bdia_sweep_kernel"
#: The template flag that names each mode in the trace.
MODES = {"lower": "false>", "upper": "true>"}


def read(run):
    shares = []
    for mode, flag in MODES.items():
        seconds = mean_launch_seconds(run, KERNEL, flag)
        if seconds is None:
            return None
        values = sweep_values(mode, STAR5[mode + "s"], run.block_size)
        shares.append(least_seconds(values * run.itemsize,
                                    run.rows_per_card) / seconds)
    return 100.0 * sum(shares) / len(shares)
