"""bdia_head_sweep_roofline: K13's (``bdia_head_sweep_kernel``, the block
head sweep that starts each block ILU(0) apply chain from zero) share of
its roofline in the traced systems, in %: the mean of the lower mode's and
the upper mode's shares, each the least time of a launch at the card's
bandwidth over the mode's mean device time (an apply runs one launch of
each).  A launch reads the mode's block diagonals and the right-hand side
and writes the output, with no iterate: lowers·bs² + 2·bs values a block
row, and uppers·bs² + bs² + 2·bs in the upper mode, which also reads the
inverse diagonal blocks (40 and 56 on ex19's 5-point star of 4×4 blocks).
A program without the kernel reads nothing."""

from benchmark.metrics._block_bytes import STAR5, least_seconds
from benchmark.metrics._kernel_time import mean_launch_seconds

KERNEL = "bdia_head_sweep_kernel"
#: The template flag that names each mode in the trace.
MODES = {"lower": "false>", "upper": "true>"}


def head_values(mode: str, diags: int, bs: int) -> int:
    """K13's values a block row; ``diags`` the mode's block diagonals."""
    extra = {"lower": 0, "upper": bs * bs}[mode]
    return diags * bs * bs + extra + 2 * bs


def read(run):
    shares = []
    for mode, flag in MODES.items():
        seconds = mean_launch_seconds(run, KERNEL, flag)
        if seconds is None:
            return None
        values = head_values(mode, STAR5[mode + "s"], run.block_size)
        shares.append(least_seconds(values * run.itemsize,
                                    run.rows_per_card) / seconds)
    return 100.0 * sum(shares) / len(shares)
