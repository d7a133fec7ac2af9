"""Mean device time of a kernel's launches in the traced systems."""

from __future__ import annotations

__all__ = ["mean_launch_seconds"]


def mean_launch_seconds(run, kernel: str, mode: str = "") -> float | None:
    """Mean seconds of one launch of ``kernel`` (names that hold it, and
    ``mode`` where given) in the device trace; ``None`` without a trace or
    a launch."""
    if run.trace is None:
        return None
    hits = [v for name, v in run.trace["kernels"].items()
            if kernel in name and mode in name]
    launches = sum(c for c, _ in hits)
    if not launches:
        return None
    return sum(s for _, s in hits) / launches
