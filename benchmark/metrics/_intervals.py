"""Interval arithmetic of the device trace (a frozen copy of
``scripts/profile_solves.py``'s ``_busy_ms``, in seconds).

Intervals are (start, end) pairs in microseconds, as the profiler's trace
writes them.
"""

from __future__ import annotations

__all__ = ["union_seconds", "gaps"]


def union_seconds(intervals) -> float:
    """The length of the union of the intervals, in seconds."""
    busy_us, end = 0.0, -1.0
    for t0, t1 in sorted(intervals):
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy_us / 1e6


def gaps(intervals) -> list:
    """The gaps between the union's pieces, from the first interval's start
    to the last one's end, as (start, end) pairs."""
    out, end = [], None
    for t0, t1 in sorted(intervals):
        if end is not None and t0 > end:
            out.append((end, t0))
        end = t1 if end is None else max(end, t1)
    return out
