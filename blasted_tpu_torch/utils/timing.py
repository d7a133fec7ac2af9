"""Per-context timers (reference: Blasted_data time fields,
include/blasted_petsc.h:56-84 — factor/apply wall and CPU times and call
counters).

Port of ``PrecTimers`` and ``total_times`` from
``blasted_tpu/utils/timing.py``.  PyTorch
returns before a CUDA device has finished, so a span on a CUDA device
synchronises it before reading the clock at both ends: the time covers the
device work done inside the span.  A distributed solve's span names every
shard device and synchronises each.  Each synchronisation is a
``sync.timers`` span of ``utils/profiling.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from .profiling import annotate

__all__ = ["PrecTimers", "best_ms", "synchronize", "total_times"]


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op off CUDA)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_ms(fn, device: torch.device, reps: int) -> tuple:
    """Best of ``reps`` timed calls of ``fn()`` after one untimed call: CUDA
    events around each call on a CUDA device, the host clock elsewhere.
    Returns (ms, the last call's result)."""
    fn()
    synchronize(device)
    best, out = float("inf"), None
    for _ in range(reps):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            out = fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best, out


@dataclass
class PrecTimers:
    factor_walltime: float = 0.0
    factor_cputime: float = 0.0
    apply_walltime: float = 0.0
    apply_cputime: float = 0.0
    factor_calls: int = 0
    apply_calls: int = 0

    def time_factor(self, device):
        """A span over ``device``, or over every device of a sequence."""
        return _Span(self, "factor", device)

    def time_apply(self, device):
        return _Span(self, "apply", device)


class _Span:
    def __init__(self, t: PrecTimers, kind: str, device):
        self.t = t
        self.kind = kind
        devices = device if isinstance(device, (tuple, list)) else (device,)
        self.devices = tuple(dict.fromkeys(torch.device(d) for d in devices))

    def _sync(self):
        with annotate("sync.timers"):
            for dev in self.devices:
                synchronize(dev)

    def __enter__(self):
        self._sync()
        self.w0 = time.perf_counter()
        self.c0 = time.process_time()
        return self

    def __exit__(self, *exc):
        self._sync()
        w = time.perf_counter() - self.w0
        c = time.process_time() - self.c0
        if self.kind == "factor":
            self.t.factor_walltime += w
            self.t.factor_cputime += c
            self.t.factor_calls += 1
        else:
            self.t.apply_walltime += w
            self.t.apply_cputime += c
            self.t.apply_calls += 1
        return False


def total_times(contexts) -> PrecTimers:
    """Sum the timers of a list of contexts (or of timers) (reference:
    computeTotalTimes, blasted_petsc.cpp:723-735)."""
    tot = PrecTimers()
    for c in contexts:
        t = c.timers if hasattr(c, "timers") else c
        tot.factor_walltime += t.factor_walltime
        tot.factor_cputime += t.factor_cputime
        tot.apply_walltime += t.apply_walltime
        tot.apply_cputime += t.apply_cputime
        tot.factor_calls += t.factor_calls
        tot.apply_calls += t.apply_calls
    return tot
