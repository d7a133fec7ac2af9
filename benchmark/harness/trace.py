"""Spans from the benchmark's own files, and the device trace.

:class:`Spans` times each call into a layer (``update``, ``factor``,
``krylov``) on the host clock, synchronising the route's devices at both
ends so that a span covers the device work its call queued; it is on only
in a traced run (``--trace 1``), and then also names the span in the
profiler's trace (``bench.<name>``).  :func:`profile_systems` runs a few
systems under ``torch.profiler`` and reduces the trace to the device busy
time of each card (the union of its kernel, copy and set intervals), the
device time by kernel name and the idle gaps by the span the host was in.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from ..metrics._intervals import gaps, union_seconds

__all__ = ["Spans", "profile_systems", "DEVICE_CATS"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Spans:
    """Per-layer spans; a no-op unless ``on``."""

    def __init__(self, devices, on: bool):
        self.devices = tuple(devices)
        self.on = on
        self.times = defaultdict(list)

    def _sync(self):
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench." + name):
            yield
            self._sync()
        self.times[name].append(time.perf_counter() - t0)


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"] if "dur" in e]
    finally:
        os.unlink(path)


def _card(e) -> str:
    return str(e.get("args", {}).get("device", e.get("pid")))


def profile_systems(run_systems, sync) -> dict:
    """Profile ``run_systems()`` (which runs a few systems) and reduce the
    trace: ``window_s`` (host clock, synchronised at both ends),
    ``busy_s`` by card, ``kernels`` {name: [launches, seconds]} summed over
    the cards, and ``idle_by_span`` {span: seconds} summed over the cards,
    each gap between two device intervals of a card charged to the
    innermost benchmark span open on the host when it began (``between``
    where none was)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        run_systems()
        sync()
        window_s = time.perf_counter() - t0
    trace = _events(prof)
    device = [e for e in trace if e.get("cat") in DEVICE_CATS]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][len("bench."):]) for e in trace
                    if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("bench.")),
                   key=lambda s: s[0])
    by_card = defaultdict(list)
    kernels = defaultdict(lambda: [0, 0.0])
    for e in device:
        t0_us, dur = float(e["ts"]), float(e["dur"])
        by_card[_card(e)].append((t0_us, t0_us + dur))
        rec = kernels[e["name"][:80]]
        rec[0] += 1
        rec[1] += dur / 1e6
    idle = defaultdict(float)
    for ivs in by_card.values():
        for g0, g1 in gaps(ivs):
            inner = [s for s in spans if s[0] <= g0 < s[1]]
            label = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
                else "between"
            idle[label] += (g1 - g0) / 1e6
    return {"window_s": window_s,
            "busy_s": {c: union_seconds(ivs) for c, ivs in by_card.items()},
            "kernels": dict(kernels), "idle_by_span": dict(idle)}


def breakdown(trace: dict) -> dict:
    """The ``breakdown`` of the result line: the device operations that
    took most time and the idle time by host span, per card."""
    cards = max(len(trace["busy_s"]), 1)
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][1])[:TOP]
    idle = sorted(trace["idle_by_span"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[name, secs / cards] for name, (_, secs) in ops],
            "idle_gaps": [[name, secs / cards] for name, secs in idle]}
