"""One run of one cell: set-up, warm-up, the measured window, the traced
systems, and the comparison with the plain reference.

The mix is a closed loop: one client sends the next linear system when the
last one has been solved, as a Newton solver does.  Every system ends in a
synchronise of the route's devices, and its wall time is taken on the host
clock.  The window runs whole systems until ``seconds`` have passed.
"""

from __future__ import annotations

import gc
import random
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .trace import Spans, breakdown, profile_systems

__all__ = ["Run", "run_cell", "FORBIDDEN", "forbidden_modules"]

#: Top-level module names no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "blasted_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole
    (``blasted_tpu_torch`` is not ``blasted_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Sample:
    slot: int
    x: torch.Tensor
    factor: dict | None


class Sampler:
    """One system of each slot of the pool, drawn uniformly from the seed
    among the systems run at that slot (reservoir sampling): its x and,
    where the route holds one, the factor its applies read, copied when
    it is produced."""

    def __init__(self, seed: int, route):
        self.rng = random.Random(seed)
        self.route = route
        self.seen: dict = {}
        self.items: dict = {}

    def offer(self, slot: int, x) -> None:
        self.seen[slot] = self.seen.get(slot, 0) + 1
        if self.rng.randrange(self.seen[slot]) == 0:
            self.items[slot] = Sample(slot, x.detach().clone(),
                                      self.route.factor())


@dataclass
class Run:
    """What the metric readers see of one run.

    ``rows_per_card`` counts the grid points (block rows) on one card, and
    ``block_size`` the unknowns at each (the configuration's ``"dof"``, 1
    where it has none): a card holds ``rows_per_card * block_size`` rows of
    the matrix."""

    rows_per_card: int
    itemsize: int
    setup_s: float
    block_size: int = 1
    window_s: float = 0.0
    system_s: list = field(default_factory=list)
    iters: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    trace: dict | None = None


def _devices_peak(devices) -> int:
    cuda = [d for d in devices if d.type == "cuda"]
    return max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)


def run_cell(cell, seed: int, seconds: float, trace: bool, devices,
             t_start: float, cache_dir=None) -> tuple:
    """Run ``cell`` once on ``devices``; returns (Run, outcome), outcome
    holding ``attempted``, ``failed``, ``checks`` ({name: [value,
    limit]}), ``correct``, ``memory_peak_bytes`` and, traced, the
    breakdown.  ``cache_dir`` keeps inputs that runs share (the
    problem's)."""
    cfg, mix = cell.config, cell.mix
    problem = cell.problem()
    inputs = problem.Inputs(cfg, mix, seed, devices[0], cache_dir)
    if torch.cuda.is_initialized():     # what making the inputs took
        for dev in devices:             # is not the program's
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
    route = cell.route()(inputs, cfg, devices)
    quiet = Spans(route.devices, False)
    for i in range(int(mix["warmup_systems"])):
        route.step(i, quiet)
        route.sync()
    # what set-up made stays: the collector's full passes in the window
    # scan only what the window makes
    gc.collect()
    gc.freeze()
    run = Run(rows_per_card=int(np.prod(cfg["grid"])),
              itemsize=torch.empty((), dtype=getattr(
                  torch, cfg["dtype"])).element_size(),
              setup_s=time.perf_counter() - t_start,
              block_size=int(cfg.get("dof", 1)))

    spans = Spans(route.devices, trace)
    sampler = Sampler(seed, route)
    outcomes = []            # (converged, breakdown) of every system

    def one(i):
        t0 = time.perf_counter()
        x, info, k = route.step(i, spans)
        route.sync()
        t1 = time.perf_counter()
        outcomes.append((bool(info.converged), bool(info.breakdown)))
        sampler.offer(k, x)
        return t1 - t0, info.iters, t1

    w0 = time.perf_counter()
    i = 0
    while True:
        dt, iters, t1 = one(i)
        run.system_s.append(dt)
        run.iters.append(int(iters))
        i += 1
        if t1 - w0 >= seconds:
            break
    run.window_s = t1 - w0
    run.spans = {k: list(v) for k, v in spans.times.items()}
    extra = {}
    if trace:
        traced = []

        def systems():
            j, t0 = i, time.perf_counter()
            while True:
                t1 = one(j)[2]
                traced.append(j)
                j += 1
                if t1 - t0 >= float(mix["trace_seconds"]):
                    break

        run.trace = profile_systems(systems, route.sync)
        run.trace["systems"] = len(traced)
        extra["breakdown"] = breakdown(run.trace)
    peak = _devices_peak(route.devices)
    ref_device = route.devices[0]
    del route, sampler.route
    if ref_device.type == "cuda":
        torch.cuda.empty_cache()
    samples = [sampler.items[k] for k in sorted(sampler.items)]
    values = problem.judge(cfg, inputs, samples, ref_device)
    values["unconverged"] = sum(1 for c, b in outcomes if not c or b)
    checks = {name: [values.get(name), float(lim["limit"])]
              for name, lim in cell.limits.items()}
    correct = all(v is not None and v <= lim for v, lim in checks.values())
    return run, {"attempted": len(outcomes),
                 "failed": values["unconverged"], "checks": checks,
                 "correct": correct, "memory_peak_bytes": peak, **extra}
