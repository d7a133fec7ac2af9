#!/usr/bin/env python3
"""Where a benchmark cell's set-up time and idle device time go, by the
program's counters and spans.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/trace_cell.py --workload bratu3d-256-f32.lagged \\
        --seed 2147483811 [--seconds 20] [--trace-seconds 1]

It sets the cell up as ``benchmark/run.py`` does (the inputs kept in
``benchmark/out/cache/``), timing each phase of set-up, runs the warm-up,
then an untraced window of ``--seconds`` and ``--trace-seconds`` of
systems inside ``blasted_tpu_torch.utils.profiling.trace``, both with the
benchmark's synchronising spans on, as in a ``--trace 1`` run.  From the
Chrome trace that ``profiling.trace`` writes it charges each gap between
two device operations (kernels, copies, sets) to the innermost benchmark
span (``bench.update``, ``bench.factor``, ``bench.krylov``; ``between``
outside them) and, within it, to the innermost program span (the names
the program recorded: ``krylov.iter``, ``sync.flag``, ``precond.compute``,
``sync.timers``, ...; ``none`` where none was open)
that the host had open when the gap began.  It prints one JSON line: the
set-up phases in host seconds, the mean wall ms a system untraced and
traced (the cost of tracing on), the traced systems' ``SolveInfo.iters``
beside the program's ``krylov.iter`` spans, the host µs per kernel launch
over the process (``ops/_cuda.py``'s ``launch_ns`` over its
``launches``), the share of the traced systems' DIA ILU(0) applies whose
chains start with the zero-start sweep K12 (the counters
``precond.zero_start`` over ``precond.ilu_apply``) and of their block-DIA
ILU(0) applies whose chains start with the block head sweep K13
(``precond.block_zero_start`` over ``precond.block_apply``), the device's
busy and idle seconds, and the idle split.  It takes a cell of either
route (the host CSR and ``try_dia_from_csr``, or the host BSR and
``try_bdia_from_bsr``).
It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _innermost(spans):
    """A function of a time ``t``, called with ``t`` non-decreasing, that
    gives the name of the innermost of the nested ``(start, end, name)``
    spans open at ``t``, or ``None``."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, nxt = [], 0

    def at(t):
        nonlocal nxt
        while nxt < len(spans) and spans[nxt][0] <= t:
            while stack and stack[-1][1] <= spans[nxt][0]:
                stack.pop()
            stack.append(spans[nxt])
            nxt += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        return stack[-1][2] if stack else None
    return at


def idle_split(events, program_names) -> dict:
    """Busy and idle seconds of the trace's device operations, and the idle
    seconds by innermost benchmark span (``user_annotation`` events named
    ``bench.*``) and, within each, by innermost program span (``cpu_op``
    events named in ``program_names``)."""
    from benchmark.metrics._intervals import gaps, union_seconds

    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") in DEVICE_CATS]

    def spans(cat, keep):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]) for e in events
                if e.get("cat") == cat and keep(e["name"])]

    bench = _innermost(spans("user_annotation",
                             lambda n: n.startswith("bench.")))
    program = _innermost(spans("cpu_op", lambda n: n in program_names))
    by_bench = defaultdict(float)
    by_program = defaultdict(lambda: defaultdict(float))
    for g0, g1 in gaps(device):            # in order of their start
        secs = (g1 - g0) / 1e6
        outer = bench(g0) or "between"
        by_bench[outer] += secs
        by_program[outer][program(g0) or "none"] += secs
    return {"busy_s": union_seconds(device),
            "idle_s": sum(by_bench.values()),
            "device_ops": len(device),
            "idle_by_bench_span": dict(by_bench),
            "idle_by_program_span": {
                outer: dict(sorted(inner.items(), key=lambda kv: -kv[1]))
                for outer, inner in by_program.items()}}


def _timed(obj, names, into: dict, sync) -> None:
    """Wrap ``obj``'s methods ``names`` so that each call adds its host
    seconds, the card synchronised at the end, to ``into[name]``."""
    for name in names:
        def timed(*args, _fn=getattr(obj, name), _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                sync()
                into[_name] = into.get(_name, 0.0) + time.perf_counter() - t0
        setattr(obj, name, timed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scripts/trace_cell.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--trace-seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.manifest import BENCH_DIR, Cell
    from benchmark.harness.trace import Spans
    from blasted_tpu_torch.ops import _cuda
    from blasted_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("trace_cell: needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    setup = {"imports": time.perf_counter() - T_START}
    t0 = time.perf_counter()
    inputs = cell.problem().Inputs(cell.config, cell.mix, args.seed, device,
                                   BENCH_DIR / "out" / "cache")
    torch.cuda.synchronize(device)
    setup["inputs"] = time.perf_counter() - t0
    _timed(inputs, [name for name in ("host_csr", "host_bsr", "rhs", "bands")
                    if hasattr(inputs, name)], setup,
           lambda: torch.cuda.synchronize(device))
    t0 = time.perf_counter()
    route = cell.route()(inputs, cell.config, [device])
    route.sync()
    setup["route"] = time.perf_counter() - t0
    for name in ("dia_from_csr", "bdia_from_bsr"):
        if f"setup.{name}_s" in profiling.counters:
            setup[name] = profiling.counters[f"setup.{name}_s"]
    setup["precond_and_first_factor"] = profiling.counters["setup.precond_s"]
    t0 = time.perf_counter()
    for i in range(int(cell.mix["warmup_systems"])):
        route.step(i, Spans(route.devices, False))
        route.sync()
    setup["warmup"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - T_START
    spans = Spans(route.devices, True)

    def systems(first, seconds):
        walls, iters, j = [], [], first
        t0 = time.perf_counter()
        while True:
            s0 = time.perf_counter()
            _, info, _ = route.step(j, spans)
            route.sync()
            t1 = time.perf_counter()
            walls.append(t1 - s0)
            iters.append(int(info.iters))
            j += 1
            if t1 - t0 >= seconds:
                return walls, iters, j

    untraced, _, nxt = systems(0, args.seconds)
    profiling.reset()
    (BENCH_DIR / "out").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BENCH_DIR / "out") as tmp:
        with profiling.trace(tmp):
            traced, iters, _ = systems(nxt, args.trace_seconds)
        (path,) = Path(tmp).glob("trace_*.json")
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if "dur" in e]
    records = profiling.records()
    applies = profiling.counters.get("precond.ilu_apply", 0)
    block_applies = profiling.counters.get("precond.block_apply", 0)
    launches = sum(_cuda.launches.values())
    untraced_ms = sum(untraced) / len(untraced) * 1e3
    traced_ms = sum(traced) / len(traced) * 1e3
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0), "setup_s": setup_s,
           "setup_phases_s": setup,
           "untraced_systems": len(untraced), "untraced_ms": untraced_ms,
           "traced_systems": len(traced), "traced_ms": traced_ms,
           "tracing_on_cost": traced_ms / untraced_ms - 1.0,
           "solveinfo_iters": sum(iters),
           "krylov_iter_spans": sum(r.name == "krylov.iter"
                                    for r in records),
           "launch_host_us": (sum(_cuda.launch_ns.values()) / launches / 1e3
                              if launches else None),
           "zero_start_share": (profiling.counters.get("precond.zero_start",
                                                       0) / applies
                                if applies else None),
           "block_zero_start_share": (
               profiling.counters.get("precond.block_zero_start", 0)
               / block_applies if block_applies else None),
           **idle_split(events, {r.name for r in records})}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
