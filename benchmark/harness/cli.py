"""The benchmark's command line: one run of one cell on the cards of the
machine it starts on, and one JSON result as the last line of stdout.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

It exits 3 and prints no result without as many CUDA cards as the cell
asks for, and 4 if JAX or the JAX package was loaded by the time the
result is due.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, the device's busy and window seconds
and the trace's breakdown.  Every run ends by comparing what the timed path
produced with the plain reference; the numbers compared, each beside its
limit, are the last lines of stderr and the ``checks`` key, last in the
result line.  Inputs that every run of a configuration shares (the
problem's) are kept in ``benchmark/out/cache/`` inside the checkout, so
only a checkout's first run makes them.
"""

from __future__ import annotations

import argparse
import json
import sys

from .manifest import BENCH_DIR, Cell

__all__ = ["main", "result_line"]


def _args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, run, outcome, trace: bool, device: dict) -> dict:
    """The result object: the cell's end-to-end metrics (``trace``
    false) or per-layer metrics (true), read by their readers; a reader
    that finds nothing leaves its metric out."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": outcome["correct"], "attempted": outcome["attempted"],
           "failed": outcome["failed"], "metrics": metrics, "device": device}
    if trace and "breakdown" in outcome:
        out["breakdown"] = outcome["breakdown"]
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in outcome["checks"].items()}
    return out


def main(argv=None, t_start: float | None = None) -> int:
    import time

    t_start = time.perf_counter() if t_start is None else t_start
    args = _args(argv)
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {found}", file=sys.stderr)
        return 3
    from .runner import forbidden_modules, run_cell

    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    run, outcome = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            devices, t_start, BENCH_DIR / "out" / "cache")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": outcome["memory_peak_bytes"]}
    if args.trace:
        busy = run.trace["busy_s"]
        device["busy_s"] = sum(busy.values()) / cell.chips
        device["window_s"] = run.trace["window_s"]
    line = result_line(cell, run, outcome, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
