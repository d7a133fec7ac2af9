"""The readings that a cell's correctness limits are set from.

    python3 benchmark/readings.py --workload <name> --seconds <s>
        [--seeds N ...] [--control N ...] [--stale]

In one process on the cards of the machine, for each ``--seeds`` seed a
run of the cell (short window, the timed path as ``run.py`` drives it) and
its compared numbers; for each ``--control`` seed the control: the plain
reference put in the program's place and computed in bfloat16, the
precision below the configuration's float32, at the cell's own size, on
every slot of the pool, judged by the same numbers; with ``--stale`` the
factor gap of a stale factor: each slot's system judged against the
reference's float32 factor of every other slot (a re-factor that keeps an
earlier step's factor, and a value update that keeps the earlier values,
read so).  Prints one JSON line per reading.
``run.py`` never runs any of this.

The control and the stale factor are the hooks ``control(cfg, inputs,
device, dtype)`` and ``stale(cfg, inputs, device)`` of the configuration's
problem module (``benchmark/problems/<problem>.py``).  Where a reading is
asked for whose hook the problem does not define, this exits 2 and names
the hook on stderr; without a CUDA card it exits 3.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _hook(cell, name: str):
    """(problem module, its ``name`` hook) of the cell's configuration;
    LookupError where the problem defines no such hook."""
    problem = cell.problem()
    fn = getattr(problem, name, None)
    if not callable(fn):
        raise LookupError(f"problem {cell.config['problem']!r} "
                          f"({problem.__file__}) defines no {name}() hook")
    return problem, fn


def control(cell, seed: int, device, dtype, cache_dir=None) -> dict:
    """The problem's ``control(cfg, inputs, device, dtype)`` on seed's
    pool: the reference in ``dtype`` in the program's place."""
    problem, hook = _hook(cell, "control")
    inputs = problem.Inputs(cell.config, cell.mix, seed, device, cache_dir)
    return hook(cell.config, inputs, device, dtype)


def stale(cell, device, cache_dir=None) -> dict:
    """The problem's ``stale(cfg, inputs, device)`` on seed 0's pool: the
    gaps of a factor left from another slot."""
    problem, hook = _hook(cell, "stale")
    inputs = problem.Inputs(cell.config, cell.mix, 0, device, cache_dir)
    return hook(cell.config, inputs, device)


def main() -> int:
    import argparse
    import json

    import torch

    from benchmark.harness.manifest import BENCH_DIR, Cell
    from benchmark.harness.runner import run_cell

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--stale", action="store_true")
    a = p.parse_args()
    cell = Cell(a.workload)
    for name, wanted in (("control", a.control), ("stale", a.stale)):
        if wanted:
            try:
                _hook(cell, name)
            except LookupError as e:
                print(f"readings: {e}", file=sys.stderr)
                return 2
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    cache = BENCH_DIR / "out" / "cache"
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    for seed in a.seeds:
        t0 = time.perf_counter()
        run, out = run_cell(cell, seed, a.seconds, False, devices, t0, cache)
        print(json.dumps({"reading": "program", "workload": cell.name,
                          "seed": seed, "checks": out["checks"],
                          "correct": out["correct"],
                          "iters": sorted(set(run.iters)),
                          "system_s": run.system_s,
                          "setup_s": run.setup_s}), flush=True)
        del run, out
        torch.cuda.empty_cache()
    for seed in a.control:
        t0 = time.perf_counter()
        rec = control(cell, seed, devices[0], torch.bfloat16, cache)
        print(json.dumps({"reading": "control_bf16", "workload": cell.name,
                          "seed": seed, **rec,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    if a.stale:
        t0 = time.perf_counter()
        rec = stale(cell, devices[0], cache)
        print(json.dumps({"reading": "stale_factor", "workload": cell.name,
                          **rec, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
