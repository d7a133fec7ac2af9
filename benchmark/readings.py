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
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _inputs(cell, seed: int, device, cache_dir):
    return cell.problem().Inputs(cell.config, cell.mix, seed, device,
                                 cache_dir)


def _system(cell, inputs, k: int, device):
    import torch

    from benchmark.reference import bratu3d as ref

    cfg = cell.config
    return ref.System(cfg["grid"], cfg["lambda"], inputs.u_matrix(k),
                      inputs.iterates[k], getattr(torch, cfg["dtype"]),
                      device)


def _sweeps(cell) -> tuple:
    return tuple(int(v) for v in
                 str(cell.config["options"]["blasted_async_sweeps"])
                 .split(","))


def control(cell, seed: int, device, dtype, cache_dir=None) -> dict:
    """The reference in ``dtype`` in the program's place: x and factor of
    every slot of seed's pool, judged as the program's are."""
    import torch

    from benchmark.reference import bratu3d as ref

    opts = cell.config["options"]
    inputs = _inputs(cell, seed, device, cache_dir)
    nb, na = _sweeps(cell)
    err, gap, iters = 0.0, 0.0, []
    for k in range(inputs.slots):
        system = _system(cell, inputs, k, device)
        x, it = ref.bicgstab(system, dtype, nb, na, float(opts["rtol"]),
                             int(opts["maxiter"]))
        iters.append(it)
        want = inputs.answer(k).to(device)
        err = max(err, float(torch.linalg.vector_norm(
            x.to(torch.float64).reshape(-1) - want)
            / torch.linalg.vector_norm(want)))
        gap = max(gap, ref.factor_gap(
            system, ref.factor_sweeps(system, nb, dtype), nb))
        del system, x, want
    return {"x_error_max": err, "factor_gap_max": gap, "iters": iters}


def stale(cell, device, cache_dir=None) -> dict:
    """gaps[k][j]: slot k's system judged against the reference's float32
    factor of slot j's matrix (j = k: a sound factor, to rounding)."""
    import torch

    from benchmark.reference import bratu3d as ref

    inputs = _inputs(cell, 0, device, cache_dir)
    nb, _ = _sweeps(cell)
    factors = []
    for j in range(inputs.slots):
        system = _system(cell, inputs, j, device)
        factors.append({d: t.float().cpu() for d, t in
                        ref.factor_sweeps(system, nb, torch.float32).items()})
        del system
    gaps = []
    for k in range(inputs.slots):
        system = _system(cell, inputs, k, device)
        gaps.append([ref.factor_gap(system, f, nb) for f in factors])
        del system
    return {"gaps": gaps}


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
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    cell = Cell(a.workload)
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
