#!/usr/bin/env python3
"""Where the device time goes in the port's main paths.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/profile_solves.py

For the scalar system (the 160³ Poisson system, float32) and the block
system (the bs=4 system on the 128³ block grid, float32), each on the banded
path (ILU(0) 8,4 on DIA, with its factors in float32 and in bfloat16, and
4,4 on block-DIA) and on the padded path (ILU(0) 8,4 on padded CSR or BSR),
with BiCGSTAB as ``chip_smoke.py`` drives them, and for
the 160³ matrix with ``chip_smoke.py``'s seeded right-hand side under GMRES
(restart 30) with ILU(0) 4,4 and under CG with AMG (``[krylov-main]`` and
``[amg-main]``), and for ``[dist-main]`` (the seeded 160³ system over four
shards of the card, and over one, ILU(0) 4,4 and BiCGSTAB), it sets each
solve up through ``blasted_tpu_torch.api.solve``, then profiles three
steady-state windows with ``torch.profiler``: one factor, one
preconditioner apply and one whole Krylov solve.  For each window it prints
one JSON line: the host wall time (between two
``torch.cuda.synchronize()``), the device busy time (the union of the
kernel, copy and memset intervals of the trace), the idle share
(1 − busy / wall) and the device time by kernel name.  The banded windows
and the padded windows also name the port's kernels they must run
(``named``: calls and device ms of K8 in the scalar factor, of K7's two
modes in the block apply and solve; on the padded path K11 in the factor,
K10's two modes in the apply, and K9 and K10 in the solve) and fail
without them.  It imports nothing of JAX.

On a machine with four cards,

    python3 scripts/profile_solves.py --cards 4

profiles only ``chip_smoke.py``'s ``[mc-dist-main]`` system: the same three
windows over the four cards of ``make_mesh(4)`` (one shard per card) and
over four shards of cuda:0, each window between synchronisations of every
card of its mesh.  Each of these lines also gives, per card, the wall,
busy time, idle share and device events, and the host's kernel launches
and copies (the CUDA API calls in the trace) in all and,
for the solve, per iteration.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from blasted_tpu_torch.api import compute_preconditioner, solve  # noqa: E402
from blasted_tpu_torch.apps import poisson3d_system  # noqa: E402
from blasted_tpu_torch.parallel import make_mesh, shard_vector  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 14
# the port's kernels by words of their demangled names in the trace
K8 = {"K8 plain_factor_sweep": ("plain_factor_sweep_kernel",)}
K7 = {"K7 lower": ("bdia_sweep_kernel", "false"),
      "K7 upper": ("bdia_sweep_kernel", "true")}
K9 = {"K9 padded_spmv": ("padded_spmv_kernel",)}
K10 = {"K10 lower": ("padded_sweep_kernel", "false"),
       "K10 upper": ("padded_sweep_kernel", "true")}
K11 = {"K11 padded_factor_sweep": ("padded_factor_sweep_kernel",)}
PADDED_NAMED = {"factor_named": K11, "apply_named": K10,
                "solve_named": {**K9, **K10}}


def _trace_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"] if "dur" in e]
    finally:
        os.unlink(path)


def _busy_ms(events) -> float:
    """The union of the events' intervals, in ms."""
    busy_us, end = 0.0, -1.0
    for e in sorted(events, key=lambda e: e["ts"]):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy_us / 1e3


def _by_card(events, host, wall_ms: float, iters) -> dict:
    """Per card (the trace's device index): wall, busy, idle share and
    device events; and the host's launch and copy calls."""
    cards = defaultdict(list)
    for e in events:
        cards[e.get("args", {}).get("device", e.get("pid"))].append(e)
    out = {"cards": {str(d): {"wall_ms": wall_ms, "busy_ms": _busy_ms(ev),
                              "idle_share": 1.0 - _busy_ms(ev) / wall_ms,
                              "device_events": len(ev)}
                     for d, ev in sorted(cards.items(), key=str)},
           "host_launch_calls": sum("Launch" in e["name"] for e in host),
           "host_copy_calls": sum("Memcpy" in e["name"] for e in host)}
    if iters:
        out["iters"] = iters
        for key in ("host_launch_calls", "host_copy_calls"):
            out[key + "_per_iter"] = out[key] / iters
        out["device_events_per_iter"] = len(events) / iters
    return out


def window(label: str, fn, sync=torch.cuda.synchronize,
           per_card: bool = False, named=None) -> dict:
    """Profile one call of ``fn`` (warm) and summarise its device time;
    ``sync`` waits for the cards the window runs on (default: the
    current one).  With ``per_card``, the time by card and the host's
    API calls too (per iteration where ``fn`` returns a SolveInfo).
    ``named`` maps a label to words of a kernel's name: the window reports
    each one's calls and device ms and raises if one never ran."""
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = _trace_events(prof)
    events = [e for e in trace if e.get("cat") in DEVICE_CATS]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        rec = by_name[e["name"][:80]]
        rec[0] += 1
        rec[1] += float(e["dur"]) / 1e3
    busy_ms = _busy_ms(events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    rec = {"window": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "kernels": [[name, calls, ms] for name, (calls, ms) in top]}
    if named:
        rec["named"] = {}
        for key, words in named.items():
            hits = [v for n, v in by_name.items()
                    if all(w in n for w in words)]
            rec["named"][key] = [sum(c for c, _ in hits),
                                 sum(t for _, t in hits)]
    if per_card:
        iters = getattr(result[1], "iters", None) \
            if isinstance(result, tuple) else None
        # the host's CUDA API calls: the trace's "cuda_*" categories
        rec.update(_by_card(events, [e for e in trace if str(
            e.get("cat", "")).startswith("cuda_")], wall_ms, iters))
    print("[profile] " + json.dumps(rec), flush=True)
    missing = [k for k, (calls, _) in rec.get("named", {}).items() if not calls]
    if missing:
        raise RuntimeError(f"{label}: no {missing} in the trace")
    return rec


def profile_path(label: str, A, b, opts, factor_named=None,
                 apply_named=None, solve_named=None) -> None:
    x, info, ctx = solve(A, b, opts)
    prec = ctx.prec
    amat = chip_smoke.operator(ctx)
    solver, kw = chip_smoke.krylov_solver(opts)
    bt = torch.from_numpy(b).to(prec.device)
    print(f"[{label}] n={A.nrows} iters={info.iters} "
          f"converged={info.converged}", flush=True)
    window(f"{label} factor", lambda: compute_preconditioner(ctx),
           named=factor_named)
    window(f"{label} apply", lambda: prec.apply_flat(bt), named=apply_named)
    window(f"{label} solve", lambda: solver(
        amat, prec.apply_flat, bt, torch.zeros_like(bt), tol=opts["rtol"],
        maxiter=opts["maxiter"], **kw), named=solve_named or apply_named)


def profile_dist(label: str, A, b, opts, mesh, per_card: bool = False):
    """The distributed solve's windows: the shard set-up (factor), one
    apply and one solve on ``mesh``, each between synchronisations of
    every card of it."""
    x, info, ctx = solve(A, b, opts, mesh=mesh)
    ds = ctx.prec
    r = shard_vector(mesh, np.pad(b, (0, ds.nl * mesh.size - b.shape[0])))
    print(f"[{label}] n={A.nrows} shards={mesh.size} iters={info.iters} "
          f"converged={info.converged} devices="
          f"{[str(d) for d in mesh.devices]}", flush=True)
    sync = mesh.synchronize
    window(f"{label} factor", ds._compute, sync, per_card)
    window(f"{label} apply", lambda: ds.prec_apply(r), sync, per_card)
    window(f"{label} solve", lambda: ds.solve(
        b, method=opts["ksp_type"], tol=opts["rtol"],
        maxiter=opts["maxiter"]), sync, per_card)


def profile_cards(ncards: int) -> None:
    """``--cards N``: the [mc-dist-main] windows over N cards and over N
    shards of cuda:0."""
    mesh = make_mesh(ncards)
    A, b = chip_smoke.seeded_poisson(chip_smoke.MAIN_NPTS, np.float32)
    opts = dict(chip_smoke.ILU44_OPTS, rtol=chip_smoke.KRYLOV_RTOL)
    profile_dist(f"mc-dist-main {ncards} cards", A, b, opts, mesh,
                 per_card=True)
    profile_dist(f"mc-dist-main {ncards} shards of cuda:0", A, b, opts,
                 make_mesh(devices=[mesh.first] * ncards), per_card=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(chip_smoke.MC_CARDS,),
                    help="profile only the [mc-dist-main] windows over this "
                         "many cards")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solves: no CUDA device", file=sys.stderr)
        return 2
    if args.cards is not None and torch.cuda.device_count() < args.cards:
        print(f"profile_solves: --cards {args.cards} needs {args.cards} "
              f"CUDA devices, torch sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for i, line in enumerate(smi.splitlines()[:args.cards or 1]):
        print(f"[device] {torch.cuda.get_device_name(i)}; nvidia-smi: "
              f"{line}", flush=True)
    if args.cards is not None:
        profile_cards(args.cards)
        return 0
    A, b, _ = poisson3d_system((chip_smoke.MAIN_NPTS,) * 3, dist="uniform")
    A, b = A.astype(np.float32), b.astype(np.float32)
    profile_path("scalar", A, b, chip_smoke.MAIN_OPTS, factor_named=K8)
    profile_path("mixed scalar", A, b, dict(chip_smoke.MAIN_OPTS,
                                            blasted_apply_dtype="bfloat16"))
    profile_path("padded scalar", A, b, chip_smoke.PADDED_OPTS,
                 **PADDED_NAMED)
    del A, b
    A, b = chip_smoke.seeded_poisson(chip_smoke.MAIN_NPTS, np.float32)
    gmres, _ = chip_smoke.KRYLOV_CASES[0][1:]
    profile_path("gmres+ilu0", A, b, dict(gmres, rtol=chip_smoke.KRYLOV_RTOL,
                                          maxiter=2000))
    profile_path("cg+amg", A, b, dict(chip_smoke.AMG_OPTS, ksp_type="cg",
                                      rtol=chip_smoke.KRYLOV_RTOL,
                                      maxiter=2000))
    del A, b
    torch.cuda.empty_cache()
    B, bb = chip_smoke.block_system(chip_smoke.BLOCK_G, chip_smoke.BLOCK_BS,
                                    np.float32, seed=7)
    profile_path("block", B, bb, chip_smoke.ILU44_OPTS, apply_named=K7)
    torch.cuda.empty_cache()
    profile_path("padded block", B, bb, chip_smoke.PADDED_OPTS,
                 **PADDED_NAMED)
    del B, bb
    torch.cuda.empty_cache()
    A, b = chip_smoke.seeded_poisson(chip_smoke.MAIN_NPTS, np.float32)
    opts = dict(chip_smoke.ILU44_OPTS, rtol=chip_smoke.KRYLOV_RTOL)
    for nshards in (chip_smoke.DIST_SHARDS, 1):
        profile_dist(f"dist-main {nshards} shard(s)", A, b, opts,
                     chip_smoke.card_mesh(nshards))
    return 0


if __name__ == "__main__":
    sys.exit(main())
