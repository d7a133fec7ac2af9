"""A 2-dof block-banded toy cell, written as new files and manifest
entries into a copy of ``benchmark/`` and ``BENCHMARK.json``: a problem
with its plain reference, a route through the program's block-DIA path
(``try_bdia_from_bsr``, block ILU(0) from the ``blasted_async_*``
options, BiCGSTAB on ``bdia_spmv``), a ``"dof": 2`` configuration, a
mix, a cell, its limits, its tiny file, a per-layer metric reading
``run.block_size``, and a test of its own.  ``add_block_toy`` builds the
copy; the tests that use it run the copy's own tests on it."""

import hashlib
import json
import shutil

from benchmark.harness.manifest import BENCH_DIR, load_manifest

CONFIG, MIX = "toy-block2-f32", "toy_rhs"
CELL = f"{CONFIG}.{MIX}"
METRIC = "toy_iter_ns_per_unknown"
TINY_GRID = [6, 5]

PROBLEM = '''"""A 2-dof toy on a 2D grid: u diffuses with coefficient 1, v with
``kappa``, and the two couple at each point through ``sigma``; the 5-point
star of 2x2 blocks in natural order (x fastest), neighbours outside the
grid left out.  Each slot is a right-hand side drawn from the seed."""

import numpy as np
import torch

from benchmark.reference import toy_block2 as reference


def host_bsr(cfg):
    """(rowptr, colind, vals (nnzb, 2, 2)) in the configuration's dtype."""
    mx, my = cfg["grid"]
    kap, sig = float(cfg["kappa"]), float(cfg["sigma"])
    diag = np.array([[4.0 + sig, -0.5 * sig], [-sig, 4.0 * kap + 2 * sig]])
    off = -np.diag([1.0, kap])
    rowptr, colind, vals = [0], [], []
    for j in range(my):
        for i in range(mx):
            p = i + mx * j
            for q, inside in ((p - mx, j > 0), (p - 1, i > 0), (p, True),
                              (p + 1, i < mx - 1), (p + mx, j < my - 1)):
                if inside:
                    colind.append(q)
                    vals.append(diag if q == p else off)
            rowptr.append(len(colind))
    return (np.array(rowptr, np.int32), np.array(colind, np.int32),
            np.array(vals).astype(np.dtype(cfg["dtype"])))


class Inputs:
    def __init__(self, cfg, mix, seed, device, cache_dir=None):
        self.cfg = cfg
        n = int(np.prod(cfg["grid"])) * int(cfg["dof"])
        g = torch.Generator().manual_seed(seed % 2 ** 63)
        self.b = [torch.randn(n, generator=g, dtype=torch.float64)
                  for _ in range(int(mix["systems"]))]
        self.slots = len(self.b)
        self.start = int(torch.randint(self.slots, (), generator=g))

    def slot(self, i):
        return (self.start + i) % self.slots

    def host_bsr(self):
        return host_bsr(self.cfg)

    def rhs(self, device, dtype):
        return [b.to(device, dtype) for b in self.b]


def judge(cfg, inputs, samples, device):
    a = reference.dense(cfg["grid"], cfg["kappa"], cfg["sigma"])
    dtype = getattr(torch, cfg["dtype"])
    err = None
    for s in samples:
        want = torch.linalg.solve(a, inputs.b[s.slot].to(dtype).double())
        got = s.x.detach().cpu().double()
        e = float(torch.linalg.vector_norm(got - want)
                  / torch.linalg.vector_norm(want))
        err = e if err is None else max(err, e)
    return {"x_error_max": err}
'''

REFERENCE = '''"""The 2-dof toy's plain reference: its dense matrix, point by point,
unknowns interleaved (u, v) at each point."""

import torch


def dense(grid, kappa, sigma):
    mx, my = grid
    a = torch.zeros((2 * mx * my, 2 * mx * my), dtype=torch.float64)
    for j in range(my):
        for i in range(mx):
            u = 2 * (i + mx * j)
            v = u + 1
            a[u, u], a[u, v] = 4 + sigma, -sigma / 2
            a[v, u], a[v, v] = -sigma, 4 * kappa + 2 * sigma
            for ii, jj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
                if 0 <= ii < mx and 0 <= jj < my:
                    q = 2 * (ii + mx * jj)
                    a[u, q], a[v, q + 1] = -1.0, -kappa
    return a
'''

ROUTE = '''"""The program's one-device block-banded route: host BSR ->
``try_bdia_from_bsr`` -> block ILU(0) set-up and factor -> BiCGSTAB on
``bdia_spmv`` from x0 = 0."""

import torch

from blasted_tpu_torch import solvers
from blasted_tpu_torch.api import (compute_preconditioner,
                                   setup_local_preconditioner)
from blasted_tpu_torch.ops.bdia import bdia_spmv
from blasted_tpu_torch.sparse.bdia import try_bdia_from_bsr
from blasted_tpu_torch.sparse.bsr import BSRMatrix


class Route:
    def __init__(self, inputs, cfg, devices):
        self.device = torch.device(devices[0])
        self.devices = (self.device,)
        self.inputs = inputs
        opts = cfg["options"]
        self.tol, self.maxiter = float(opts["rtol"]), int(opts["maxiter"])
        rowptr, colind, vals = inputs.host_bsr()
        self.bs = vals.shape[-1]
        self.mat = try_bdia_from_bsr(
            BSRMatrix.from_arrays(rowptr, colind, vals, self.bs),
            device=self.device)
        if self.mat is None:
            raise ValueError("the configuration's matrix is not banded")
        self.ctx = setup_local_preconditioner(self.mat, opts,
                                              device=self.device)
        compute_preconditioner(self.ctx)
        self.rhs = inputs.rhs(self.device, getattr(torch, cfg["dtype"]))
        self.zero = torch.zeros_like(self.rhs[0])

    def _amat(self, x):
        return bdia_spmv(self.mat, x.reshape(-1, self.bs)).reshape(-1)

    def step(self, i, spans):
        k = self.inputs.slot(i)
        with spans("krylov"):
            x, info = solvers.bicgstab(self._amat, self.ctx.prec.apply_flat,
                                       self.rhs[k], self.zero, tol=self.tol,
                                       maxiter=self.maxiter)
        return x, info, k

    def factor(self):
        return None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
'''

READER = '''"""toy_iter_ns_per_unknown: Krylov span time an iteration over the
unknowns of one card (grid points times the block size), in ns."""


def read(run):
    t = run.spans.get("krylov")
    if not t or not sum(run.iters):
        return None
    unknowns = run.rows_per_card * run.block_size
    return sum(t) / sum(run.iters) / unknowns * 1e9
'''

CONFIG_FILE = {
    "name": CONFIG, "problem": "toy_block2", "route": "toy_bdia",
    "grid": [32, 32], "dof": 2, "kappa": 0.5, "sigma": 1.0,
    "dtype": "float32",
    "options": {"blasted_pc_type": "ilu0", "blasted_async_sweeps": "4,2",
                "blasted_async_fact_init_type": "init_original",
                "blasted_async_apply_init_type": "init_zero",
                "ksp_type": "bicgstab", "rtol": 1e-06, "maxiter": 500},
    "source": "a toy: two coupled diffusions, 5-point star of 2x2 blocks",
    "assumed": {"grid": "a toy's"}, "reduced": []}

TOY_TEST = f'''"""The toy's own checks: its route runs the program's block
path, and its run carries the configuration's block size."""

import torch

from .helpers import rehearse, tiny_cell

CELL = "{CELL}"


def test_toy_block2_runs_the_block_route():
    cell = tiny_cell(CELL)
    inputs = cell.problem().Inputs(cell.config, cell.mix, 5, "cpu")
    route = cell.route()(inputs, cell.config, [torch.device("cpu")])
    assert (type(route.mat).__name__, route.mat.bs,
            type(route.ctx.prec).__name__) == (
        "BlockDiaMatrix", 2, "BlockDiaILU0Preconditioner")
    run, _ = rehearse(cell)
    assert run.block_size == 2
    assert run.rows_per_card == {TINY_GRID[0] * TINY_GRID[1]}
'''


def digests(folder) -> dict:
    """sha256 of every file under ``folder``, by its relative path."""
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*")) if p.is_file()}


def _add(path, text: str) -> None:
    assert not path.exists(), f"{path} is not new"
    path.write_text(text)


def _json(obj) -> str:
    return json.dumps(obj, indent=1) + "\n"


def add_block_toy(root):
    """Copy ``benchmark/`` and ``BENCHMARK.json`` under ``root`` and add
    the toy as new files and appended manifest entries: (manifest, the
    copied folder's digests before the additions)."""
    bench = root / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    before = digests(bench)
    man = load_manifest()
    _add(bench / "problems/toy_block2.py", PROBLEM)
    _add(bench / "reference/toy_block2.py", REFERENCE)
    _add(bench / "routes/toy_bdia.py", ROUTE)
    _add(bench / f"metrics/{METRIC}.py", READER)
    _add(bench / f"configs/{CONFIG}.json", _json(CONFIG_FILE))
    _add(bench / f"traffic/{MIX}.json", _json(
        {"name": MIX, "why": "a few right-hand sides in turn", "systems": 3,
         "warmup_systems": 1, "trace_seconds": 0.05}))
    _add(bench / f"limits/{CELL}.json", _json(
        {"x_error_max": {"limit": 1e-3}, "unconverged": {"limit": 0}}))
    _add(bench / f"tests/tiny/{CONFIG}.json", _json({"grid": TINY_GRID}))
    _add(bench / "tests/test_toy_block2.py", TOY_TEST)
    # the manifest takes new entries, each appended to its list
    man["configs"].append({"name": CONFIG, "source": CONFIG_FILE["source"],
                           "file": f"benchmark/configs/{CONFIG}.json",
                           "reduced": [], "why": "a 2-dof block toy"})
    man["workloads"].append({"name": CELL, "config": CONFIG, "traffic": MIX,
                             "chips": 1, "why": "block-DIA route, 2x2 "
                             "blocks, one client, closed loop"})
    man["per_layer"].append({"name": METRIC, "unit": "ns", "better": "lower",
                             "source": "host_clock", "layer": "Krylov",
                             "moves": "system_ms", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(_json(man))
    return man, before
