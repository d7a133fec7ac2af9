"""PETSc SNES ex19's driven cavity through the port's block-DIA route, held
against the benchmark's plain reference (``benchmark/reference/ex19.py``)
on the CPU: the problem's analytic block Jacobian against the reference's
coloured forward-mode one and a dense autograd Jacobian, the port's SpMV,
factor and apply against the reference's plain forms, the route's solve
against the cell's limit, the float32 control against the limits, and the
reference's Newton."""

import contextlib
import functools
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark.problems import ex19 as problem
from benchmark.reference import ex19 as ref
from blasted_tpu_torch.api import (compute_preconditioner,
                                   setup_local_preconditioner)
from blasted_tpu_torch.ops.bdia import bdia_spmv
from blasted_tpu_torch.ops.bstencil import bdia_factor_takes_compressed_route
from blasted_tpu_torch.precond.dia_ilu0 import dia_pairs
from blasted_tpu_torch.sparse.bdia import try_bdia_from_bsr
from blasted_tpu_torch.sparse.bsr import BSRMatrix

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CELL = "ex19-cavity-1024-f64.newton"
CFG = json.loads((BENCH / "configs" / "ex19-cavity-1024-f64.json")
                 .read_text())
MIX = json.loads((BENCH / "traffic" / "cavity_newton.json").read_text())
LIMITS = {k: v["limit"] for k, v in json.loads(
    (BENCH / "limits" / f"{CELL}.json").read_text()).items()}
TINY = json.loads((BENCH / "tests" / "tiny" / "ex19-cavity-1024-f64.json")
                  .read_text())["grid"]
PRM = ref.params(CFG)
NB, NA = (int(v) for v in CFG["options"]["blasted_async_sweeps"].split(","))


def _cfg(grid):
    return {**CFG, "grid": list(grid)}


@functools.cache
def _inputs(grid):
    return problem.Inputs(_cfg(grid), MIX, 1, "cpu")


def _random_state(grid, seed=7):
    """A seeded state whose velocities change sign across the grid."""
    mx, my = grid
    g = torch.Generator().manual_seed(seed)
    return 10.0 * torch.randn((my, mx, 4), generator=g, dtype=torch.float64)


def _port_matrix(grid, x):
    rowptr, colind, vals = problem.host_bsr(grid, PRM, x, "float64")
    return try_bdia_from_bsr(BSRMatrix.from_arrays(rowptr, colind, vals, 4),
                             device="cpu")


def _blocks(jac):
    return {d: jac[k] for k, d in enumerate(ref.DIRECTIONS)}


def test_analytic_jacobian_is_the_coloured_and_the_dense_one():
    grid = (7, 6)
    x = _random_state(grid)
    u, v = x[..., 0], x[..., 1]
    assert bool((u > 0).any() and (u < 0).any() and (v > 0).any()
                and (v < 0).any())
    analytic = _blocks(problem.jacobian_blocks(grid, PRM, x))
    coloured = ref.jacobian(grid, PRM, x)
    for d in ref.DIRECTIONS:
        assert torch.allclose(analytic[d], coloured[d], rtol=0, atol=1e-12)
    n = x.numel()
    dense = torch.autograd.functional.jacobian(
        lambda y: ref.residual(grid, PRM, y.reshape(x.shape)).reshape(-1),
        x.reshape(-1))
    eye = torch.eye(n, dtype=torch.float64)
    by_blocks = torch.stack([ref.matvec(analytic, eye[c]) for c in range(n)],
                            dim=1)
    assert torch.allclose(by_blocks, dense, rtol=0, atol=1e-12)
    # the problem's own F is the reference's
    assert torch.allclose(problem.residual(grid, PRM, x),
                          ref.residual(grid, PRM, x), rtol=0, atol=1e-12)


def test_port_spmv_is_the_reference_product():
    grid = (7, 6)
    x = _random_state(grid)
    B = _port_matrix(grid, x)
    assert B.offsets == (-7, -1, 0, 1, 7) and B.diag_mask_full
    y = _random_state(grid, seed=8).reshape(-1)
    got = bdia_spmv(B, y.reshape(-1, 4)).reshape(-1)
    want = ref.matvec(ref.jacobian(grid, PRM, x), y)
    assert torch.allclose(got, want, rtol=0, atol=1e-12 * float(
        want.abs().max()))


def _preconditioner(grid, x):
    B = _port_matrix(grid, x)
    ctx = setup_local_preconditioner(B, CFG["options"], device="cpu")
    compute_preconditioner(ctx)
    return ctx.prec


@pytest.mark.parametrize("slot", [0, 2, 4])
def test_port_factor_and_apply_are_the_reference_plain_forms(slot):
    """At the tiny grid's Newton iterates: the config's options take the
    compressed route (K6's twin), whose 8 sweeps equal 16 plain ones on
    the centre and 15 on the lowers; one apply is the reference's."""
    grid = TINY
    x = _inputs(tuple(grid)).iterates[slot]
    prec = _preconditioner(grid, x)
    mat = prec.mat
    assert bdia_factor_takes_compressed_route(
        mat.offsets, dia_pairs(mat.offsets), NB, prec.fact_init)
    jac = ref.jacobian(grid, PRM, x)
    want = ref.port_factor(jac, NB)
    got = problem.by_direction(
        {o: prec.state.ilu[d] for d, o in enumerate(mat.offsets)}, grid)
    for d in ref.DIRECTIONS:
        scale = float(want[d].abs().max())
        assert float((got[d] - want[d]).abs().max()) <= 1e-12 * scale, d
    r = _random_state(grid, seed=9).reshape(-1)
    z = prec.apply_flat(r)
    zref = ref.ilu_apply(want, torch.linalg.inv(want["c"]), r, NA)
    assert torch.allclose(z, zref, rtol=0,
                          atol=1e-12 * float(zref.abs().max()))


def _route_run(grid):
    """Every slot's system through the benchmark's route, judged."""
    from benchmark.harness.manifest import Cell

    cell = Cell(CELL)
    cfg = _cfg(grid)
    inputs = _inputs(tuple(grid))
    route = cell.route()(inputs, cfg, [torch.device("cpu")])
    samples = []
    for i in range(inputs.slots):
        x, info, k = route.step(i, lambda name: contextlib.nullcontext())
        assert info.converged and not info.breakdown
        samples.append(SimpleNamespace(slot=k, x=x, factor=route.factor()))
    return problem.judge(cfg, inputs, samples, torch.device("cpu"))


def test_route_solves_within_the_limits():
    got = _route_run((16, 12))
    assert got["relres_max"] <= LIMITS["relres_max"]
    assert got["factor_gap_max"] <= LIMITS["factor_gap_max"]


def test_float32_control_fails_a_limit():
    grid = (16, 12)
    rec = problem.control(_cfg(grid), _inputs(grid), "cpu", torch.bfloat16)
    assert rec["dtype"] == "float32"
    assert any(rec[k] > LIMITS[k] for k in ("relres_max", "factor_gap_max"))
    assert rec["factor_gap_max"] > 10 * LIMITS["factor_gap_max"]


def test_reference_newton_converges_quadratically():
    """At 16×16 the reference's Newton from ``FormInitialGuess`` reaches
    ||F|| ≤ 1e-8 ||F_0|| within 8 steps, its last two steps quadratic:
    each squares the relative norm or better, up to a modest constant."""
    pool = problem.newton_iterates(_cfg((16, 16)), {**MIX, "step_rtol":
                                                    1e-12}, "cpu")
    rel = [v / pool["norms"][0] for v in pool["norms"]]
    assert len(pool["iterates"]) <= 8
    assert rel[-1] <= MIX["snes_rtol"] < rel[-2]
    for prev, nxt in zip(rel[-3:-1], rel[-2:]):
        assert nxt <= 10 * prev ** 2, rel


def test_block_path_spans_and_counters():
    """``try_bdia_from_bsr`` counts its calls and seconds; inside a
    profiler a block ILU(0) factor records its sweeps and its inverse, and
    every apply records a span and counts, outside one only counts."""
    from torch.profiler import ProfilerActivity, profile

    from blasted_tpu_torch import solvers
    from blasted_tpu_torch.utils import profiling

    grid = TINY
    x = _inputs(tuple(grid)).iterates[1]
    profiling.reset()
    try:
        prec = _preconditioner(grid, x)
        assert profiling.counters["setup.bdia_from_bsr"] == 1
        assert profiling.counters["setup.bdia_from_bsr_s"] > 0
        assert profiling.records() == []
        b = problem.rhs(grid, PRM, x, "cpu", torch.float64)
        with profile(activities=[ProfilerActivity.CPU]):
            prec.compute()
            _, info = solvers.bicgstab(
                lambda v: bdia_spmv(prec.mat, v.reshape(-1, 4)).reshape(-1),
                prec.apply_flat, b, torch.zeros_like(b), tol=1e-5,
                maxiter=200)
        recs = profiling.records()
        names = [r.name for r in recs]
        assert names.count("precond.block_factor") == 1
        assert names.count("precond.block_inverse") == 1
        assert names.count("precond.block_apply") == 2 * info.iters
        assert profiling.counters["precond.block_apply"] == 2 * info.iters
        prec.apply_flat(b)          # no profiler: counted, not recorded
        assert len(profiling.records()) == len(recs)
        assert profiling.counters["precond.block_apply"] \
            == 2 * info.iters + 1
    finally:
        profiling.reset()
