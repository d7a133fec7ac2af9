"""Each cell rehearsed at a tiny grid on the CPU, through the kernels'
plain twins: the run, its result line and its metrics."""

import json

import pytest
import torch

from benchmark.harness.cli import result_line
from benchmark.harness.manifest import load_manifest

from .helpers import TINY, rehearse, tiny_cell

CELLS = [w["name"] for w in load_manifest()["workloads"]]


def test_every_cell_has_a_tiny_grid():
    assert sorted(CELLS) == sorted(TINY)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearses_correct(name, trace):
    cell = tiny_cell(name)
    run, out = rehearse(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert len(run.system_s) == len(run.iters) >= 1
    assert run.setup_s > 0 and run.window_s > 0
    line = result_line(cell, run, out, trace, {"platform": "cpu"})
    json.dumps(line)
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if trace:
        # the CPU has no device trace: those readers find nothing
        assert run.trace is not None and "breakdown" in line
        for m in cell.per_layer:
            if m["source"] != "device_trace":
                assert m["name"] in line["metrics"], m["name"]
            else:
                assert m["name"] not in line["metrics"]
    else:
        assert names == set(line["metrics"])
    for name_, c in line["checks"].items():
        assert c["value"] <= c["limit"], name_


def test_newton_refactors_every_system_and_lagged_does_not():
    run, _ = rehearse(tiny_cell("bratu3d-256-f32.newton"), trace=True)
    assert len(run.spans["update"]) == len(run.spans["factor"]) \
        == len(run.spans["krylov"])
    run, _ = rehearse(tiny_cell("bratu3d-256-f32.lagged"), trace=True)
    assert set(run.spans) == {"krylov"}


def test_same_seed_same_inputs():
    cell = tiny_cell("bratu3d-256-f32.newton")
    problem = cell.problem()
    a, b = (problem.Inputs(cell.config, cell.mix, 5, "cpu") for _ in "ab")
    assert a.start == b.start
    assert all(torch.equal(u, v) for u, v in zip(a.iterates, b.iterates))
    # every seed runs the same steps, from a step of its own
    starts = {problem.Inputs(cell.config, cell.mix, s, "cpu").start
              for s in (1, 2, 3, 2 ** 31 + 5, -3)}
    assert len(starts) > 1 and starts <= set(range(a.slots))
    assert [a.slot(i) for i in range(a.slots + 1)] == \
        [(a.start + i) % a.slots for i in range(a.slots + 1)]


@pytest.mark.parametrize("name", CELLS)
def test_pool_is_the_newton_sequence(name):
    """The pool's iterates are ex14's Newton (or lagged Newton) steps: F
    falls at every step, to under snes_rtol of F(u0) at the last iterate
    only, and each step δ_k solves slot k's system as the program gets
    it."""
    from benchmark.reference import bratu3d as ref

    cell = tiny_cell(name)
    cfg, mix = cell.config, cell.mix
    problem = cell.problem()
    inputs = problem.Inputs(cfg, mix, 1, "cpu")
    grid, lam = cfg["grid"], cfg["lambda"]
    last = inputs.iterates[-1] + inputs.steps[-1]
    norms = [float(torch.linalg.vector_norm(ref.residual(grid, lam, u)))
             for u in inputs.iterates + [last]]
    assert inputs.slots == len(inputs.iterates) == len(inputs.steps) >= 2
    assert torch.equal(inputs.iterates[0], problem.guess(grid, lam, "cpu"))
    assert all(b < a for a, b in zip(norms, norms[1:]))
    assert norms[-2] > mix["snes_rtol"] * norms[0] >= norms[-1]
    for k in range(inputs.slots):
        system = ref.System(grid, lam, inputs.u_matrix(k),
                            inputs.iterates[k], torch.float32, "cpu")
        assert ref.relres(system, inputs.answer(k)) < 1e-11
    lagged = mix["jacobian"] == "lagged"
    assert inputs.per_system is not lagged
    bands = inputs.bands(problem.offsets(grid), "cpu", torch.float32)
    assert (bands is None) == lagged
    assert len(inputs.rhs("cpu", torch.float32)) == inputs.slots


def test_iterates_are_kept_in_the_cache(tmp_path, monkeypatch):
    cell = tiny_cell("bratu3d-256-f32.lagged")
    problem = cell.problem()
    first = problem.Inputs(cell.config, cell.mix, 1, "cpu", tmp_path)
    assert len(list(tmp_path.iterdir())) == 1

    def no_solve(*a, **k):
        raise AssertionError("the cached iterates were computed again")

    monkeypatch.setattr(problem, "newton_steps", no_solve)
    again = problem.Inputs(cell.config, cell.mix, 1, "cpu", tmp_path)
    assert all(torch.equal(u, v)
               for u, v in zip(first.iterates + first.steps,
                               again.iterates + again.steps))
