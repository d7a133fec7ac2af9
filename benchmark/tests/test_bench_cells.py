"""Each cell rehearsed at its configuration's tiny sizes on the CPU,
through the kernels' plain twins: the run, its result line and its
metrics; and the cells of ex14's problem held to its Newton sequence."""

import pytest
import torch

from benchmark.harness.manifest import load_manifest

from .helpers import (check_rehearses_correct, check_tiny_files,
                      problem_cells, rehearse, tiny_cell)

MAN = load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
#: The cells that run ex14's problem, held to its semantics below.
BRATU = problem_cells("bratu3d", MAN)


def test_every_cell_has_a_tiny_grid():
    check_tiny_files(MAN)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearses_correct(name, trace):
    check_rehearses_correct(tiny_cell(name), trace)


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


@pytest.mark.parametrize("name", BRATU)
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
