"""The comparison that decides ``correct`` fails a broken timed path:
each run here skips the look for a card, drives the rest of a run at a
tiny grid, and breaks the program underneath."""

import pytest
import torch

import blasted_tpu_torch.solvers as solvers
from blasted_tpu_torch.precond.dia_ilu0 import DiaILU0Preconditioner

from .helpers import rehearse, tiny_cell

CELLS = ["bratu3d-256-f32.newton", "bratu3d-256-f32.lagged"]


def _wrap_solver(monkeypatch, change):
    """Every Krylov solve returns ``change(x, b)`` in place of its x."""
    real = solvers.bicgstab

    def broken(amat, prec, b, x0, **kw):
        x, info = real(amat, prec, b, x0, **kw)
        return change(x, x0), info

    monkeypatch.setattr(solvers, "bicgstab", broken)


def _half(x):
    """The last half of the rows left out (zero)."""
    y = x.clone()
    y[x.shape[0] // 2:] = 0
    return y


FAULTS = {
    # a step that returns its state unchanged: x stays x0
    "state_unchanged": lambda x, x0: x0,
    # half of the answer left out
    "half_left_out": lambda x, x0: _half(x),
    # an answer altered where it is produced
    "answer_altered": lambda x, x0: x * 1.01,
}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_answer_is_not_correct(monkeypatch, name, fault):
    _wrap_solver(monkeypatch, FAULTS[fault])
    _, out = rehearse(tiny_cell(name))
    assert not out["correct"], out["checks"]
    assert out["checks"]["x_error_max"][0] > out["checks"]["x_error_max"][1]


def test_update_that_keeps_the_old_values(monkeypatch):
    """A value update that leaves the matrix as it was: the re-factor and
    the solve then serve the previous step's Jacobian."""
    monkeypatch.setattr(DiaILU0Preconditioner, "update_values",
                        lambda self, vals: None)
    _, out = rehearse(tiny_cell("bratu3d-256-f32.newton"))
    assert not out["correct"], out["checks"]


def test_refactor_that_keeps_the_old_factor(monkeypatch):
    """A re-factor that returns the state unchanged: the applies read the
    previous step's factor."""
    from blasted_tpu_torch import api

    calls = {"n": 0}
    real = api.compute_preconditioner

    def stale(ctx):
        calls["n"] += 1
        if calls["n"] <= 1:             # set-up's factor only
            return real(ctx)
        return None

    monkeypatch.setattr(api, "compute_preconditioner", stale)
    _, out = rehearse(tiny_cell("bratu3d-256-f32.newton"))
    assert not out["correct"], out["checks"]
    assert out["checks"]["factor_gap_max"][0] \
        > out["checks"]["factor_gap_max"][1]


@pytest.mark.parametrize("name", CELLS)
def test_program_bf16_factor_is_not_correct(name):
    """The program's own lower-precision path (the factor stored in
    bfloat16) is the control of the one-card cells: the factor gap fails
    it, while its x still converges."""
    cell = tiny_cell(name)
    cell.config["options"]["blasted_apply_dtype"] = "bfloat16"
    _, out = rehearse(cell)
    assert not out["correct"]
    gap, lim = out["checks"]["factor_gap_max"]
    assert gap > 3 * lim
    assert out["checks"]["x_error_max"][0] <= out["checks"]["x_error_max"][1]
