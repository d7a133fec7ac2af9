"""The lower-precision control at a size a test run holds: the plain
reference put in the program's place and computed in bfloat16 fails the
cell's numbers, where the same reference in the configuration's float32
passes them."""

import pytest
import torch

from benchmark.readings import control

from .helpers import tiny_cell

CELLS = ["bratu3d-256-f32.newton", "bratu3d-256-f32.lagged"]


def _fails(cell, rec) -> bool:
    return any(rec[k] > cell.limits[k]["limit"] for k in rec
               if k in cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_bf16_control_fails_and_f32_passes(name):
    cell = tiny_cell(name)
    cell.config["grid"] = [24, 24, 24]
    for seed in (1, 2, 2 ** 31 + 3):
        assert _fails(cell, control(cell, seed, torch.device("cpu"),
                                    torch.bfloat16))
    assert not _fails(cell, control(cell, 1, torch.device("cpu"),
                                    torch.float32))
