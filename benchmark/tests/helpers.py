"""Tiny cells for the CPU rehearsals: the program's kernels run as their
plain twins on CPU tensors."""

import time

import torch

from benchmark.harness.manifest import Cell
from benchmark.harness.runner import run_cell

#: A tiny grid per cell.
TINY = {"bratu3d-256-f32.newton": [10, 10, 10],
        "bratu3d-256-f32.lagged": [10, 10, 10]}


def tiny_cell(name: str) -> Cell:
    cell = Cell(name)
    cell.config["grid"] = TINY[name]
    return cell


def rehearse(cell: Cell, seed: int = 2 ** 31 + 11, seconds: float = 0.3,
             trace: bool = False):
    """One run of ``cell`` on the CPU, skipping the look for a card:
    (Run, outcome)."""
    return run_cell(cell, seed, seconds, trace, [torch.device("cpu")],
                    time.perf_counter())
