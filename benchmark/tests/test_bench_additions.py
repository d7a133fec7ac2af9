"""A new problem, route, configuration, mix, cell and metric join the
benchmark by new files and new manifest entries alone.

In a copy of ``benchmark/`` and ``BENCHMARK.json`` with the 2-dof block
toy added (``block_toy.py``), the copy's own tests run: every test that
holds every configuration or cell (``test_every_cell_has_a_tiny_grid``,
``test_names_units_and_lines``, ``test_cells_configs_and_files``, the
toy's cases of ``test_cell_rehearses_correct``) and the toy's own test,
with every test module of the copy collected.  No file that was in the
copied folder changes, and ``readings.py`` turns the toy down with a
clear exit, since its problem defines no hooks."""

import os
import re
import subprocess
import sys

from benchmark.harness.manifest import ROOT

from .block_toy import CELL, add_block_toy, digests

#: The copy's tests that take in the toy, by ``-k``: the checks of every
#: configuration and cell, and whatever is parametrised over the toy.
SELECT = "tiny_grid or names_units or configs_and_files or toy"
#: What they come to: the three manifest-wide tests, the toy's two
#: rehearsals (both ``trace``) and the toy's own test.
PASSED = 6


def test_a_block_cell_joins_by_new_files_and_entries_alone(tmp_path):
    _, before = add_block_toy(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "benchmark/tests", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-m", "not card",
         "-k", SELECT], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    tail = res.stdout[-4000:] + res.stderr[-2000:]
    assert res.returncode == 0, tail
    assert re.search(rf"\b{PASSED} passed\b", res.stdout), tail
    assert not re.search(r"\b(failed|error|errors|skipped)\b", res.stdout), \
        tail

    # a reading the toy's problem has no hook for: a clear non-zero exit
    res = subprocess.run([sys.executable, "benchmark/readings.py",
                          "--workload", CELL, "--control", "1", "--stale"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 2 and res.stdout == ""
    assert "defines no control() hook" in res.stderr, res.stderr

    after = digests(tmp_path / "benchmark")
    assert {k: after.get(k) for k in before} == before
