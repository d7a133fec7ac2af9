"""No run loads JAX or the JAX package, and the reference loads nothing of
the program; a run without a card prints no result."""

import json
import subprocess
import sys

from benchmark.harness.manifest import ROOT
from benchmark.harness.runner import FORBIDDEN, forbidden_modules

RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests.helpers import rehearse, tiny_cell
for name in ("bratu3d-256-f32.newton", "bratu3d-256-f32.lagged"):
    rehearse(tiny_cell(name), trace=True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.bratu3d as ref
import torch
u = ref.initial_guess((6, 6, 6), 6.0, "cpu")
s = ref.System((6, 6, 6), 6.0, u, u, torch.float32, "cpu")
ref.bicgstab(s, torch.float32, 8, 4, 1e-5, 100)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = _tops(RUN_TINY)
    assert "blasted_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops(REF_ONLY)
    assert not tops & {"blasted_tpu_torch", *FORBIDDEN}, tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "blasted_tpu_torch_x", sys)
    monkeypatch.delitem(sys.modules, "blasted_tpu", raising=False)
    assert "blasted_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "blasted_tpu.api", sys)
    assert "blasted_tpu" in forbidden_modules()


def test_no_card_no_result(tmp_path):
    """Without a CUDA card run.py exits non-zero and prints nothing to
    stdout."""
    import torch

    if torch.cuda.is_available():
        return
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "bratu3d-256-f32.lagged", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/,
    run.py exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "bratu3d-256-f32.lagged", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
