"""Card tests: run with ``python -m pytest benchmark/tests -m card`` on a
machine with a CUDA card (they skip elsewhere)."""

import json
import subprocess
import sys

import pytest

from benchmark.harness.manifest import ROOT, load_manifest

ONE_CARD = [w["name"] for w in load_manifest()["workloads"]
            if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("name", ONE_CARD)
def test_cell_runs_correct_on_the_card(card, name):
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          name, "--seed", str(2 ** 31 + 17), "--seconds",
                          "3", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for key, m in line["metrics"].items():
        if key.endswith("_roofline"):
            assert 0 < m["value"] <= 105
