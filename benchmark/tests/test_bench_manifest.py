"""BENCHMARK.json against the contract's rules for names, units and
files, and the harness finding a new configuration, mix, cell and metric
by name with no edit to a file that exists."""

import json
import re
import shutil

import pytest

from benchmark.harness.manifest import BENCH_DIR, ROOT, Cell, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = load_manifest()


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    # the full 24 cells fit the check's time
    assert 2 + 14 * 24 * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key], (e["name"], key)
    metrics = [n for is_m, n in names if is_m]
    assert len(metrics) == len(set(metrics))
    for group in ("end_to_end", "per_layer"):
        for m in MAN[group]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
            assert not m["name"].startswith("_")     # helpers are _files
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in MAN["configs"]}
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
        cell = Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["name"] == w["traffic"]
        assert (BENCH_DIR / "routes" / f"{cell.config['route']}.py") \
            .is_file()
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]))
    assert len(pairs) == len(MAN["workloads"])
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)
    for c in MAN["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/configs/")
        assert data["reduced"] == c["reduced"] and data["source"] \
            == c["source"]
        assert "assumed" in data
    for w in MAN["workloads"]:
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in MAN["end_to_end"] if m["name"] != "setup_s")


TOY_PROBLEM = """
import torch


class Inputs:
    def __init__(self, cfg, mix, seed, device, cache_dir=None):
        g = torch.Generator().manual_seed(seed % 2 ** 63)
        n = int(cfg["n"])
        self.d = 1.0 + torch.rand(n, generator=g, dtype=torch.float64)
        self.b = [torch.randn(n, generator=g, dtype=torch.float64)
                  for _ in range(int(mix["systems"]))]
        self.slots = len(self.b)

    def slot(self, i):
        return i % self.slots


def judge(cfg, inputs, samples, device):
    worst = max(float(torch.linalg.vector_norm(inputs.d * s.x
                                               - inputs.b[s.slot])
                      / torch.linalg.vector_norm(inputs.b[s.slot]))
                for s in samples)
    return {"relres_max": worst}
"""

TOY_ROUTE = """
import torch
from types import SimpleNamespace


class Route:
    def __init__(self, inputs, cfg, devices):
        self.inputs, self.devices = inputs, tuple(devices)

    def step(self, i, spans):
        k = self.inputs.slot(i)
        with spans("krylov"):
            x = self.inputs.b[k] / self.inputs.d
        return x, SimpleNamespace(converged=True, breakdown=False,
                                  iters=1), k

    def factor(self):
        return None

    def sync(self):
        pass
"""


def test_a_new_problem_route_config_mix_cell_and_metric_are_found_by_name(
        tmp_path):
    """Add one of each as new files in a copy of the benchmark's folder:
    the harness finds them and runs the new cell with no file edited."""
    import time

    import torch

    from benchmark.harness.runner import run_cell

    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    man = json.loads(json.dumps(MAN))
    (bench / "problems/toy.py").write_text(TOY_PROBLEM)
    (bench / "routes/toy.py").write_text(TOY_ROUTE)
    cfg = {"name": "toy-64", "problem": "toy", "route": "toy", "n": 64,
           "dtype": "float64", "grid": [64], "reduced": [], "source": "x"}
    (bench / "configs/toy-64.json").write_text(json.dumps(cfg))
    mix = {"name": "pairs", "systems": 2, "warmup_systems": 1,
           "trace_seconds": 0.01}
    (bench / "traffic/pairs.json").write_text(json.dumps(mix))
    cell = "toy-64.pairs"
    (bench / f"limits/{cell}.json").write_text(
        json.dumps({"relres_max": {"limit": 1e-12}}))
    (bench / "metrics/systems_done.py").write_text(
        "def read(run):\n    return float(len(run.system_s))\n")
    man["configs"].append({"name": "toy-64", "source": "x",
                           "file": "benchmark/configs/toy-64.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": cell, "config": "toy-64",
                             "traffic": "pairs", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "systems_done", "unit": "systems",
                             "better": "higher", "source": "host_clock",
                             "layer": "Krylov", "moves": "system_ms",
                             "workloads": [cell]})
    c = Cell(cell, manifest=man, bench_dir=bench)
    assert [m["name"] for m in c.per_layer] == ["systems_done"]
    assert {m["name"] for m in c.end_to_end} == {"system_ms", "setup_s"}
    run, out = run_cell(c, 7, 0.05, False, [torch.device("cpu")],
                        time.perf_counter())
    assert out["correct"] and out["checks"]["relres_max"][0] < 1e-14
    assert c.reader("systems_done")(run) == float(len(run.system_s)) > 1
    # and a cell that names a file nobody wrote fails loudly
    man["workloads"].append({"name": "nope.newton", "config": "nope",
                             "traffic": "newton", "chips": 1, "why": "x"})
    with pytest.raises(FileNotFoundError):
        Cell("nope.newton", manifest=man, bench_dir=bench)
