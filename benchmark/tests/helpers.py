"""Tiny cells for the CPU rehearsals (the program's kernels run as their
plain twins on CPU tensors), and the checks that every configuration and
cell of a manifest is held to: the repo's own cells and a cell added in a
copy of the benchmark pass through the same code.

A configuration's rehearsal sizes are ``tests/tiny/<config>.json`` in the
benchmark's folder: the keys merged into the configuration for a tiny run.
"""

import json
import re
import time
from pathlib import Path

import torch

from benchmark.harness.cli import result_line
from benchmark.harness.manifest import BENCH_DIR, ROOT, Cell, load_manifest
from benchmark.harness.runner import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def tiny_path(config: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "tests" / "tiny" / f"{config}.json"


def tiny_cell(name: str, manifest: dict | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` with its configuration's rehearsal sizes."""
    cell = Cell(name, manifest, bench_dir)
    cell.config.update(json.loads(
        tiny_path(cell.entry["config"], bench_dir).read_text()))
    return cell


def problem_cells(problem: str, manifest: dict | None = None,
                  root: Path = ROOT) -> list:
    """The manifest's cells whose configuration runs ``problem``."""
    man = load_manifest(root) if manifest is None else manifest
    runs = {c["name"]: json.loads((root / c["file"]).read_text())["problem"]
            for c in man["configs"]}
    return [w["name"] for w in man["workloads"]
            if runs[w["config"]] == problem]


def rehearse(cell: Cell, seed: int = 2 ** 31 + 11, seconds: float = 0.3,
             trace: bool = False):
    """One run of ``cell`` on the CPU, skipping the look for a card:
    (Run, outcome)."""
    return run_cell(cell, seed, seconds, trace, [torch.device("cpu")],
                    time.perf_counter())


def check_tiny_files(man: dict, bench_dir: Path = BENCH_DIR) -> None:
    """Every configuration has its rehearsal sizes, overriding keys it
    has, and every rehearsal file names a configuration."""
    have = {p.stem for p in (bench_dir / "tests" / "tiny").glob("*.json")}
    assert have == {c["name"] for c in man["configs"]}, sorted(have)
    for c in man["configs"]:
        tiny = json.loads(tiny_path(c["name"], bench_dir).read_text())
        config = json.loads((bench_dir.parent / c["file"]).read_text())
        assert tiny and set(tiny) <= set(config), (c["name"], sorted(tiny))


def check_rehearses_correct(cell: Cell, trace: bool):
    """A tiny run of ``cell`` is correct and its result line is whole:
    (Run, result line)."""
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
    return run, line


def check_names_units_and_lines(man: dict) -> None:
    """The contract's rules for names, units, sources and one-line texts."""
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key], (e["name"], key)
    metrics = [n for is_m, n in names if is_m]
    assert len(metrics) == len(set(metrics))
    for group in ("end_to_end", "per_layer"):
        for m in man[group]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
            assert not m["name"].startswith("_")     # helpers are _files
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def check_cells_configs_and_files(man: dict, root: Path = ROOT) -> None:
    """Each cell's entry, configuration, mix, route, limits and readers
    are found by name under ``root``; the configurations' files agree
    with their entries."""
    bench_dir = root / "benchmark"
    configs = {c["name"]: c for c in man["configs"]}
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
        cell = Cell(w["name"], man, bench_dir)
        assert cell.config["name"] == w["config"]
        assert cell.mix["name"] == w["traffic"]
        assert (bench_dir / "routes" / f"{cell.config['route']}.py") \
            .is_file()
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]))
    assert len(pairs) == len(man["workloads"])
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= max(
        1, len(man["workloads"]) // 4)
    for c in man["configs"]:
        data = json.loads((root / c["file"]).read_text())
        assert c["file"].startswith("benchmark/configs/")
        assert data["reduced"] == c["reduced"] and data["source"] \
            == c["source"]
        assert "assumed" in data
    for w in man["workloads"]:
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in man["end_to_end"] if m["name"] != "setup_s")
