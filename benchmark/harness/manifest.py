"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name:

- ``benchmark/configs/<config>.json``: the deployment's sizes and options,
  the ``problem`` whose module (``benchmark/problems/<problem>.py``) makes
  the inputs and judges the answers with its plain reference (under
  ``benchmark/reference/``), and the program's ``route``
  (``benchmark/routes/<route>.py``) that runs each system;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters;
- ``benchmark/limits/<workload>.json``: the limits of the cell's
  correctness numbers;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.

A later cell, mix, configuration or metric adds files and entries; no
file here names any of them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def _module(path: Path, label: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with its configuration, mix, limits and
    the metrics it reports."""

    def __init__(self, name: str, manifest: dict | None = None,
                 bench_dir: Path = BENCH_DIR):
        man = load_manifest(bench_dir.parent) if manifest is None \
            else manifest
        cells = {w["name"]: w for w in man["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have: {', '.join(sorted(cells))})")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.bench_dir = bench_dir
        self.config = _json(bench_dir / "configs"
                            / f"{self.entry['config']}.json")
        self.mix = _json(bench_dir / "traffic"
                         / f"{self.entry['traffic']}.json")
        self.limits = _json(bench_dir / "limits" / f"{name}.json")
        self.end_to_end = [m for m in man["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in man["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]

    def problem(self):
        """The configuration's problem: its inputs and judge."""
        p = self.config["problem"]
        return _module(self.bench_dir / "problems" / f"{p}.py",
                       f"bench_problem_{p}")

    def route(self):
        """The class of the configuration's route through the program."""
        r = self.config["route"]
        return _module(self.bench_dir / "routes" / f"{r}.py",
                       f"bench_route_{r}").Route

    def reader(self, metric: str):
        """The reader of a per-layer metric: ``read(run) -> float | None``."""
        safe = metric.replace(".", "_").replace("-", "_")
        return _module(self.bench_dir / "metrics" / f"{metric}.py",
                       f"bench_metric_{safe}").read
