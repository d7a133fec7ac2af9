"""The readers of the program's own spans and counters: each reads a finite
number from a traced CPU rehearsal, or ``None`` where the CPU cannot give
one (no device trace); none raises against a program that lacks the spans
and counters; on the card all five read.

The program's records and counters accumulate over the runs of one
process, so each test clears them first."""

import json
import math
import subprocess
import sys

import pytest

from benchmark.harness.manifest import ROOT, load_manifest
from benchmark.tests.helpers import rehearse, tiny_cell
from blasted_tpu_torch.ops import _cuda
from blasted_tpu_torch.utils import profiling

SPAN_METRICS = ("flag_wait_ms", "issue_ms", "ops_per_iter")
COUNTER_METRICS = ("dia_from_csr_s", "precond_setup_s")
NEW = SPAN_METRICS + COUNTER_METRICS
#: No device trace on the CPU.
CARD_ONLY = ("ops_per_iter",)
CELLS = ("bratu3d-256-f32.newton", "bratu3d-256-f32.lagged")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    _cuda.reset_launches()
    yield
    profiling.reset()
    _cuda.reset_launches()


def _read(cell, run):
    return {name: cell.reader(name)(run) for name in NEW}


@pytest.mark.parametrize("name", CELLS)
def test_each_new_metric_reads_from_a_traced_rehearsal(name):
    cell = tiny_cell(name)
    run, out = rehearse(cell, trace=True)
    assert out["correct"]
    got = _read(cell, run)
    for metric in NEW:
        if metric in CARD_ONLY:
            assert got[metric] is None, metric
        else:
            assert got[metric] is not None and math.isfinite(got[metric]) \
                and got[metric] >= 0, (metric, got[metric])
    # the traced systems' iterations are the spans': each solve's count
    # is one the window's systems of the same pool read
    recs = profiling.records()
    solves = [i for i, r in enumerate(recs) if r.name == "krylov.solve"]
    assert len(solves) == run.trace["systems"]
    per_solve = [sum(1 for r in recs if r.name == "krylov.iter"
                     and r.parent == s) for s in solves]
    assert set(per_solve) <= set(run.iters)
    assert sum(r.name == "sync.flag" for r in recs) == sum(per_solve)


def test_span_metrics_read_nothing_without_a_trace():
    cell = tiny_cell("bratu3d-256-f32.lagged")
    run, out = rehearse(cell, trace=False)
    assert run.trace is None and profiling.records() == []
    got = _read(cell, run)
    for metric in SPAN_METRICS:
        assert got[metric] is None, metric
    # set-up's counters are always on
    assert got["dia_from_csr_s"] > 0 and got["precond_setup_s"] > 0


def test_readers_give_none_against_a_program_without_them(monkeypatch):
    """A program older than its spans and counters (the benchmark laid
    over an earlier checkout): every new reader gives None, none raises."""
    cell = tiny_cell("bratu3d-256-f32.lagged")
    run, _ = rehearse(cell, trace=True)
    for attr in ("records", "counters"):
        monkeypatch.delattr(profiling, attr)
    for metric, value in _read(cell, run).items():
        assert value is None, metric


def test_the_manifest_lists_the_five_metrics_in_both_cells():
    per_layer = {m["name"]: m for m in load_manifest()["per_layer"]}
    for metric in NEW:
        m = per_layer[metric]
        assert m["workloads"] == list(CELLS)
        assert m["moves"] == ("setup_s" if metric in ("dia_from_csr_s",
                                                      "precond_setup_s")
                              else "system_ms")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_all_five_read_on_the_card(card, name):
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          name, "--seed", str(2 ** 31 + 23), "--seconds",
                          "3", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-2000:]
    metrics = json.loads(res.stdout.strip().splitlines()[-1])["metrics"]
    for metric in NEW:
        assert metric in metrics, metric
        assert math.isfinite(metrics[metric]["value"]) \
            and metrics[metric]["value"] > 0, metric
