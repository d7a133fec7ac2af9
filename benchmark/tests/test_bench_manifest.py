"""BENCHMARK.json against the contract's rules for names, units and
files, and the harness finding a new configuration, mix, cell and metric
by name with no edit to a file that exists."""

import pytest

from benchmark.harness.manifest import ROOT, Cell, load_manifest

from .block_toy import CELL, CONFIG, METRIC, MIX, add_block_toy
from .helpers import check_cells_configs_and_files, check_names_units_and_lines

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
    check_names_units_and_lines(MAN)


def test_cells_configs_and_files():
    check_cells_configs_and_files(MAN)


def test_a_new_problem_route_config_mix_cell_and_metric_are_found_by_name(
        tmp_path):
    """The block toy's files, added to a copy of the benchmark's folder,
    are found by the names in its manifest entries (the copy's own tests
    run the cell, ``test_bench_additions.py``); a cell that names a file
    nobody wrote fails loudly."""
    man, _ = add_block_toy(tmp_path)
    bench = tmp_path / "benchmark"
    c = Cell(CELL, manifest=man, bench_dir=bench)
    assert (c.config["name"], c.mix["name"]) == (CONFIG, MIX)
    assert c.config["dof"] == 2 and set(c.limits) == {"x_error_max",
                                                      "unconverged"}
    assert [m["name"] for m in c.per_layer] == [METRIC]
    assert {m["name"] for m in c.end_to_end} == {"system_ms", "setup_s"}
    assert (bench / "problems" / f"{c.config['problem']}.py").is_file()
    assert c.route().__module__ == "bench_route_toy_bdia"
    assert callable(c.reader(METRIC))
    man["workloads"].append({"name": "nope.newton", "config": "nope",
                             "traffic": "newton", "chips": 1, "why": "x"})
    with pytest.raises(FileNotFoundError):
        Cell("nope.newton", manifest=man, bench_dir=bench)
