"""Cells are found by name, and every name BENCHMARK.json uses has its
files: configuration, traffic, limits, a reader per per-layer metric and a
check per stage class."""

import json
import re

import pytest

from portbench import cells
from conftest import PARKED, parked_benchmark

BENCH = json.loads(cells.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = cells.load_cell(cell)
    assert c.name == cell and c.chips == 1
    assert c.config["block_samples"] % c.config["chunk_samples"] == 0
    assert str(c.config["rate"]) in c.traffic["carriers_hz"]
    assert {"setup_s", "stream_msps"} <= {m["name"] for m in c.end_to_end}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    for spec in c.config["stages"]:
        assert callable(cells.stage_check(spec["class"]).numbers)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load_cell("no-such-config.frames")


@pytest.mark.parametrize("cell", PARKED)
def test_a_cell_with_files_but_no_entry_is_refused(cell):
    with pytest.raises(KeyError):
        cells.load_cell(cell)


@pytest.mark.parametrize("cell", PARKED)
def test_parked_cell_loads_from_a_benchmark_file(cell, tmp_path):
    c = cells.load_cell(cell, parked_benchmark(tmp_path / "bench.json"))
    assert c.chips == 1 and c.config_name == cell.partition(".")[0]
    assert {"setup_s", "stream_msps"} <= {m["name"] for m in c.end_to_end}
    assert {"drain.wall_ms", "kA_viterbi_roofline"} <= {
        m["name"] for m in c.per_layer}
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    for spec in c.config["stages"]:
        assert callable(cells.stage_check(spec["class"]).numbers)


def test_benchmark_names_and_links():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    wl = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert json.loads((cells.HERE.parent / c["file"]).read_text())
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m.get("workloads", [])) <= wl
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", wl))
