"""Find a cell and everything that belongs to it by name.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` needs no code of its own:
its configuration is ``configs/<config>.json``, its traffic
``traffic/<mix>.json``, its limits ``limits/<config>.json``, each
per-layer metric a reader ``metrics/<metric>.py``, and the outputs of each
stage class its check ``checks/<StageClass>.py``. A later change adds a
cell, a mix or a metric as new files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = BENCHMARK) -> Cell:
    """The cell ``name`` of ``benchmark``, its files loaded."""
    bench = _load(benchmark)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark}; have "
                       f"{sorted(cells)}")
    w = cells[name]
    config = _load(HERE / "configs" / f"{w['config']}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"], config=config,
        traffic=_load(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_load(HERE / "limits" / f"{w['config']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def _module(path: Path):
    """Load a file by its path: metric names hold dots, which an import
    name cannot."""
    spec = importlib.util.spec_from_file_location(
        "_portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return _module(HERE / "metrics" / f"{name}.py").read


def stage_check(stage_class: str):
    """The check module of a stage class (``checks/<class>.py``)."""
    return _module(HERE / "checks" / f"{stage_class}.py")
