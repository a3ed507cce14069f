"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``workloads/<traffic>.json``); each per-layer metric is a reader of its
own (``metrics/<name>.py``).  Adding a cell, a configuration or a metric
adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list
    here: Path              # the benchmark's folder: metric readers


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _data(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _data(root / configs[w["config"]]["file"])
    traffic = _data(here / "workloads" / f"{w['traffic']}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                here=here)


def load_metric(name: str, here: Path = HERE):
    """The reader module ``metrics/<name>.py``: ``LAYER``, ``UNIT``,
    ``MOVES``, ``SOURCE`` and ``read(run) -> float | None``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
