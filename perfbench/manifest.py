"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``workloads/<traffic>.json``); the configuration's ``model.family`` names
the model's family (``families/<family>.py``) and its plain reference
(``reference/<family>.py``); each per-layer metric is a reader of its own
(``metrics/<name>.py``).  Adding a cell, a configuration, a model family
or a metric adds files and entries; nothing here changes.
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
    family: object          # the configuration's families/<family>.py


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
                here=here, family=load_family(config["model"]["family"], here))


def _module(prefix: str, path: Path):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_family(name: str, here: Path = HERE):
    """The model family ``families/<name>.py`` (see ``families/__init__``);
    exits naming the families there when it has none of that name."""
    path = here / "families" / f"{name}.py"
    if not path.is_file():
        found = sorted(p.stem for p in (here / "families").glob("*.py")
                       if not p.stem.startswith("_"))
        raise SystemExit(f"unknown model family {name!r}; "
                         f"{here / 'families'} has {found}")
    return _module("perfbench_family_", path)


def load_reference(family_file):
    """The plain reference ``reference/<family>.py`` of the family module at
    ``family_file`` (``families/<family>.py``)."""
    path = Path(family_file).resolve()
    return _module("perfbench_reference_",
                   path.parent.parent / "reference" / path.name)


def load_metric(name: str, here: Path = HERE):
    """The reader module ``metrics/<name>.py``: ``LAYER``, ``UNIT``,
    ``MOVES``, ``SOURCE`` and ``read(run) -> float | None``."""
    return _module("perfbench_metric_", here / "metrics" / f"{name}.py")
