"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by its names."""

import json
import math
import re
import shutil
from pathlib import Path

import pytest

from perfbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
BENCH = manifest.load_benchmark()


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and BENCH["paths"] == ["perfbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells at this length fits in its 43,200 s
    runs = 2 + 14 * 24
    assert ((BENCH["run_seconds"] + 60) * runs + 24 * 2 * 90 + 1200
            <= 43200)


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + metrics(), ids=lambda e: e["name"])
def test_names_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique_and_keys_exact():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in metrics()]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    used = set()
    for w in BENCH["workloads"]:
        used.add(w["config"])
        cell = manifest.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert cell.config["name"] == w["config"]
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_matches_its_entry(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    module = manifest.load_metric(metric["name"])
    assert module.LAYER == metric["layer"]
    assert module.UNIT == metric["unit"]
    assert module.MOVES == metric["moves"]
    assert module.SOURCE == metric["source"]
    # the cells a metric lists live in BENCHMARK.json alone
    assert not hasattr(module, "WORKLOADS")
    cells = [w["name"] for w in BENCH["workloads"]]
    # every cell the metric lists reports the end-to-end metric it moves
    moved = e2e[metric["moves"]]
    for cell in metric.get("workloads", cells):
        assert cell in cells
        assert "workloads" not in moved or cell in moved["workloads"]


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_config_files_lie_under_paths_and_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) == {"windows", "loss", "grad", "step"}
        assert all(math.isfinite(v) for v in cfg["limits"].values())


THROWAWAY_METRIC = '''"""A throwaway per-layer metric: the largest host ms of a fetch."""
LAYER = "loader (signal/index_dataset.py)"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(run):
    return max(run.fetch_ms) if run.fetch_ms else None
'''


def test_a_cell_is_added_by_files_alone(tmp_path, capsys):
    """A throwaway traffic mix, a per-layer metric's reader and their
    entries, in a copy of the benchmark, are found by name with no code
    changed; a dry run of the new cell reports the new metric beside the
    others."""
    from perfbench import run
    from perfbench.tests._tiny import tiny_cell

    here = tmp_path / "perfbench"
    shutil.copytree(manifest.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    (here / "workloads" / "throwaway.json").write_text(
        json.dumps({"name": "throwaway", "scramble_ids": True}))
    (here / "metrics" / "fetch_ms_max.py").write_text(THROWAWAY_METRIC)
    bench["workloads"].append({"name": "pems-dcrnn64-throwaway",
                               "config": "dcrnn-li2018-pems",
                               "traffic": "throwaway", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "fetch_ms_max", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "loader (signal/index_dataset.py)",
                               "moves": "train_samples_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny_cell("pems-dcrnn64-throwaway", root=tmp_path, here=here)
    assert cell.traffic["scramble_ids"]
    assert cell.config["model"]["output_dim"] == 1
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"fetch_ms_max", "step_mfu", "spmm_roofline"} <= names
    assert run.report(cell, 2**31 + 9, 0.2, True, "cpu") == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["fetch_ms_max"]["value"] > 0
    assert "loader_ms_per_batch" in res["metrics"]


def _copy(tmp_path):
    here = tmp_path / "perfbench"
    shutil.copytree(manifest.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return here


def _add_config(tmp_path, here, family):
    """A configuration of ``family``, a copy of ``dcrnn-pgti-pems`` under
    another name, and a cell of it, with their entries."""
    bench = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "dcrnn-pgti-pems.json").read_text())
    cfg.update(name="twin")
    cfg["model"]["family"] = family
    (here / "configs" / "twin.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "twin", "source": cfg["source"],
                             "file": "perfbench/configs/twin.json",
                             "reduced": cfg["reduced"], "why": "a test"})
    bench["workloads"].append({"name": "twin-ordered", "config": "twin",
                               "traffic": "pems-ordered", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


def _files(root):
    return {p.relative_to(root) for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_family_is_added_by_files_alone(tmp_path, capsys):
    """A model family's two files, copies of DCRNN's under a new name, a
    configuration of it, a cell and their entries, in a copy of the
    benchmark: the harness builds the model, counts its work and runs its
    reference from the new files with no file of the copy changed."""
    from perfbench import run
    from perfbench.tests._tiny import tiny_cell

    here = _copy(tmp_path)
    added = {Path("families/dcrnn_twin.py"), Path("reference/dcrnn_twin.py"),
             Path("configs/twin.json")}
    for sub in ("families", "reference"):
        shutil.copy(here / sub / "dcrnn.py", here / sub / "dcrnn_twin.py")
    _add_config(tmp_path, here, "dcrnn_twin")
    cell = tiny_cell("twin-ordered", root=tmp_path, here=here)
    assert cell.family.__file__ == str(here / "families" / "dcrnn_twin.py")
    assert (cell.family.REFERENCE.__file__
            == str(here / "reference" / "dcrnn_twin.py"))
    assert run.report(cell, 2**31 + 17, 0.2, True, "cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["correct"] is True
    assert _files(here) == _files(manifest.HERE) | added
    for rel in _files(manifest.HERE):
        assert (here / rel).read_bytes() == (manifest.HERE / rel).read_bytes()


def test_an_unknown_family_exits_with_the_families_found(tmp_path):
    here = _copy(tmp_path)
    _add_config(tmp_path, here, "nonesuch")
    with pytest.raises(SystemExit, match=r"'nonesuch'.*\['dcrnn'\]"):
        manifest.load_cell("twin-ordered", root=tmp_path, here=here)
