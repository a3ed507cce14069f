"""The reader ``spmm_walked_tile_share``: the fused kernel's walked share of
its f32 tile work, from the ``bcsr_tiles`` counter in the program's step
records; silent where the program keeps no such counter or issued no tile,
and a replay's record counting what its graph issued."""

import json
import types

import pytest
import torch

from perfbench import manifest, run
from perfbench.tests._tiny import tiny_cell


def _reader():
    return manifest.load_metric("spmm_walked_tile_share")


def _sub(*kinds):
    return types.SimpleNamespace(sub_kinds=[(k, 64) for k in kinds])


def test_reads_the_last_train_records(monkeypatch):
    from pytorch_geometric_temporal_tpu_torch import _counters

    rec = _counters.StepRecord
    records = ([rec("train_step", {"bcsr_tiles": (0, 264)})]
               + [rec("train_step", {"bcsr_tiles": (264, 0)}),
                  rec("eval_step", {"bcsr_tiles": (0, 144)})] * 2)
    monkeypatch.setattr(_counters, "step_records", lambda: records)
    assert _reader().read(_sub("train", "eval", "train")) == 1.0
    assert _reader().read(_sub("train", "train", "train")) == pytest.approx(
        2 / 3)
    assert _reader().read(_sub(*["train"] * 4)) is None   # too few records


def test_silent_without_the_counter_or_any_tile(monkeypatch):
    """A program without ``bcsr_tiles`` (one older than this reader) reads
    nothing and raises nothing; so does one that issued no tile."""
    from pytorch_geometric_temporal_tpu_torch import _counters

    rec = _counters.StepRecord
    monkeypatch.setattr(_counters, "step_records", lambda: [
        rec("train_step", {"bcsr_launches": (94, 0, 0)})])
    assert _reader().read(_sub("train")) is None
    monkeypatch.setattr(_counters, "step_records", lambda: [
        rec("train_step", {"bcsr_tiles": (0, 0)})])
    assert _reader().read(_sub("train")) is None
    monkeypatch.delattr(_counters, "step_records")
    assert _reader().read(_sub("train")) is None


def test_a_replayed_record_counts_its_graphs_tiles():
    """A replay runs no Python: the captured step adds what its capture
    counted inside the step's span, so the record holds the graph's tiles."""
    from pytorch_geometric_temporal_tpu_torch import _counters
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    bcsr.reset_launch_counts()
    before = _counters.read()
    bcsr.add_launch_counts((94, 0, 0))       # as a capture counts them
    bcsr.add_tile_counts((88 * 3 * 94, 0))
    graph = _counters.counted_since(before)
    _counters.add(graph, -1)
    _counters.clear_step_records()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with _counters.step("train_step"):
                _counters.add(graph)         # as each replay does
    records = _counters.step_records()
    assert [r.counted["bcsr_tiles"] for r in records] == [(24816, 0)] * 2
    assert _reader().read(_sub("train", "train")) == 1.0
    _counters.clear_step_records()
    bcsr.reset_launch_counts()


def test_dry_run_leaves_it_out(capsys):
    """On the CPU the diffusion takes the dense path: no tile is issued,
    so the line carries no share."""
    assert run.report(tiny_cell("pems-pgti"), 2**31 + 13, 0.2, True,
                      "cpu") == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "spmm_walked_tile_share" not in res["metrics"]
    assert res["metrics"]["spmm_launches_per_step"]["value"] == 0.0
