"""The comparison fails what it must: the timed path broken underneath a
run (the rest of the run driven as on the card, past its look for a card)
and the control, the reference computed in TF32 in the program's place,
at a size a test run holds."""

import pytest
import torch

from perfbench import calibrate, check, harness, manifest
from perfbench.tests._tiny import tiny_cell

CELLS = [w["name"] for w in manifest.load_benchmark()["workloads"]]


def _run(name):
    return harness.run_cell(tiny_cell(name), 11, 0.1, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_is_caught(name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    res = _run(name)
    assert res["correct"] is False
    assert res["checks"]["step"]["value"] > res["checks"]["step"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_half_batch_is_caught(name, monkeypatch):
    from pytorch_geometric_temporal_tpu_torch.train import trainer

    train = trainer.BatchTrainer._train

    def half(self, x, y):
        return train(self, x[: x.shape[0] // 2], y[: y.shape[0] // 2])

    monkeypatch.setattr(trainer.BatchTrainer, "_train", half)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_windows_altered_where_gathered_are_caught(name, monkeypatch):
    from pytorch_geometric_temporal_tpu_torch.signal import index_dataset

    gather = index_dataset.DeviceWindower.__call__

    def shifted(self, starts):
        x, y = gather(self, starts)
        return x, y + 1e-3

    monkeypatch.setattr(index_dataset.DeviceWindower, "__call__", shifted)
    res = _run(name)
    assert res["correct"] is False
    assert res["checks"]["windows"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    r = calibrate.readings_for(cell, 5, "cpu", controls=True)
    limits = cell.config["limits"]
    assert check.judge(r["program"], limits)[0] is True
    for fault in ("control", "half_batch", "unchanged"):
        assert check.judge(r[fault], limits)[0] is False, (fault, r[fault])
