"""Idle time put down to the host (``idle.attribute``) on a hand-made
timeline with program spans nested in the benchmark's and launch records;
the launch counter's reader (``spmm_launches_per_step``) in a dry run and
without step records."""

import json
import types

import pytest
from torch.autograd import DeviceType

from perfbench import idle, manifest, run, trace
from perfbench.tests._tiny import tiny_cell

MAIN = 1


def ev(name, a, b, device=False, id=0, thread=MAIN, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=a, end=b), id=id,
        thread=thread, is_user_annotation=annotation)


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def timeline():
    """Device intervals (10–16 clipped from 5), 17–25, 31–35, 37–50,
    60–70, 85–90 in a sub-window of 10–100; gaps 16–17 (launched at 16.5,
    inside ``loader.gather``), 25–31 (launched at 30.5, inside
    ``step.copy_in``), 35–37 (the same graph launch: queued), 50–60 (no
    launch record), 70–85 (launched at 84, no program span open) and the
    tail 90–100."""
    return Prof([
        ev(trace.SUBWINDOW, 0, 100),
        ev("perfbench.fetch", 10, 20), ev("perfbench.train_step", 20, 80),
        ev("perfbench.epoch_end", 80, 100),
        ev("pgtt.loader.batch", 11, 19), ev("pgtt.loader.gather", 15, 18),
        ev("pgtt.step.train_step", 21, 60), ev("pgtt.step.copy_in", 22, 30),
        ev("pgtt.step.replay", 30, 40), ev("pgtt.step.clone_out", 40, 45),
        ev("pgtt.elsewhere", 0, 100, thread=2),     # another thread's
        ev("aten::mm", 3, 4, id=6),                 # an op, not a launch
        ev("cudaLaunchKernel", 4, 5, id=1),
        ev("cudaMemcpyAsync", 16.5, 16.8, id=2),
        ev("cudaGraphLaunch", 30.5, 31, id=3),
        ev("cuLaunchKernel", 84, 84.5, id=6),
        ev("gemm", 5, 16, True, id=1),
        ev("Memcpy HtoD", 17, 25, True, id=2),
        ev("gemm", 31, 35, True, id=3), ev("hybrid_spmm", 37, 50, True, id=3),
        ev("gemm", 60, 70, True, id=99), ev("add", 85, 90, True, id=6),
        ev("pgtt.step.replay", 30, 50, True, id=3, annotation=True),
    ])


def test_each_gap_goes_to_its_cause():
    d = idle.attribute(timeline())
    assert d.idle_by_span == {"loader.gather": pytest.approx(1e-6),
                              "step.copy_in": pytest.approx(6e-6),
                              "train_step": pytest.approx(15e-6)}
    assert d.queued_s == pytest.approx(2e-6)
    assert d.unattributed_s == pytest.approx(20e-6)
    assert d.starved_s("loader.") == pytest.approx(1e-6)
    assert d.starved_s("step.") == pytest.approx(6e-6)
    assert [(name, pytest.approx(s)) for name, s in d.gaps] == [
        ("train_step", 15e-6),
        ("train_step/step.train_step (unattributed)", 10e-6),
        ("epoch_end (unattributed)", 10e-6),
        ("train_step/step.copy_in", 6e-6),
        ("train_step/step.replay (queued)", 2e-6),
        ("fetch/loader.gather", 1e-6)]


def test_the_classes_partition_the_summary_idle_time():
    prof = timeline()
    s, d = trace.summarize(prof), idle.attribute(prof)
    assert s.busy_s == pytest.approx(46e-6)
    assert s.window_s == pytest.approx(90e-6)
    assert d.idle_s == pytest.approx(s.window_s * (1 - s.busy_s / s.window_s),
                                     rel=1e-9)
    # the program's spans change nothing the summary reads
    assert set(s.kernels) == {"gemm", "Memcpy HtoD", "hybrid_spmm", "add"}
    assert [name for name, _ in s.gaps] == [
        "train_step", "train_step", "epoch_end", "train_step", "train_step",
        "fetch"]


def test_innermost_span_by_hand():
    spans = [(0, 100, "a"), (10, 20, "b"), (12, 15, "c"), (30, 40, "d")]
    assert idle._innermost(spans, [5, 12, 16, 20, 35, 100]) == [
        "a", "c", "b", "a", "d", None]


def test_nothing_to_attribute():
    assert idle.attribute(Prof([ev("perfbench.fetch", 1, 2)])) is None
    assert idle.attribute(Prof([ev(trace.SUBWINDOW, 0, 10),
                                ev("perfbench.fetch", 1, 2)])) is None


def _reader():
    return manifest.load_metric("spmm_launches_per_step")


def test_launch_reader_in_a_dry_run(capsys):
    """On the CPU the diffusion takes the dense path: the reader counts no
    fused launch, and says so as a number."""
    assert run.report(tiny_cell("pems-pgti"), 2**31 + 11, 0.2, True,
                      "cpu") == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["metrics"]["spmm_launches_per_step"] == {
        "value": 0.0, "unit": "launches"}


def test_launch_reader_counts_the_last_train_records(monkeypatch):
    from pytorch_geometric_temporal_tpu_torch import _counters

    rec = _counters.StepRecord
    records = ([rec("train_step", {"bcsr_launches": (7, 0, 0)})]
               + [rec("train_step", {"bcsr_launches": (94, 0, 0)}),
                  rec("eval_step", {"bcsr_launches": (48, 0, 0)})] * 2)
    monkeypatch.setattr(_counters, "step_records", lambda: records)
    sub = types.SimpleNamespace(sub_kinds=[("train", 64), ("eval", 64),
                                           ("train", 64)])
    assert _reader().read(sub) == 94
    sub.sub_kinds.append(("train", 64))
    assert _reader().read(sub) == pytest.approx((7 + 94 + 94) / 3)
    sub.sub_kinds.append(("train", 64))     # more steps than records
    assert _reader().read(sub) is None


def test_launch_reader_is_silent_without_step_records(monkeypatch):
    """A program that keeps no step records (the parent of this reader)
    reads nothing, and raises nothing."""
    from pytorch_geometric_temporal_tpu_torch import _counters

    monkeypatch.delattr(_counters, "step_records")
    assert _reader().read(types.SimpleNamespace(
        sub_kinds=[("train", 64)])) is None


def test_idle_report_dry_run(capsys):
    """The report's loop on the CPU: traced sub-windows in turns, with the
    port's spans and without; no device records, so no readings."""
    from perfbench import idle_report
    from pytorch_geometric_temporal_tpu_torch import _counters

    span = _counters.span
    lines = idle_report.report(tiny_cell("pems-pgti"), 5, 0.1, 2, "cpu",
                               seconds=0.1)
    assert [line.get("spans") for line in lines] == [True, False, False, True,
                                                     None]
    assert set(lines[-1]["span_us"]) == {"span_off", "step_off", "span_on",
                                         "step_on"}
    assert all(line["steps_per_s"] > 0 for line in lines[:-1])
    assert _counters.span is span


def test_idle_report_readings_on_a_hand_made_timeline(monkeypatch):
    from perfbench import idle_report
    from pytorch_geometric_temporal_tpu_torch import _counters

    rec = _counters.StepRecord("train_step", {"bcsr_launches": (1, 0, 0)})
    monkeypatch.setattr(_counters, "step_records", lambda: [rec, rec])
    sub = types.SimpleNamespace(kinds=[("train", 64), ("train", 64)])
    r = idle_report.readings(timeline(), sub, [rec, rec])
    assert r["train_steps"] == 2 and r["spmm_launches_per_step"] == 1
    assert r["idle_s"] == pytest.approx(44e-6)
    assert r["partition_rel_err"] < 1e-9
    assert r["queued_s"] == pytest.approx(2e-6)
    assert r["loader_starve_ms"] == pytest.approx(1e-3 / 2)
    # one fused record (``hybrid_spmm``) against two counted launches
    assert (r["fused_records"], r["fused_launches"]) == (1, 2)
    assert r["lost_share"] == pytest.approx(0.5)
    assert r["program_device_annotations"] == r["flagged_as_annotations"] == 1
    assert r["program_names_in_kernels"] == []
    assert r["span_ms"]["step.copy_in"] == [1, pytest.approx(8e-3)]
