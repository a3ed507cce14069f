"""The port's spans and step records (``_counters``): each span appears in
a profiler session, nested where it runs; each top-level step call keeps
what the counters gained over it; outside a session nothing is entered and
nothing kept.

The captured case runs only on the card (``-m cuda``; it skips here):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
-m cuda``.
"""

import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_geometric_temporal_tpu_torch import _counters
from pytorch_geometric_temporal_tpu_torch.signal import (
    DeviceWindower, IndexLoader, StreamingWindower)
from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer
from pytorch_geometric_temporal_tpu_torch.train.trainer import _DeviceGraphs

P = _counters.SPAN_PREFIX


def _spans(prof):
    """[(name without the prefix, start, end)] of the port's spans, in the
    order they began."""
    return sorted(((e.name[len(P):], e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(P)
                   and e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _parents(spans, name):
    """For each span called ``name``, the names of the spans holding it."""
    return [sorted(o[0] for o in spans if o is not s and _inside(s, o))
            for s in spans if s[0] == name]


class _Ticks:
    """A counter of the test's own, registered for the test's length."""

    def __init__(self, monkeypatch):
        self.n = 0
        monkeypatch.setitem(_counters._COUNTERS, "test_ticks",
                            (lambda: (self.n,), self._add))

    def _add(self, delta):
        self.n += delta[0]


def _setup(ticks=None, n=6, f=2, horizon=3, batch=4):
    data = np.random.default_rng(0).normal(size=(40, n, f)).astype(
        np.float32)
    windower = DeviceWindower(data, horizon, device="cpu")
    loader = IndexLoader(np.arange(20), windower, batch)
    lin = torch.nn.Linear(f, f)

    def apply(x):
        if ticks is not None:
            ticks.n += 1
        return lin(x)

    trainer = BatchTrainer(lin, apply, device="cpu")
    return loader, trainer


def test_eager_trainer_and_loader_spans_nest():
    loader, trainer = _setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches = 0
        for x, y in loader:
            trainer.train_step(x, y)
            batches += 1
        trainer.eval_step(x, y)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert batches == len(loader) == 5
    assert names.count("loader.batch") == batches
    for child in ("loader.check", "loader.upload", "loader.gather"):
        assert _parents(spans, child) == [["loader.batch"]] * batches
    assert names.count("step.train_step") == batches
    assert names.count("step.eval_step") == 1
    for child in ("step.backward", "step.optimizer"):
        assert _parents(spans, child) == [["step.train_step"]] * batches
    assert sorted(_parents(spans, "step.forward")) == sorted(
        [["step.train_step"]] * batches + [["step.eval_step"]])
    # a step and the next batch's loader span do not overlap
    assert not any(_inside(s, o) or _inside(o, s)
                   for s in spans if s[0] == "step.train_step"
                   for o in spans if o[0] == "loader.batch")


def test_the_loader_keeps_no_batch_it_yielded():
    """The span around a batch's gather holds nothing past the yield: once
    the caller drops a batch, its gathered block is freed, before the next
    one is gathered (a held block moves the caching allocator's peak)."""
    loader, _ = _setup()
    it = iter(loader)
    for _ in range(2):
        x, y = next(it)
        block = weakref.ref(x._base)
        assert y._base is x._base
        del x, y
        assert block() is None


def test_a_step_record_holds_what_its_step_counted(monkeypatch):
    ticks = _Ticks(monkeypatch)
    loader, trainer = _setup(ticks)
    _counters.clear_step_records()
    with profile(activities=[ProfilerActivity.CPU]):
        for x, y in loader:
            trainer.train_step(x, y)
        trainer.eval_step(x, y)
        with _counters.step("outer"):
            trainer.train_step(x, y)    # nested: one record, the outer's
            ticks.n += 2
    records = _counters.step_records()
    assert [r.name for r in records] == (["train_step"] * 5
                                         + ["eval_step", "outer"])
    assert [r.counted["test_ticks"] for r in records] == (
        [(1,)] * 6 + [(3,)])


def test_device_graph_steps_on_the_cpu_keep_their_names():
    """``_DeviceGraphs``' eager branch spans and records its step by the
    step function's own name."""
    graphs = _DeviceGraphs("harness.train_epoch", None)
    _counters.clear_step_records()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = graphs(torch.device("cpu"), lambda a: a + 1, (torch.ones(2),))
    assert torch.equal(out, torch.full((2,), 2.0))
    assert [s[0] for s in _spans(prof)] == ["step.train_epoch"]
    assert [r.name for r in _counters.step_records()] == ["train_epoch"]


def test_streaming_windower_spans(tmp_path):
    path = tmp_path / "series.npy"
    np.save(path, np.arange(40 * 3, dtype=np.float64).reshape(40, 3))
    loader = IndexLoader(np.arange(10), StreamingWindower(path, 2, "cpu"), 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [x.clone() for x, _ in loader]
    spans = _spans(prof)
    assert len(got) == 3 and got[0].dtype == torch.float32
    for child in ("loader.read", "loader.upload"):
        assert _parents(spans, child) == [["loader.batch"]] * 3


def test_no_session_enters_no_range_and_keeps_no_record(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler on")

    ticks = _Ticks(monkeypatch)
    loader, trainer = _setup(ticks)
    _counters.clear_step_records()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for x, y in loader:
        trainer.train_step(x, y)
    trainer.eval_step(x, y)
    _DeviceGraphs("step", None)(torch.device("cpu"), lambda: 0, ())
    assert ticks.n == 6
    assert _counters.step_records() == []
    # one shared null context, whatever the name
    assert _counters.span("a") is _counters.step("b") is _counters.span("c")


def test_step_records_stay_bounded():
    _counters.clear_step_records()
    n = _counters.MAX_STEP_RECORDS + 10
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n):
            with _counters.step(f"s{i}"):
                pass
    records = _counters.step_records()
    assert len(records) == _counters.MAX_STEP_RECORDS
    assert records[-1].name == f"s{n - 1}" and records[0].name == "s10"
    _counters.clear_step_records()
    assert _counters.step_records() == []


def test_a_failed_step_keeps_no_record():
    _counters.clear_step_records()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with _counters.step("bad"):
                raise ValueError("no")
        with _counters.step("good"):
            pass
    assert [r.name for r in _counters.step_records()] == ["good"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_step_spans_and_replay_records(cuda):
    """A captured ``BatchTrainer`` over an index loader, DCRNNSeq on a raw
    graph above the dense threshold: the first call spans ``step.warm``,
    the second ``step.capture`` then copy-in, replay and clone-out, the
    third copy-in, replay and clone-out; every call's record holds the
    fused launches of one train batch."""
    from pytorch_geometric_temporal_tpu_torch.data._common import (
        make_index_loaders)
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import Graph

    n, lags, K = 5000, 4, 2
    rng = np.random.default_rng(3)
    s = rng.integers(0, n, size=30_000)
    r = np.clip(s + rng.integers(-8, 9, size=s.size), 0, n - 1)
    g = Graph.from_edge_index(np.stack([s, r]),
                              rng.uniform(0.1, 1, s.size).astype(np.float32),
                              num_nodes=n, device=cuda)
    data = rng.normal(size=(60, n, 2))
    train, _, _ = make_index_loaders(data, lags, 8, device=cuda)
    model = DCRNNSeq(2, 2, K, generator=torch.Generator().manual_seed(0))
    trainer = BatchTrainer(model, lambda x: model(x, g))
    assert trainer.capture
    _counters.clear_step_records()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        it = iter(train)
        for _ in range(3):
            trainer.train_step(*next(it))
        torch.cuda.synchronize()
    spans = _spans(prof)
    steps = [sp for sp in spans if sp[0] == "step.train_step"]
    assert len(steps) == 3
    inner = [[sp[0] for sp in spans if sp is not st and _inside(sp, st)
              and sp[0] in ("step.warm", "step.capture", "step.copy_in",
                            "step.replay", "step.clone_out")]
             for st in steps]
    assert inner == [["step.warm"],
                     ["step.capture", "step.copy_in", "step.replay",
                      "step.clone_out"],
                     ["step.copy_in", "step.replay", "step.clone_out"]]
    per_train = 2 * (2 * lags * (K - 1) * 2 - (K - 1))
    records = _counters.step_records()
    assert [r.name for r in records] == ["train_step"] * 3
    assert [r.counted["bcsr_launches"] for r in records] == [
        (per_train, 0, 0)] * 3
    assert (trainer.captures, trainer.replays) == (1, 2)
