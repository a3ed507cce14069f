"""The trace reduction on a hand-made timeline: busy time as the union of
device intervals, idle gaps named by the host span they fall in."""

import types

import pytest
from torch.autograd import DeviceType

from perfbench import trace


def ev(name, a, b, device=False):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=a, end=b))


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_union_and_gaps_by_hand():
    assert trace._union([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace._gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8) == [
        (0, 1), (3, 5), (6, 8)]


def test_summary_by_hand():
    prof = Prof([
        ev(trace.SUBWINDOW, 0, 100),
        ev("perfbench.fetch", 10, 12), ev("perfbench.train_step", 12, 60),
        ev("perfbench.epoch_end", 60, 100),
        ev("hybrid_spmm_kernel", 5, 20, True),     # clipped to start at 10
        ev("gemm", 15, 40, True), ev("gemm", 50, 70, True),
        ev("Optimizer.step#Adam.step", 0, 100, True),   # an annotation
    ])
    s = trace.summarize(prof)
    assert s.window_s == pytest.approx(90e-6)
    assert s.busy_s == pytest.approx((40 - 10 + 70 - 50) * 1e-6)
    assert s.kernels["gemm"] == [pytest.approx(45e-6), 2]
    assert s.kernels["hybrid_spmm_kernel"] == [pytest.approx(10e-6), 1]
    assert "Optimizer.step#Adam.step" not in s.kernels
    assert [(w, pytest.approx(t)) for w, t in s.gaps] == [
        ("epoch_end", 30e-6), ("train_step", 10e-6)]
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "gemm"
    assert b["idle_gaps"][0] == ["epoch_end", pytest.approx(30e-6)]


def test_no_device_work_reads_nothing():
    prof = Prof([ev(trace.SUBWINDOW, 0, 10), ev("perfbench.fetch", 1, 2)])
    assert trace.summarize(prof) is None
