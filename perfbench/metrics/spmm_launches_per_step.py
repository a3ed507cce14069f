"""Fused-kernel launches a train step, counted by the program where each
step runs: the first count of its ``bcsr_launches`` counter (the fused
kernel; K1 and K2 follow) in the step records that the port keeps while
a profiler session is on (``_counters.step_records()``), over the last N
``train_step`` records, N the traced sub-window's train steps.  A replay's
record holds what its graph launched.  Silent where the program keeps no
step records."""

from perfbench.metrics import _common

LAYER = "kernel (csrc/hybrid_spmm.cu)"
UNIT = "launches"
MOVES = "train_samples_per_s"
SOURCE = "program_counter"


def read(run):
    from pytorch_geometric_temporal_tpu_torch import _counters

    steps = _common.train_steps(run)
    records = getattr(_counters, "step_records", None)
    if records is None or not steps:
        return None
    train = [r for r in records() if r.name == "train_step"][-steps:]
    if len(train) < steps:
        return None
    return sum(r.counted.get("bcsr_launches", (0,))[0] for r in train) / steps
