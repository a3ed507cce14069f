"""The fused kernel's walked share of its f32 tile work a train step:
Σ walked ÷ Σ (walked + dense) of the program's ``bcsr_tiles`` counter (the
(tile, feature tile) products each launch issues, walked through their
nonzeros or multiplied densely) in the step records that the port keeps
while a profiler session is on (``_counters.step_records()``), over the
last N ``train_step`` records, N the traced sub-window's train steps.  A
replay's record holds what its graph issued.  Silent where the program
keeps no such counter, or issued no tile."""

from perfbench.metrics import _common

LAYER = "kernel (csrc/hybrid_spmm.cu)"
UNIT = "fraction"
MOVES = "train_samples_per_s"
SOURCE = "program_counter"


def read(run):
    from pytorch_geometric_temporal_tpu_torch import _counters

    steps = _common.train_steps(run)
    records = getattr(_counters, "step_records", None)
    if records is None or not steps:
        return None
    train = [r for r in records() if r.name == "train_step"][-steps:]
    if len(train) < steps or any("bcsr_tiles" not in r.counted
                                 for r in train):
        return None
    walked = sum(r.counted["bcsr_tiles"][0] for r in train)
    dense = sum(r.counted["bcsr_tiles"][1] for r in train)
    if walked + dense == 0:
        return None
    return walked / (walked + dense)
