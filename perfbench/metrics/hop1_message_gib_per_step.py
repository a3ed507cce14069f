"""GiB of per-edge messages that edge-mode ASTGCN's hop 1 formed a train
step, forward and backward: the bytes count of the program's
``astgcn_hop1`` counter (``models/attention/astgcn.py``) in the step
records that the port keeps while a profiler session is on
(``_counters.step_records()``), over the last N ``train_step`` records, N
the traced sub-window's train steps.  Silent where the program keeps no
such counter."""

from perfbench.metrics import _common

LAYER = "models (models/attention/astgcn.py)"
UNIT = "GiB"
MOVES = "train_samples_per_s"
SOURCE = "program_counter"


def read(run):
    from pytorch_geometric_temporal_tpu_torch import _counters

    steps = _common.train_steps(run)
    records = getattr(_counters, "step_records", None)
    if records is None or not steps:
        return None
    train = [r for r in records() if r.name == "train_step"][-steps:]
    if len(train) < steps or any("astgcn_hop1" not in r.counted
                                 for r in train):
        return None
    return sum(r.counted["astgcn_hop1"][1] for r in train) / steps / 2**30
