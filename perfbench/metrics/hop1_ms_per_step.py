"""Device ms of edge-mode ASTGCN's hop-1 kernel (``csrc/weighted_hop.cu``:
kernels whose names match ``weighted_hop``, forward and backward) in the
traced sub-window, per train step.  Silent where no such kernel ran, as in
a program whose hop 1 is PyTorch's gathers and ``index_add_``."""

import re

from perfbench.metrics import _common

LAYER = "models (models/attention/astgcn.py)"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
KERNELS = re.compile(r"weighted_hop")


def read(run):
    steps = _common.train_steps(run)
    if run.summary is None or not steps:
        return None
    spent = sum(s for name, (s, _) in run.summary.kernels.items()
                if KERNELS.search(name))
    return 1e3 * spent / steps if spent > 0 else None
