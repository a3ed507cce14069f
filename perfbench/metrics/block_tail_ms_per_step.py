"""Device ms of an ASTGCN block's tail kernel (``csrc/block_tail.cu``:
kernels whose names match ``block_tail``, forward, backward and the
backward's sums) in the traced sub-window, per train step.  Silent where no
such kernel ran, as in a program whose tail is cuDNN's convolutions and
PyTorch's elementwise ops."""

import re

from perfbench.metrics import _common

LAYER = "models (models/attention/astgcn.py)"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
KERNELS = re.compile(r"block_tail")


def read(run):
    steps = _common.train_steps(run)
    if run.summary is None or not steps:
        return None
    spent = sum(s for name, (s, _) in run.summary.kernels.items()
                if KERNELS.search(name))
    return 1e3 * spent / steps if spent > 0 else None
