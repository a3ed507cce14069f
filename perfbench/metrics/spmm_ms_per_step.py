"""Device ms of the aggregation kernels (names matching ``SPMM_KERNELS``)
in the traced sub-window, per train step (the share of a validation pass
included, where one falls in it)."""

from perfbench.metrics import _common

LAYER = "kernel (csrc/hybrid_spmm.cu)"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
PATTERNS = _common.SPMM_KERNELS.pattern


def read(run):
    steps = _common.train_steps(run)
    if run.summary is None or not steps:
        return None
    spent = _common.spmm_seconds(run)
    return 1e3 * spent / steps if spent > 0 else None
