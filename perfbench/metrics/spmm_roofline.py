"""The aggregation kernels' share of their roofline in the traced
sub-window: Σ over the hops the model's mathematics demands of
``need_bound`` (the operators' nonzeros, N, the width, f32; from the
cell's graph, not from the stored tiles) ÷ Σ device time of the kernels
whose names match ``SPMM_KERNELS``.  Silent when no such kernel ran."""

from perfbench import costs
from perfbench.metrics import _common

LAYER = "kernel (csrc/hybrid_spmm.cu)"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
PATTERNS = _common.SPMM_KERNELS.pattern


def read(run):
    if run.summary is None:
        return None
    spent = _common.spmm_seconds(run)
    if spent <= 0:
        return None
    _, hops = _common.work(run)
    return 100.0 * costs.hops_bound_s(run.operators, hops) / spent
