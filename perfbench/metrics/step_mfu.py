"""The model's operations in the traced sub-window (the gate and readout
GEMMs forward and backward, 2·nnz·F a hop forward and backward, counted
from shapes and the cell's graph) over the sub-window's seconds, as a
share of the card's f32 peak outside the tensor cores (67 TFLOP/s; the
configurations keep TF32 off)."""

from perfbench import costs
from perfbench.metrics import _common

LAYER = "step (train/trainer.py BatchTrainer)"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or not _common.train_steps(run):
        return None
    gemm, hops = _common.work(run)
    ops = gemm + costs.hops_flops(run.operators, hops)
    peak = costs.PEAK_FLOPS[run.config["recipe"]["dtype"]]
    return 100.0 * ops / s.window_s / peak
