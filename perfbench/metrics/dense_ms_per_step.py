"""Device ms of every kernel and copy but the aggregation's in the traced
sub-window, per train step (the share of a validation pass included, where
one falls in it): the gate GEMMs, ``cat_features``, the GRU's elementwise
ops, the readout, Adam, the loader's gather."""

from perfbench.metrics import _common

LAYER = "models (models/recurrent/dcrnn.py)"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(run):
    steps = _common.train_steps(run)
    if run.summary is None or not steps:
        return None
    return 1e3 * (_common.all_seconds(run) - _common.spmm_seconds(run)) / steps
