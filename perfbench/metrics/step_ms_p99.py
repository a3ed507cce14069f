"""The 99th percentile of the window's train steps, each timed by CUDA
events on the stream from before its batch's fetch to after its update
(the end-to-end step tail's statistic, read where it is no end-to-end
metric: the card's slower spells make it flip between two levels)."""

import numpy as np

LAYER = "step (train/trainer.py BatchTrainer)"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(run):
    if not run.step_ms:
        return None
    return float(np.percentile(np.asarray(run.step_ms, dtype=np.float64), 99))
