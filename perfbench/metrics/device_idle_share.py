"""Share of the traced sub-window in which no kernel or copy ran on the
card: 1 − (union of the device intervals on the timeline ÷ the window)."""

LAYER = "device"
UNIT = "fraction"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0:
        return None
    return 1.0 - s.busy_s / s.window_s
