"""Mean host ms inside the benchmark's span around each train batch's
fetch in the window (``IndexLoader`` → ``DeviceWindower``: the host check,
the pinned upload of the starts, one gather)."""

LAYER = "loader (signal/index_dataset.py)"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(run):
    if not run.fetch_ms:
        return None
    return sum(run.fetch_ms) / len(run.fetch_ms)
