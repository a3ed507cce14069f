"""Mean host ms inside the benchmark's span around each ``train_step``
call in the window (the captured step's replay and static copy-in)."""

LAYER = "step (train/trainer.py BatchTrainer)"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(run):
    if not run.step_host_ms:
        return None
    return sum(run.step_host_ms) / len(run.step_host_ms)
