"""Checkpoint and resume with ``torch.save`` (port of the JAX package's
``train/checkpoint.py``, which writes with orbax): a tree of tensors, a
module, an optimizer or a :class:`~.state.TrainState` goes to
``{path}/step_{step}/state.pt``, its tensors copied to the host first."""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional

import torch

from .state import STATE_FILE, restore_into, to_host


def save_checkpoint(path: str, state: Any, step: int = 0, force: bool = True):
    """Save ``state`` (params, optimizer state, carry, ...) at ``step``;
    an existing step is replaced when ``force``, else an error."""
    target = os.path.join(path, f"step_{step}")
    if os.path.exists(target):
        if not force:
            raise FileExistsError(f"{target} exists (pass force=True)")
        shutil.rmtree(target)
    os.makedirs(target)
    torch.save(to_host(state), os.path.join(target, STATE_FILE))


def restore_checkpoint(path: str, step: int = 0,
                       template: Optional[Any] = None) -> Any:
    """Restore a tree saved by :func:`save_checkpoint`.  With a
    ``template`` of matching structure the values come back on its
    devices and in its dtypes (a module, an optimizer or a TrainState is
    loaded in place); without one, on the host."""
    loaded = torch.load(os.path.join(path, f"step_{step}", STATE_FILE),
                        weights_only=True)
    return loaded if template is None else restore_into(template, loaded)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for d in os.listdir(path)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None
