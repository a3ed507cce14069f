"""Training-health guards (port of the JAX package's ``train/guards.py``):
NaN/Inf loss detection and a divergence guard that rolls back to the last
good state."""

from __future__ import annotations

from typing import Any, Optional

import torch

from .state import clone_tree


def loss_is_finite(loss) -> torch.Tensor:
    """Device-side scalar: True when the loss is finite (no host sync)."""
    return torch.isfinite(torch.as_tensor(loss))


def _tensors(params):
    """name → tensor of a module's state (parameters and buffers), a dict
    of tensors, or a sequence of tensors."""
    if isinstance(params, torch.nn.Module):
        return params.state_dict(keep_vars=True)
    if isinstance(params, dict):
        return params
    return dict(enumerate(params))


class DivergenceGuard:
    """Detects a NaN or exploding loss and rolls back to the last good state.

    Usage::

        guard = DivergenceGuard(explode_factor=10.0)
        for epoch ...:
            loss = train_epoch(model, optimizer)
            model, optimizer, ok = guard.check(model, optimizer, loss)
            if not ok: lr_schedule.backoff()  # or stop

    ``params`` is a module, a dict or a sequence of tensors and
    ``opt_state`` a ``torch.optim`` optimizer (or None).  The optimizer
    changes its tensors in place, so a healthy check keeps a *copy* of
    both (cloned on their device; the JAX guard keeps references to
    immutable trees); a rollback copies it back in place and returns the
    same objects.  ``check`` syncs the loss to the host: call it at
    logging cadence.
    """

    def __init__(self, explode_factor: float = 10.0, patience: int = 1):
        self.explode_factor = explode_factor
        self.patience = patience
        self._best: Optional[float] = None
        self._good_state: Any = None
        self._bad_streak = 0

    def check(self, params, opt_state, loss):
        val = float(loss)
        healthy = (val == val) and (
            self._best is None or val < self._best * self.explode_factor)
        if healthy:
            self._best = val if self._best is None else min(self._best, val)
            self._good_state = (
                clone_tree(dict(_tensors(params))),
                None if opt_state is None
                else clone_tree(opt_state.state_dict()))
            self._bad_streak = 0
            return params, opt_state, True
        self._bad_streak += 1
        if self._good_state is not None and self._bad_streak >= self.patience:
            good_params, good_opt = self._good_state
            with torch.no_grad():
                for key, t in _tensors(params).items():
                    t.copy_(good_params[key])
            if opt_state is not None:
                opt_state.load_state_dict(clone_tree(good_opt))
        return params, opt_state, False
