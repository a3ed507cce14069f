"""Training loops (port of the JAX package's ``train/trainer.py``).

- :class:`SnapshotTrainer` — the snapshot-loop protocol: loss accumulated
  over ALL snapshots of a :class:`~..signal.StackedSignal`, one optimizer
  update per epoch on the mean loss (full-sequence BPTT), optional
  rematerialization per snapshot.
- :class:`BatchTrainer` — the index-batching protocol: one update per
  batch, MSE by default, or masked MAE on z-score de-normalized values
  when a scaler is given.

The optimizer is ``torch.optim.Adam`` with optax's ``adam`` defaults
(betas 0.9/0.999, eps 1e-8, no weight decay), so an update matches the JAX
trainers'.  Every operation of an epoch is dispatched from Python, one
snapshot after the other.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from . import losses as losses_lib


def _adam(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


class SnapshotTrainer:
    """Full-BPTT snapshot-loop training, one Adam update per epoch.

    Args:
        model: the module whose parameters are trained; moved to ``device``.
        loss_and_state_fn: ``(carry, x, y, graph) -> (loss, carry)`` called
            per snapshot; ``carry`` threads recurrent state across
            snapshots (``()`` or None if stateless).
        lr: Adam learning rate.
        remat: run each snapshot under ``torch.utils.checkpoint`` so the
            backward pass recomputes its activations (memory O(1) in T).
        device: where the model lives (CUDA unless given "cpu").
    """

    def __init__(self, model: torch.nn.Module, loss_and_state_fn: Callable,
                 lr: float = 1e-2, remat: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = _adam(self.model, lr)
        if remat:
            def step(carry, x, y, g):
                return checkpoint(loss_and_state_fn, carry, x, y, g,
                                  use_reentrant=False)
        else:
            step = loss_and_state_fn
        self._step = step

    def _epoch_loss(self, signal, init_carry):
        def body(carry, x, y, g):
            state, acc = carry
            loss, state = self._step(state, x, y, g)
            return (state, acc + loss), ()

        zero = torch.zeros((), device=self.device)
        (state, total), _ = signal.scan(body, (init_carry, zero))
        return total / signal.snapshot_count, state

    def train_epoch(self, signal, init_carry=()) -> torch.Tensor:
        """One update on the mean loss over the signal's snapshots;
        returns that (detached, on-device) loss."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self._epoch_loss(signal, init_carry)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def evaluate(self, signal, init_carry=()) -> torch.Tensor:
        """Mean loss over the signal's snapshots, no update."""
        loss, _ = self._epoch_loss(signal, init_carry)
        return loss

    def fit(self, signal, epochs: int, init_carry=(),
            callback: Optional[Callable] = None, log_every: int = 1):
        """Run ``epochs`` updates.  The callback receives, every
        ``log_every`` epochs, the index of the last epoch and its
        on-device loss — ``float()`` it only if you want to block."""
        log_every = max(log_every, 1)
        for epoch in range(epochs):
            loss = self.train_epoch(signal, init_carry)
            if callback is not None and (
                    (epoch + 1) % log_every == 0 or epoch + 1 == epochs):
                callback(epoch, loss)
        return self.model


class BatchTrainer:
    """Per-batch training of ``model``.

    Args:
        model: the module whose parameters are trained; moved to ``device``.
        apply_fn: ``x_batch -> predictions`` (e.g. ``lambda x: model(x,
            ops)``); defaults to ``model``.
        lr: Adam learning rate.
        loss_fn: ``(pred, target) -> scalar``; defaults to masked MAE on
            de-normalized values when a scaler is given, else MSE.
        scaler: optional ZScoreScaler applied inversely before the loss.
        device: where batches go (CUDA unless given "cpu").
    """

    def __init__(self, model: torch.nn.Module,
                 apply_fn: Optional[Callable] = None, lr: float = 1e-3,
                 loss_fn: Optional[Callable] = None, scaler=None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.apply_fn = apply_fn if apply_fn is not None else self.model
        self.optimizer = _adam(self.model, lr)
        if loss_fn is None:
            if scaler is not None:
                def loss_fn(pred, target):
                    return losses_lib.masked_mae_loss(
                        scaler.inverse(pred), scaler.inverse(target))
            else:
                loss_fn = losses_lib.mse
        self.loss_fn = loss_fn

    def train_step(self, x, y) -> torch.Tensor:
        """One update; returns the (detached, on-device) batch loss."""
        x, y = x.to(self.device), y.to(self.device)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.apply_fn(x), y)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, x, y) -> torch.Tensor:
        x, y = x.to(self.device), y.to(self.device)
        return self.loss_fn(self.apply_fn(x), y)

    def fit(self, loader, epochs: int, val_loader=None,
            callback: Optional[Callable] = None):
        """Per-batch training loop.  Losses accumulate on the device; the
        host syncs once per epoch, at the callback."""
        for epoch in range(epochs):
            total, nb = torch.zeros((), device=self.device), 0
            for x, y in loader:
                total = total + self.train_step(x, y)
                nb += 1
            val = None
            if val_loader is not None:
                vt, vn = torch.zeros((), device=self.device), 0
                for x, y in val_loader:
                    vt = vt + self.eval_step(x, y)
                    vn += 1
                val = float(vt) / max(vn, 1)
            if callback is not None:
                callback(epoch, float(total) / max(nb, 1), val)
        return self.model
