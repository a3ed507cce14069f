"""Per-batch seq2seq training (port of the JAX package's ``BatchTrainer``).

The index-batching protocol: one Adam update per batch, MSE by default, or
masked MAE on z-score de-normalized values when a scaler is given.  The
optimizer is ``torch.optim.Adam`` with optax's ``adam`` defaults
(betas 0.9/0.999, eps 1e-8), so a step matches the JAX trainer's update.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .._device import resolve_device
from . import losses as losses_lib


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
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
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
