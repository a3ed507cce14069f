"""Loss functions (port of the JAX package's ``train/losses.py``)."""

from __future__ import annotations

import torch


def mse(pred, target):
    return torch.mean((pred - target) ** 2)


def mae(pred, target):
    return torch.mean(torch.abs(pred - target))


def rmse(pred, target):
    return torch.sqrt(mse(pred, target))


def masked_mae_loss(y_pred, y_true, null_val: float = 0.0):
    """MAE over entries where ``y_true != null_val``; NaNs zeroed.  The mask
    is mean-normalized and multiplied into the elementwise loss."""
    mask = (y_true != null_val).to(y_pred.dtype)
    mask = mask / torch.clamp(torch.mean(mask), min=1e-16)
    loss = torch.abs(y_pred - y_true) * mask
    loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
    return torch.mean(loss)


def masked_mse_loss(y_pred, y_true, null_val: float = 0.0):
    mask = (y_true != null_val).to(y_pred.dtype)
    mask = mask / torch.clamp(torch.mean(mask), min=1e-16)
    loss = ((y_pred - y_true) ** 2) * mask
    loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
    return torch.mean(loss)


def mape(pred, target, eps: float = 1e-8):
    return torch.mean(torch.abs(
        (pred - target) / torch.clamp(torch.abs(target), min=eps)))
