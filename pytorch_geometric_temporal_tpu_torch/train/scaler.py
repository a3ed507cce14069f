"""Z-score feature scaler (port of the JAX package's ``train/scaler.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class ZScoreScaler:
    mean: torch.Tensor
    std: torch.Tensor

    @staticmethod
    def fit(data, axis=None, device=None) -> "ZScoreScaler":
        """Mean and std of ``data`` (numpy-convertible) in float64, kept
        as f32 tensors on ``device`` (CUDA unless given "cpu")."""
        device = resolve_device(device)
        data = np.asarray(data)
        mean = np.mean(data, axis=axis, dtype=np.float64)
        std = np.std(data, axis=axis, dtype=np.float64)
        return ZScoreScaler(
            mean=torch.as_tensor(mean, dtype=torch.float32, device=device),
            std=torch.as_tensor(std, dtype=torch.float32, device=device),
        )

    def transform(self, x):
        return (x - self.mean) / torch.where(
            self.std == 0, torch.ones_like(self.std), self.std)

    def inverse(self, x):
        return x * self.std + self.mean
