"""Parameter initializers shared by the models (flax's defaults)."""

from __future__ import annotations

import math

import torch


def glorot(shape, generator=None, device=None,
           dtype=torch.float32) -> torch.Tensor:
    """Glorot/Xavier uniform for an (in, out) weight: U(±sqrt(6/(in+out))),
    flax's ``glorot_uniform``.  Drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``), so a seed gives the same weights on any device."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return ((2.0 * u - 1.0) * limit).to(device=device, dtype=dtype)


def zeros(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, device=device, dtype=dtype)
