"""A3T-GCN: attention-weighted aggregation of per-period T-GCN outputs.

Port of the JAX package's ``models/recurrent/attentiontemporalgcn.py``.  One
batch-polymorphic class: input (..., N, F, T) — (N, F, T) or (B, N, F, T).
Every period's TGCN starts from the *same* provided H (hidden states are
never chained across periods), and the attention vector, drawn uniform on
[0, 1), is softmaxed.  Periods are folded into a leading batch axis, so all
T TGCN applications run as one call.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..._device import resolve_device
from .._cells import FlaxModule
from .temporalgcn import TGCN


class A3TGCN(FlaxModule):
    """forward: (X (..., N, F, T), graph, H=None) -> H (..., N, C)."""

    def __init__(self, in_channels: int, out_channels: int, periods: int,
                 improved: bool = False, add_self_loops: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.periods = periods
        self.attention = nn.Parameter(
            torch.rand((periods,), generator=generator).to(
                resolve_device(device)))
        self.base_tgcn = TGCN(in_channels, out_channels, improved,
                              add_self_loops, device=device,
                              generator=generator)

    def forward(self, x: torch.Tensor, graph,
                h: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.shape[-1] != self.periods:
            raise ValueError(
                f"A3TGCN expects input (..., N, F, T={self.periods}); got "
                f"trailing dim {x.shape[-1]} (shape {tuple(x.shape)})")
        probs = torch.softmax(self.attention, dim=0)
        # (..., N, F, T) -> (T, ..., N, F): periods become a leading batch
        # axis; TGCN is batch-polymorphic, so one call covers all periods
        xt = torch.movedim(x, -1, 0)
        hh = None if h is None else h.expand((self.periods,) + h.shape)
        out = self.base_tgcn(xt, graph, hh)  # (T, ..., N, C)
        return torch.tensordot(probs.to(out.dtype), out, dims=([0], [0]))


A3TGCN2 = A3TGCN
