"""T-GCN: temporal GCN-GRU cell (Zhao et al., arXiv 1811.05320).

Port of the JAX package's ``models/recurrent/temporalgcn.py``.  One
batch-polymorphic class: inputs are (..., N, F), so (N, F) and (B, N, F)
both work — ``TGCN2`` is an alias.

Gate math:  gate = Linear(concat([GCNConv(X), H])).
"""

from __future__ import annotations

from typing import Optional

import torch

from .._cells import Dense, FlaxModule
from ..conv import GCNConv


class TGCN(FlaxModule):
    """forward: (X, graph, H=None) -> H.

    The three ``GCNConv``s normalize (``normalize=True``): over a
    :class:`~...ops.operators.PreparedGraph` that holds the GCN operator,
    ``gcn_norm`` returns the prebuilt one — the large-graph path, where
    each conv is one aggregation of ``X·W`` through the BCSR kernel.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 improved: bool = False, add_self_loops: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = out_channels
        for gate in "zrh":
            self.add_module(f"conv_{gate}", GCNConv(
                in_channels, out_channels, improved, add_self_loops,
                device=device, generator=generator))
            self.add_module(f"linear_{gate}", Dense(
                2 * out_channels, out_channels, device=device,
                generator=generator))

    def forward(self, x: torch.Tensor, graph,
                h: Optional[torch.Tensor] = None) -> torch.Tensor:
        if h is None:
            h = x.new_zeros(x.shape[:-1] + (self.out_channels,))
        z = torch.sigmoid(self.linear_z(
            torch.cat([self.conv_z(x, graph), h], dim=-1)))
        r = torch.sigmoid(self.linear_r(
            torch.cat([self.conv_r(x, graph), h], dim=-1)))
        h_tilde = torch.tanh(self.linear_h(
            torch.cat([self.conv_h(x, graph), h * r], dim=-1)))
        return z * h + (1.0 - z) * h_tilde


# Batched alias: the base class already accepts (B, N, F).
TGCN2 = TGCN
