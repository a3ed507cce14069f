"""AGCRN: adaptive graph convolutional recurrent network, graph-free (Bai et
al., arXiv 2007.02842).

Port of the JAX package's ``models/recurrent/agcrn.py``.  No edge list at
all — the support is learned from node embeddings E inside
:class:`~..conv.AVWGCN`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._cells import FlaxModule
from ..conv import AVWGCN


class AGCRN(FlaxModule):
    """forward: (X (B, N, F), E (N, D), H=None) -> H (B, N, C).

    ``topk``: large-N mode — the learned support keeps only the top-k
    neighbors per node and the Chebyshev recursion runs on vectors, so no
    (N, N) tensor is ever materialized (see :class:`~..conv.AVWGCN`).
    ``None`` (default) is the exact dense form, guarded above 8192 nodes.
    """

    def __init__(self, number_of_nodes: int, in_channels: int,
                 out_channels: int, K: int, embedding_dimensions: int,
                 topk: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.number_of_nodes = number_of_nodes
        self.out_channels = out_channels
        self.embedding_dimensions = embedding_dimensions
        width = in_channels + out_channels
        self.gate = AVWGCN(width, 2 * out_channels, K, embedding_dimensions,
                           topk, device, generator)
        self.update = AVWGCN(width, out_channels, K, embedding_dimensions,
                             topk, device, generator)

    def forward(self, x: torch.Tensor, e: torch.Tensor,
                h: Optional[torch.Tensor] = None) -> torch.Tensor:
        if e.dim() != 2 or tuple(e.shape) != (self.number_of_nodes,
                                              self.embedding_dimensions):
            raise ValueError(
                f"AGCRN expects node embeddings E of shape "
                f"({self.number_of_nodes}, {self.embedding_dimensions}); "
                f"got {tuple(e.shape)}.")
        if x.shape[-2] != self.number_of_nodes:
            raise ValueError(
                f"AGCRN expects X (..., N={self.number_of_nodes}, F); got "
                f"shape {tuple(x.shape)}.")
        C = self.out_channels
        if h is None:
            h = x.new_zeros(x.shape[:-1] + (C,))
        z, r = torch.split(
            torch.sigmoid(self.gate(torch.cat([x, h], dim=-1), e)), C,
            dim=-1)
        hc = torch.tanh(self.update(torch.cat([x, z * h], dim=-1), e))
        return r * h + (1.0 - r) * hc
