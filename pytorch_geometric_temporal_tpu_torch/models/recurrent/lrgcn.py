"""LRGCN: relational GCN LSTM for path-failure prediction (Li et al., arXiv
1905.03994).

Port of the JAX package's ``models/recurrent/lrgcn.py``.  Relations are
passed as a sequence of :class:`Graph` objects (one per relation); use
:func:`split_relations` to build them host-side.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.graph import Graph
from .._cells import FlaxModule
from ..conv import RGCNConv


def split_relations(edge_index, edge_type, num_relations, num_nodes,
                    edge_weight=None, device=None):
    """Host-side: split a typed edge list into per-relation Graphs on
    ``device`` (CUDA unless "cpu"), padded to a common edge count."""
    edge_index = np.asarray(edge_index)
    edge_type = np.asarray(edge_type)
    pad = 0
    per_rel = []
    for r in range(num_relations):
        m = edge_type == r
        per_rel.append((edge_index[:, m],
                        None if edge_weight is None
                        else np.asarray(edge_weight)[m]))
        pad = max(pad, int(m.sum()))
    return [Graph.from_edge_index(ei, ew, num_nodes=num_nodes,
                                  pad_to=max(pad, 1), device=device)
            for ei, ew in per_rel]


class LRGCN(FlaxModule):
    """forward: (X, rel_graphs, H=None, C=None) -> (H, C)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_relations: int, num_bases: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = out_channels
        for gate in "ifco":
            for src, width in (("x", in_channels), ("h", out_channels)):
                self.add_module(f"conv_{src}_{gate}", RGCNConv(
                    width, out_channels, num_relations, num_bases,
                    device=device, generator=generator))

    def forward(self, x: torch.Tensor, rel_graphs: Sequence[Graph],
                h: Optional[torch.Tensor] = None,
                c: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if h is None:
            h = x.new_zeros(x.shape[:-1] + (self.out_channels,))
        if c is None:
            c = x.new_zeros(x.shape[:-1] + (self.out_channels,))

        def pair(name):
            return (getattr(self, f"conv_x_{name}")(x, rel_graphs)
                    + getattr(self, f"conv_h_{name}")(h, rel_graphs))

        i = torch.sigmoid(pair("i"))
        f = torch.sigmoid(pair("f"))
        c_new = f * c + i * torch.tanh(pair("c"))
        o = torch.sigmoid(pair("o"))
        return o * torch.tanh(c_new), c_new
