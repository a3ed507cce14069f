"""EvolveGCN-O and EvolveGCN-H: GCNs whose weights evolve through a GRU
(Pareja et al., arXiv 1902.10191).

Port of the JAX package's ``models/recurrent/evolvegcn.py``.  The evolved
weight is explicit carried state: pass ``weight=None`` for the first step
(the learned initial weight is used) and thread the returned weight through
the following steps.  The ``Seq`` forms run a whole snapshot sequence in a
Python loop over time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..._device import resolve_device
from ...ops.bcsr import StackedBCSR
from ...ops.graph import Graph
from .._cells import FlaxModule, GRUCell, glorot
from ..conv import gcn_conv_fixed_w, topk_pool


class _WeightGRU(FlaxModule):
    """GRU over the rows of the (C, C) weight matrix (rows = GRU batch)."""

    def __init__(self, features: int, device=None, generator=None):
        super().__init__()
        self.cell = GRUCell(features, features, device, generator)

    def forward(self, carry: torch.Tensor,
                inputs: torch.Tensor) -> torch.Tensor:
        return self.cell(carry, inputs)[0]


class EvolveGCNO(FlaxModule):
    """forward: (X, graph, weight=None) -> (X', weight).

    The GRU input and hidden state are both the previous weight.
    """

    def __init__(self, in_channels: int, improved: bool = False,
                 normalize: bool = True, add_self_loops: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        C = in_channels
        self.improved, self.normalize, self.add_self_loops = (
            improved, normalize, add_self_loops)
        self.initial_weight = nn.Parameter(
            glorot((C, C), generator, resolve_device(device)))
        self.recurrent = _WeightGRU(C, device, generator)

    def _summary(self, x, prev):
        return prev

    def forward(self, x: torch.Tensor, graph,
                weight: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        prev = self.initial_weight if weight is None else weight
        new_w = self.recurrent(prev, self._summary(x, prev))
        out = gcn_conv_fixed_w(
            x, graph, new_w, improved=self.improved,
            add_self_loops=self.add_self_loops, normalize=self.normalize)
        return out, new_w


class EvolveGCNH(EvolveGCNO):
    """forward: (X, graph, weight=None) -> (X', weight).

    Top-k pooling summarizes X (N, F) into exactly ``in_channels`` rows
    (ratio = C/N) which drive the weight GRU.
    """

    def __init__(self, num_of_nodes: int, in_channels: int,
                 improved: bool = False, normalize: bool = True,
                 add_self_loops: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, improved, normalize, add_self_loops,
                         device, generator)
        self.ratio = in_channels / num_of_nodes
        self.pool_score = nn.Parameter(
            glorot((in_channels, 1), generator, resolve_device(device)))

    def _summary(self, x, prev):
        return topk_pool(x, self.pool_score[:, 0], self.ratio)[0]


class _EvolveSeq(FlaxModule):
    """A cell run over a snapshot sequence with the weight carried.

    forward: (xs (T, N, F), graph) -> (T, N, F).  ``graph`` is one of

    - a static :class:`Graph`,
    - a stacked dynamic graph (edge tensors (T, E), ``ops.stack_graphs``)
      — each step aggregates over its own slice, or
    - a :class:`~...ops.bcsr.StackedBCSR` of prenormalized operators
      (``ops.operators.stack_bcsr_gcn(graphs)``) — the BCSR kernel serves
      every step of a LARGE dynamic-edge sequence (construct the Seq with
      ``normalize=False``: the normalization is baked into the tiles
      host-side).

    Step 0 runs with ``weight=None`` (the learned initial weight).
    """

    def forward(self, xs: torch.Tensor, graph) -> torch.Tensor:
        T = xs.shape[0]
        if isinstance(graph, StackedBCSR):
            if self.cell.normalize:
                raise ValueError(
                    f"{type(self).__name__} over a stacked BCSR operator "
                    "needs normalize=False — the GCN normalization is baked "
                    "into the tiles by ops.operators.stack_bcsr_gcn")
            graphs = list(graph)
        elif graph.senders.dim() == 2:
            graphs = [Graph(graph.senders[t], graph.receivers[t],
                            graph.weights[t], graph.num_nodes,
                            graph.num_edges) for t in range(T)]
        else:
            graphs = [graph] * T
        weight, outs = None, []
        for t in range(T):
            out, weight = self.cell(xs[t], graphs[t], weight)
            outs.append(out)
        return torch.stack(outs)


class EvolveGCNOSeq(_EvolveSeq):
    """EvolveGCN-O over a snapshot sequence with weight carry (see
    :class:`_EvolveSeq` for the accepted graphs)."""

    def __init__(self, in_channels: int, improved: bool = False,
                 normalize: bool = True, add_self_loops: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cell = EvolveGCNO(in_channels, improved, normalize,
                               add_self_loops, device, generator)


class EvolveGCNHSeq(_EvolveSeq):
    """EvolveGCN-H over a snapshot sequence with weight carry: each step's
    top-k pooled features drive the weight GRU (see :class:`_EvolveSeq` for
    the accepted graphs)."""

    def __init__(self, num_of_nodes: int, in_channels: int,
                 improved: bool = False, normalize: bool = True,
                 add_self_loops: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cell = EvolveGCNH(num_of_nodes, in_channels, improved,
                               normalize, add_self_loops, device, generator)
