"""HeteroGCLSTM: graph-convolutional LSTM over heterogeneous graphs.

Port of the JAX package's ``models/hetero/heterogclstm.py``.  Typed edges
arrive as a dict ``{(src_type, rel, dst_type): Graph}`` of bipartite graphs
(``Graph.from_edge_index(..., num_src=...)``).  Per gate and edge type a
:class:`~..conv.SAGEConv` (mean aggregation) runs over the hidden states
and the results are summed into the destination type (PyG ``HeteroConv``'s
'sum'); per node type dense ``W_*``/``b_*`` act on the inputs.  Parameters
keep the flax names: ``conv_{gate}_{src}__{rel}__{dst}``, ``W_{gate}_{nt}``
and ``b_{gate}_{nt}`` for the gates i, f, c, o.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..._device import resolve_device
from .._cells import FlaxModule, flax_params, glorot, load_flax
from ..conv import SAGEConv

GATES = ("i", "f", "c", "o")


def _conv_name(gate: str, edge_type) -> str:
    src, rel, dst = edge_type
    return f"conv_{gate}_{src}__{rel}__{dst}"


class HeteroGCLSTM(FlaxModule):
    """forward: (x_dict, edge_graphs, h_dict=None, c_dict=None) -> (h, c).

    ``metadata`` is (node_types, edge_types), the edge types 3-tuples.  An
    edge type missing from ``edge_graphs`` contributes nothing; a node type
    that is the destination of no edge type gets a conv term of 0.
    """

    def __init__(self, in_channels_dict: Dict[str, int], out_channels: int,
                 metadata: Tuple, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        C = out_channels
        self.out_channels = C
        self.node_types = list(in_channels_dict)
        self.edge_types = [tuple(et) for et in metadata[1]]
        for gate in GATES:
            for et in self.edge_types:
                self.add_module(_conv_name(gate, et), SAGEConv(
                    C, C, device=device, generator=generator))
            for nt in self.node_types:
                self.register_parameter(f"W_{gate}_{nt}", nn.Parameter(
                    glorot((in_channels_dict[nt], C), generator, device)))
                self.register_parameter(f"b_{gate}_{nt}", nn.Parameter(
                    glorot((1, C), generator, device)))

    def params_from_flax(self, tree):
        """Load a flax tree.  The flax cell creates the convs of an edge
        type only when that type was in ``edge_graphs`` at init; convs the
        tree lacks are dropped here, so the two modules hold the same
        parameters."""
        present = flax_params(tree)
        for gate in GATES:
            for et in self.edge_types:
                name = _conv_name(gate, et)
                if name not in present and name in self._modules:
                    delattr(self, name)
        return load_flax(self, tree)

    def _hetero_conv(self, gate, edge_graphs, h_dict):
        """Sum the per-edge-type SAGEConv(h) into each destination type."""
        out = {nt: 0.0 for nt in self.node_types}
        for et in self.edge_types:
            if et not in edge_graphs:
                continue
            name = _conv_name(gate, et)
            if name not in self._modules:
                raise KeyError(f"{name}: the loaded parameters hold no conv "
                               f"for edge type {et}")
            src, _, dst = et
            out[dst] = out[dst] + self._modules[name](
                h_dict[src], edge_graphs[et], x_dst=h_dict[dst])
        return out

    def forward(self, x_dict, edge_graphs, h_dict=None, c_dict=None):
        C = self.out_channels
        if h_dict is None:
            h_dict = {nt: x.new_zeros(x.shape[:-1] + (C,))
                      for nt, x in x_dict.items()}
        if c_dict is None:
            c_dict = {nt: x.new_zeros(x.shape[:-1] + (C,))
                      for nt, x in x_dict.items()}

        def gate(name, activation):
            conv = self._hetero_conv(name, edge_graphs, h_dict)
            res = {}
            for nt in self.node_types:
                x = x_dict[nt]
                w = getattr(self, f"W_{name}_{nt}").to(x.dtype)
                b = getattr(self, f"b_{name}_{nt}").to(x.dtype)
                res[nt] = activation(x @ w + conv[nt] + b)
            return res

        i = gate("i", torch.sigmoid)
        f = gate("f", torch.sigmoid)
        t = gate("c", torch.tanh)
        c_new = {nt: f[nt] * c_dict[nt] + i[nt] * t[nt]
                 for nt in self.node_types}
        o = gate("o", torch.sigmoid)
        h_new = {nt: o[nt] * torch.tanh(c_new[nt]) for nt in self.node_types}
        return h_new, c_new
