"""Diffusion-Convolutional RNN (DCRNN) — single-step cell and seq2seq model.

Port of the JAX package's ``models/recurrent/dcrnn.py`` (paper form, Li et
al., arXiv 1707.01926).  The bidirectional diffusion bases are stacked on
the feature axis, so the z/r gates are one matmul and the candidate
another; parameters keep the flax layout ``(in, out)`` and compute is
``z @ w``.  :meth:`params_from_flax` loads a flax parameter tree (as numpy)
into a module — the weight carry-over from the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..._device import resolve_device
from ...ops.graph import Graph, diffusion_norms
from ...ops.operators import DiffusionOperators
from ...ops.spmm import spmm, spmm_segment
from .._cells import FlaxModule, glorot, zeros
from .._validate import check_node_axis
from ..conv import cat_features


def diffusion_basis(graph, x: torch.Tensor, K: int) -> torch.Tensor:
    """Stacked bidirectional diffusion basis, shape (..., N, 2·K·F).

    Layout: [T_0^f … T_{K-1}^f | T_0^b … T_{K-1}^b] with T_0 = X,
    T_1 = P X, T_k = 2 P T_{k-1} − T_{k-2}.  ``graph`` may be a raw
    :class:`Graph` (normalized here) or prebuilt
    :class:`DiffusionOperators` (the large-graph path).
    """
    check_node_axis(x, graph, "DCRNN/diffusion_basis", "(..., N, F)")
    if isinstance(graph, DiffusionOperators):
        p_fwd, p_bwd = graph.p_fwd, graph.p_bwd
    else:
        p_fwd, p_bwd = diffusion_norms(graph)
    out = []
    for p in (p_fwd, p_bwd):
        tx = [x]
        if K > 1:
            tx.append(spmm(p, x))
        for _ in range(2, K):
            tx.append(2.0 * spmm(p, tx[-1]) - tx[-2])
        out.extend(tx)
    return cat_features(out)


def diffusion_basis_reference(graph: Graph, x: torch.Tensor,
                              K: int) -> torch.Tensor:
    """The basis as upstream PyTorch Geometric Temporal's ``DConv`` computes
    it, quirks included (``compat='reference'``):

    1. **Unweighted messages**: edge weights enter only through the
       (weighted) degree norms, never the messages.
    2. **Misaligned reverse norms**: the reverse edge list is sorted by
       (receiver, sender), but the norms applied to it are
       ``1/deg_in[sender]`` in the ORIGINAL edge order.
    3. **Frozen recurrence**: every hop computes ``T_k = 2·P·T_{k-1} − X``,
       not the Chebyshev ``− T_{k-2}``.

    Valid only for graphs with ``edge_pad == num_edges`` and no zero-weight
    edges.  Zero-degree nodes produce inf, as upstream.  Layout matches
    :func:`diffusion_basis`: (..., N, 2·K·F).
    """
    if graph.edge_pad != graph.num_edges:
        raise ValueError(
            "compat='reference' requires an unpadded edge list "
            f"(edge_pad={graph.edge_pad} != num_edges={graph.num_edges}): "
            "dense_to_sparse has no concept of padding edges"
        )
    w = graph.weights
    deg_out = torch.zeros(graph.num_nodes, dtype=w.dtype,
                          device=w.device).index_add_(0, graph.senders, w)
    deg_in = torch.zeros(graph.num_nodes, dtype=w.dtype,
                         device=w.device).index_add_(0, graph.receivers, w)
    norm_out = 1.0 / deg_out[graph.senders]       # per original edge
    norm_in = 1.0 / deg_in[graph.senders]         # upstream quirk: senders!
    # the reverse list sorted by (orig receiver, orig sender); the norms
    # stay in the ORIGINAL order (the misalignment)
    order = torch.argsort(graph.receivers * graph.num_nodes + graph.senders,
                          stable=True)
    fwd = graph.with_weights(norm_out)
    bwd = Graph(senders=graph.receivers[order],
                receivers=graph.senders[order], weights=norm_in,
                num_nodes=graph.num_nodes, num_edges=graph.num_edges)
    out = []
    for p in (fwd, bwd):
        tx = [x]
        if K > 1:
            tx.append(spmm_segment(p, x))
        for _ in range(2, K):
            tx.append(2.0 * spmm_segment(p, tx[-1]) - x)  # frozen Tx_0 = X
        out.extend(tx)
    return torch.cat(out, dim=-1)


def _basis(graph, x, K, compat):
    if compat == "reference":
        return diffusion_basis_reference(graph, x, K)
    return diffusion_basis(graph, x, K)


class DConv(FlaxModule):
    """Diffusion convolution layer: ``diffusion_basis(graph, x, K) @ weight
    (+ bias)``.  ``compat='reference'`` takes
    :func:`diffusion_basis_reference` instead of the paper's weighted
    operators."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 use_bias: bool = True, compat: Optional[str] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.K, self.compat = K, compat
        self.weight = nn.Parameter(
            glorot((2 * K * in_channels, out_channels), generator, device))
        self.bias = (nn.Parameter(zeros((out_channels,), device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        z = _basis(graph, x, self.K, self.compat)
        out = (z @ self.weight.to(z.dtype)).to(x.dtype)
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)
        return out


class DCRNN(FlaxModule):
    """Single-step diffusion-convolutional GRU cell.

    forward: (X (..., N, F), graph, H=None) -> H (..., N, C).  All three
    gates are diffusion convolutions over concat([X, H]) (z, r fused) and
    concat([X, H·R]) (candidate).
    """

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 use_bias: bool = True, compat: Optional[str] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.out_channels = out_channels
        self.K, self.compat = K, compat
        width = 2 * K * (in_channels + out_channels)
        self.w_zr = nn.Parameter(
            glorot((width, 2 * out_channels), generator, device))
        self.b_zr = (nn.Parameter(zeros((2 * out_channels,), device))
                     if use_bias else None)
        self.w_h = nn.Parameter(
            glorot((width, out_channels), generator, device))
        self.b_h = (nn.Parameter(zeros((out_channels,), device))
                    if use_bias else None)

    def forward(self, x: torch.Tensor, graph,
                h: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.update(
            x, h, lambda z: _basis(graph, z, self.K, self.compat))

    def update(self, x: torch.Tensor, h: Optional[torch.Tensor],
               basis) -> torch.Tensor:
        """The GRU update, with ``basis(z)`` the stacked diffusion basis of
        ``z`` on the feature axis (the node-partitioned cell passes its own,
        ``parallel/partitioned_dcrnn.py``)."""
        C = self.out_channels
        if h is None:
            h = x.new_zeros(x.shape[:-1] + (C,))
        b_xh = basis(torch.cat([x, h], dim=-1))
        zr = (b_xh @ self.w_zr.to(b_xh.dtype)).to(x.dtype)
        if self.b_zr is not None:
            zr = zr + self.b_zr.to(x.dtype)
        z, r = torch.split(torch.sigmoid(zr), C, dim=-1)
        b_xhr = basis(torch.cat([x, h * r], dim=-1))
        ht = (b_xhr @ self.w_h.to(b_xhr.dtype)).to(x.dtype)
        if self.b_h is not None:
            ht = ht + self.b_h.to(x.dtype)
        h_tilde = torch.tanh(ht)
        return z * h + (1.0 - z) * h_tilde


class DCRNNSeq(FlaxModule):
    """Sequence-to-sequence DCRNN over (B, T, N, F) inputs; returns all
    hidden states (B, T, N, C).  One cell, shared across the T steps of a
    Python loop."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 use_bias: bool = True, compat: Optional[str] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = out_channels
        self.cell = DCRNN(in_channels, out_channels, K, use_bias, compat,
                          device=device, generator=generator)

    def forward(self, x: torch.Tensor, graph,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(
                f"DCRNNSeq expects input (B, T, N, F); got shape "
                f"{tuple(x.shape)}")
        if x.shape[2] != graph.num_nodes:
            raise ValueError(
                f"node axis {x.shape[2]} != graph.num_nodes "
                f"{graph.num_nodes}")
        B, T, N, _ = x.shape
        h = h0 if h0 is not None else x.new_zeros((B, N, self.out_channels))
        hs = []
        for t in range(T):
            h = self.cell(x[:, t], graph, h)
            hs.append(h)
        return torch.stack(hs, dim=1)
