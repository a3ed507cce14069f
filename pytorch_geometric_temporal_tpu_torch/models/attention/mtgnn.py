"""MTGNN: multivariate time-series forecasting GNN (Wu et al., KDD'20).

Port of the JAX package's ``models/attention/mtgnn.py``: ``MixProp``,
``DilatedInception``, ``GraphConstructor`` (directed learned adjacency,
top-k sparsified per row), ``NodeIndexedLayerNorm`` (node-indexed affine),
``MTGNNLayer`` and ``MTGNN``, including the receptive-field arithmetic and
the front padding when seq < receptive field.

Internal layout is channel-last (B, N, T, C); ``MTGNN.forward`` accepts the
upstream layout (B, C_in, N, T) and returns (B, out_dim, N, 1).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..._device import resolve_device
from .._cells import Conv, Dense, Dropout, FlaxModule, glorot, zeros
from ..conv import _top_k


class MixProp(FlaxModule):
    """Mix-hop propagation: H_k = α·X + (1−α)·Ā H_{k−1}, concat, MLP."""

    def __init__(self, c_in: int, c_out: int, gdep: int, dropout: float,
                 alpha: float, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gdep, self.dropout, self.alpha = gdep, dropout, alpha
        self.mlp = Dense((gdep + 1) * c_in, c_out, True, glorot, device,
                         generator)

    def forward(self, x: torch.Tensor, a: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        # x: (B, N, T, C); a: (N, N)
        a = a + torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
        a = a / a.sum(1)[:, None]
        h, out = x, [x]
        for _ in range(self.gdep):
            h = self.alpha * x + (1.0 - self.alpha) * torch.einsum(
                "vw,bwtc->bvtc", a, h)
            out.append(h)
        return self.mlp(torch.cat(out, dim=-1))


class DilatedInception(FlaxModule):
    """Parallel (1, k) dilated convs, truncated to the shortest output."""

    def __init__(self, c_in: int, c_out: int, kernel_set: List[int],
                 dilation_factor: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_convs = len(kernel_set)
        for i, kern in enumerate(kernel_set):
            self.add_module(f"conv_{i}", Conv(
                c_in, c_out // len(kernel_set), (1, kern),
                kernel_dilation=(1, dilation_factor), padding="VALID",
                kernel_init=glorot, device=device, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, N, T, C)
        outs = [getattr(self, f"conv_{i}")(x) for i in range(self.n_convs)]
        t_min = outs[-1].shape[2]
        return torch.cat([o[:, :, -t_min:] for o in outs], dim=-1)


class GraphConstructor(FlaxModule):
    """Learned directed adjacency A = relu(tanh(α(M₁M₂ᵀ − M₂M₁ᵀ))), top-k
    per row.  With ``xd`` (the width of static node features ``fe``) the
    two embeddings are left out and ``fe`` takes their place."""

    def __init__(self, nnodes: int, k: int, dim: int, alpha: float,
                 xd: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.k, self.alpha = k, alpha
        if xd is None:
            self.embedding1 = nn.Parameter(
                glorot((nnodes, dim), generator, device))
            self.embedding2 = nn.Parameter(
                glorot((nnodes, dim), generator, device))
        in_dim = dim if xd is None else xd
        self.linear1 = Dense(in_dim, dim, True, glorot, device, generator)
        self.linear2 = Dense(in_dim, dim, True, glorot, device, generator)

    def forward(self, idx: torch.Tensor, fe=None) -> torch.Tensor:
        if fe is None:
            v1, v2 = self.embedding1[idx], self.embedding2[idx]
        else:
            v1 = v2 = fe[idx]
        v1 = torch.tanh(self.alpha * self.linear1(v1))
        v2 = torch.tanh(self.alpha * self.linear2(v2))
        n = v1.shape[0]
        if n > 8192:
            raise ValueError(
                f"MTGNN's GraphConstructor materializes an (N, N) learned "
                f"adjacency — O(N²); N={n} would allocate "
                f"{n * n * 4 / 2**30:.1f} GiB. The model is dense by "
                "construction; its own large-N mechanism (the `idx` "
                "argument) is subgraph training — pass a sampled node "
                "subset as `idx` each step so the constructed adjacency "
                "covers only that subset."
            )
        a = v1 @ v2.T - v2 @ v1.T
        a = torch.relu(torch.tanh(self.alpha * a))
        # top-k per row; relu(tanh(·)) leaves many exact zeros, and among
        # equal scores the lowest index is kept
        _, top_idx = _top_k(a.detach(), self.k)
        mask = torch.zeros_like(a).scatter_(1, top_idx, 1.0)
        return a * mask


class NodeIndexedLayerNorm(FlaxModule):
    """LayerNorm over (N, T, C) (biased variance) with affine params
    indexed by node."""

    def __init__(self, shape, elementwise_affine: bool = True,
                 eps: float = 1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        if elementwise_affine:
            self.weight = nn.Parameter(
                torch.ones(tuple(shape), device=device))
            self.bias = nn.Parameter(zeros(tuple(shape), device))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        # x: (B, N, T, C)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        var = x.var(dim=(1, 2, 3), keepdim=True, correction=0)
        xn = (x - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            xn = xn * self.weight[idx][None] + self.bias[idx][None]
        return xn


def _rf_size(kernel_size: int, dilation_exponential: int, j: int,
             rf_size_i: int = 1) -> int:
    """Receptive field after ``j`` layers (``int(...)`` as upstream)."""
    if dilation_exponential > 1:
        return int(
            rf_size_i
            + (kernel_size - 1)
            * (dilation_exponential ** j - 1)
            / (dilation_exponential - 1)
        )
    return rf_size_i + j * (kernel_size - 1)


class MTGNNLayer(FlaxModule):
    """One gated dilated-inception + mix-hop layer.  forward: (x, x_skip,
    a_tilde, idx, train=False, generator=None) -> (x, x_skip); the
    generator seeds the dropout mask."""

    def __init__(self, dilation_exponential: int, rf_size_i: int,
                 kernel_size: int, j: int, residual_channels: int,
                 conv_channels: int, skip_channels: int,
                 kernel_set: List[int], new_dilation: int,
                 layer_norm_affline: bool, gcn_true: bool, seq_length: int,
                 receptive_field: int, dropout: float, gcn_depth: int,
                 num_nodes: int, propalpha: float, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        rf_size_j = _rf_size(kernel_size, dilation_exponential, j, rf_size_i)
        # the time steps left after this layer's convolutions
        t_len = max(seq_length, receptive_field) - rf_size_j + 1
        self.gcn_true = gcn_true
        self.filter_conv = DilatedInception(
            residual_channels, conv_channels, kernel_set, new_dilation,
            device, generator)
        self.gate_conv = DilatedInception(
            residual_channels, conv_channels, kernel_set, new_dilation,
            device, generator)
        self.dropout = Dropout(dropout)
        self.skip_conv = Conv(conv_channels, skip_channels, (1, t_len),
                              padding="VALID", kernel_init=glorot,
                              device=device, generator=generator)
        if gcn_true:
            self.mixprop1 = MixProp(conv_channels, residual_channels,
                                    gcn_depth, dropout, propalpha, device,
                                    generator)
            self.mixprop2 = MixProp(conv_channels, residual_channels,
                                    gcn_depth, dropout, propalpha, device,
                                    generator)
        else:
            self.residual_conv = Dense(conv_channels, residual_channels,
                                       True, glorot, device, generator)
        self.norm = NodeIndexedLayerNorm(
            (num_nodes, t_len, residual_channels), layer_norm_affline,
            device=device)

    def forward(self, x, x_skip, a_tilde, idx, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x_residual = x
        x = torch.tanh(self.filter_conv(x)) * torch.sigmoid(self.gate_conv(x))
        x = self.dropout(x, train, generator)
        x_skip = self.skip_conv(x) + x_skip
        if self.gcn_true:
            x = (self.mixprop1(x, a_tilde, train)
                 + self.mixprop2(x, a_tilde.T, train))
        else:
            x = self.residual_conv(x)
        x = x + x_residual[:, :, -x.shape[2]:]
        return self.norm(x, idx), x_skip


class MTGNN(FlaxModule):
    """forward: (X_in (B, C_in, N, T), A_tilde=None, idx=None, FE=None,
    train=False, generator=None) -> (B, out_dim, N, 1)."""

    def __init__(self, gcn_true: bool, build_adj: bool, gcn_depth: int,
                 num_nodes: int, kernel_set: List[int], kernel_size: int,
                 dropout: float, subgraph_size: int, node_dim: int,
                 dilation_exponential: int, conv_channels: int,
                 residual_channels: int, skip_channels: int,
                 end_channels: int, seq_length: int, in_dim: int,
                 out_dim: int, layers: int, propalpha: float,
                 tanhalpha: float, layer_norm_affline: bool,
                 xd: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.gcn_true, self.build_adj = gcn_true, build_adj
        self.num_nodes, self.seq_length, self.layers = (
            num_nodes, seq_length, layers)
        self.receptive_field = rf = _rf_size(kernel_size,
                                             dilation_exponential, layers)
        if gcn_true and build_adj:
            self.graph_constructor = GraphConstructor(
                num_nodes, subgraph_size, node_dim, tanhalpha, xd, device,
                generator)
        self.start_conv = Dense(in_dim, residual_channels, True, glorot,
                                device, generator)
        self.dropout = Dropout(dropout)
        self.skip_conv_0 = Conv(
            in_dim, skip_channels, (1, max(seq_length, rf)), padding="VALID",
            kernel_init=glorot, device=device, generator=generator)
        new_dilation = 1
        for j in range(1, layers + 1):
            self.add_module(f"layer_{j - 1}", MTGNNLayer(
                dilation_exponential, 1, kernel_size, j, residual_channels,
                conv_channels, skip_channels, kernel_set, new_dilation,
                layer_norm_affline, gcn_true, seq_length, rf, dropout,
                gcn_depth, num_nodes, propalpha, device, generator))
            new_dilation *= dilation_exponential
        self.skip_conv_E = Conv(
            residual_channels, skip_channels,
            (1, max(seq_length, rf) - rf + 1), padding="VALID",
            kernel_init=glorot, device=device, generator=generator)
        self.end_conv_1 = Dense(skip_channels, end_channels, True, glorot,
                                device, generator)
        self.end_conv_2 = Dense(end_channels, out_dim, True, glorot, device,
                                generator)

    def forward(self, x_in, a_tilde=None, idx=None, fe=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        if x_in.shape[3] != self.seq_length:
            raise ValueError(
                "Input sequence length not equal to preset sequence length."
            )
        rf = self.receptive_field
        x_in = x_in.movedim(1, -1)  # (B, N, T, C)
        if self.seq_length < rf:
            x_in = torch.nn.functional.pad(
                x_in, (0, 0, rf - self.seq_length, 0))
        if idx is None:
            idx = torch.arange(self.num_nodes, device=x_in.device)
        if self.gcn_true and self.build_adj:
            a_tilde = self.graph_constructor(idx, fe)
        x = self.start_conv(x_in)
        x_skip = self.skip_conv_0(self.dropout(x_in, train, generator))
        for j in range(self.layers):
            x, x_skip = getattr(self, f"layer_{j}")(
                x, x_skip, a_tilde, idx, train, generator)
        x_skip = self.skip_conv_E(x) + x_skip
        x = torch.relu(x_skip)
        x = torch.relu(self.end_conv_1(x))
        return self.end_conv_2(x).movedim(-1, 1)  # (B, out_dim, N, 1)
