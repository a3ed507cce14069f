"""MSTGCN: multi-component spatial-temporal GCN (ASTGCN minus attention).

Port of the JAX package's ``models/attention/mstgcn.py``.  λ_max of the
un-normalized Laplacian comes from power iteration on the device, so the
scaled Laplacian changes from call to call: it is a transient graph, and
its aggregations run dense at small N and on the segment path at large N,
never through a host-built BCSR operator (see ``ops/graph.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..._device import resolve_device
from ...ops.graph import lambda_max as power_lambda_max
from .._cells import Conv, FlaxModule, LayerNorm, glorot, uniform
from .._validate import check_node_axis, check_rank
from ..conv import ChebConv


class MSTGCNBlock(FlaxModule):
    """ChebConv → time conv + residual + LayerNorm; layout (B, N, F, T)."""

    def __init__(self, in_channels: int, K: int, nb_chev_filter: int,
                 nb_time_filter: int, time_strides: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cheb_conv = ChebConv(in_channels, nb_chev_filter, K, None,
                                  device=device, generator=generator)
        self.time_conv = Conv(
            nb_chev_filter, nb_time_filter, (1, 3),
            strides=(1, time_strides), padding=((0, 0), (1, 1)),
            device=device, generator=generator)
        self.residual_conv = Conv(
            in_channels, nb_time_filter, (1, 1), strides=(1, time_strides),
            device=device, generator=generator)
        self.layer_norm = LayerNorm(nb_time_filter, device=device)

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        xt = x.movedim(-1, 1)  # (B, T, N, F)
        if isinstance(graph, (list, tuple)):
            outs = [self.cheb_conv(xt[:, t], g, power_lambda_max(g, None))
                    for t, g in enumerate(graph)]
            x_tilde = torch.relu(torch.stack(outs, dim=1))
        else:
            lam = power_lambda_max(graph, None)
            x_tilde = torch.relu(self.cheb_conv(xt, graph, lam))
        x_tilde = self.time_conv(x_tilde.transpose(1, 2))  # (B, N, T', C)
        res = self.residual_conv(x.movedim(-1, 2))
        out = self.layer_norm(torch.relu(res + x_tilde))
        return out.movedim(2, -1)  # (B, N, C, T')


def final_conv(owner: nn.Module, num_for_predict: int, t_out: int,
               nb_time_filter: int, device, generator) -> None:
    """The (A/M)STGCN head's parameters: out[b, n, p] = Σ_{t, f}
    X[b, n, f, t] W[p, t, f] + b[p]."""
    owner.final_conv_w = nn.Parameter(glorot(
        (num_for_predict, t_out, nb_time_filter), generator, device))
    owner.final_conv_b = nn.Parameter(
        uniform((num_for_predict,), generator, device))


class MSTGCN(FlaxModule):
    """forward: (X (B, N, F_in, T_in), graph | [graphs]) -> (B, N, T_out)."""

    def __init__(self, nb_block: int, in_channels: int, K: int,
                 nb_chev_filter: int, nb_time_filter: int, time_strides: int,
                 num_for_predict: int, len_input: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.len_input = len_input
        self.block_0 = MSTGCNBlock(in_channels, K, nb_chev_filter,
                                   nb_time_filter, time_strides, device,
                                   generator)
        for i in range(1, nb_block):
            self.add_module(f"block_{i}", MSTGCNBlock(
                nb_time_filter, K, nb_chev_filter, nb_time_filter, 1, device,
                generator))
        self.nb_block = nb_block
        final_conv(self, num_for_predict, len_input // time_strides,
                   nb_time_filter, device, generator)

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        check_rank(x, "MSTGCN", "(B, N, F_in, T_in)", 4)
        g0 = graph[0] if isinstance(graph, (list, tuple)) else graph
        check_node_axis(x, g0, "MSTGCN", "(B, N, F_in, T_in)", axis=1)
        if x.shape[-1] != self.len_input:
            raise ValueError(
                f"MSTGCN expects T_in == len_input ({self.len_input}); got "
                f"trailing axis {x.shape[-1]} (shape {tuple(x.shape)})."
            )
        for i in range(self.nb_block):
            x = getattr(self, f"block_{i}")(x, graph)
        return (torch.einsum("bnft,ptf->bnp", x, self.final_conv_w)
                + self.final_conv_b)
