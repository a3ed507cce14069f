"""STGCN: spatio-temporal graph convolution blocks (Yu et al., IJCAI'18).

Port of the JAX package's ``models/attention/stgcn.py``.  The Chebyshev
convolution takes the whole (B, T', N, C) tensor in one call: over a BCSR
operator the leading axes fold into the feature axis, so one hop is one
fused-kernel launch at F = B·T'·C.  Layout is channel-last (B, T, N, C).
"""

from __future__ import annotations

from typing import Optional

import torch

from .._cells import BatchNorm, Conv, FlaxModule
from .._validate import check_node_axis, check_rank
from ..conv import ChebConv


class TemporalConv(FlaxModule):
    """Gated 1D-in-time conv: ``relu(P ⊙ σ(Q) + conv3(X))``.

    I/O: (B, T, N, C_in) -> (B, T - k + 1, N, C_out).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name in ("conv_1", "conv_2", "conv_3"):
            self.add_module(name, Conv(
                in_channels, out_channels, (1, kernel_size), padding="VALID",
                device=device, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (B, T, N, C) -> (B, N, T, C): convolve over the T axis
        xt = x.transpose(1, 2)
        p = self.conv_1(xt)
        q = torch.sigmoid(self.conv_2(xt))
        h = torch.relu(p * q + self.conv_3(xt))
        return h.transpose(1, 2)


class STConv(FlaxModule):
    """ST-Conv block: TemporalConv → ChebConv → TemporalConv → BatchNorm.

    forward: (X (B, T, N, C), graph, lambda_max=None, train=False) ->
    (B, T', N, C_out) with T' = T − 2(kernel_size − 1).  ``graph`` is a
    Graph, a PreparedGraph or a Prenormalized operator, as ``ChebConv``
    takes them.  BatchNorm statistics are per *node*; ``train=True``
    normalizes by the batch statistics and moves the running ones.
    """

    def __init__(self, num_nodes: int, in_channels: int,
                 hidden_channels: int, out_channels: int, kernel_size: int,
                 K: int, normalization: str = "sym", use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.temporal_conv1 = TemporalConv(
            in_channels, hidden_channels, kernel_size, device, generator)
        self.graph_conv = ChebConv(
            hidden_channels, hidden_channels, K, normalization, use_bias,
            device=device, generator=generator)
        self.temporal_conv2 = TemporalConv(
            hidden_channels, out_channels, kernel_size, device, generator)
        # per-node batch norm: feature axis = node axis (2)
        self.batch_norm = BatchNorm(num_nodes, device=device, axis=2)

    def forward(self, x: torch.Tensor, graph, lambda_max=None,
                train: bool = False) -> torch.Tensor:
        check_rank(x, "STConv", "(B, T, N, C)", 4)
        check_node_axis(x, graph, "STConv", "(B, T, N, C)", axis=2)
        t0 = self.temporal_conv1(x)
        t = torch.relu(self.graph_conv(t0, graph, lambda_max))
        t = self.temporal_conv2(t)
        return self.batch_norm(t, train)
