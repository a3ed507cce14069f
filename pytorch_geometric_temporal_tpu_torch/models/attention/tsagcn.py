"""2s-AGCN: two-stream adaptive graph convolutional network (skeleton
actions).

Port of the JAX package's ``models/attention/tsagcn.py``: ``GraphAAGCN``,
``UnitTCN``, ``UnitGCN`` with the adaptive data-dependent affinity and the
spatial / temporal / channel attention stages, ``AAGCN``.

Public I/O layout: (B, C, T, V); internally channel-last (B, T, V, C).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..._device import resolve_device
from .._cells import (BatchNorm, Conv, Dense, FlaxModule, kaiming_normal,
                      xavier_normal, zeros)


def _zeros_init(shape, generator=None, device=None):
    return zeros(shape, device)


class GraphAAGCN:
    """Stacked (3, V, V) adjacency ``A``: [I, col-normalized A,
    col-normalized Aᵀ], each column of unit L1 mass."""

    def __init__(self, edge_index, num_nodes: int, device=None):
        self.num_nodes = num_nodes
        ei = np.asarray(edge_index)
        a = np.zeros((num_nodes, num_nodes), dtype=np.float32)
        a[ei[0], ei[1]] = 1.0

        def col_norm(m):
            s = m.sum(0, keepdims=True)
            return m / np.where(s == 0, 1.0, s)

        self.A = torch.from_numpy(
            np.stack([np.eye(num_nodes, dtype=np.float32), col_norm(a),
                      col_norm(a.T)])).to(resolve_device(device))


class UnitTCN(FlaxModule):
    """(k, 1) conv over time + BatchNorm.  Layout (B, T, V, C)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv = Conv(in_channels, out_channels, (kernel_size, 1),
                         strides=(stride, 1), padding=((pad, pad), (0, 0)),
                         kernel_init=kaiming_normal, device=device,
                         generator=generator)
        self.bn = BatchNorm(out_channels, device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(self.conv(x), train)


class UnitGCN(FlaxModule):
    """Adaptive multi-subset graph conv with optional attention stages.

    Layout (B, T, V, C).  ``a`` is the (3, V, V) GraphAAGCN stack: the
    adaptive form starts its ``PA`` parameter from it, the fixed form
    multiplies by the stack given to ``forward``.
    """

    def __init__(self, in_channels: int, out_channels: int, a,
                 coff_embedding: int = 4, num_subset: int = 3,
                 adaptive: bool = True, attention: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.out_channels, self.num_subset = out_channels, num_subset
        self.adaptive, self.attention = adaptive, attention
        inter_c = out_channels // coff_embedding
        a = torch.as_tensor(a, dtype=torch.float32)
        V = a.shape[-1]

        def dense(cin, cout, init=None):
            kw = {} if init is None else {"kernel_init": init}
            return Dense(cin, cout, device=device, generator=generator, **kw)

        if adaptive:
            self.PA = nn.Parameter(a.detach().clone().to(device))
            self.alpha = nn.Parameter(zeros((1,), device))
            for i in range(num_subset):
                self.add_module(f"conv_a_{i}", dense(in_channels, inter_c))
                self.add_module(f"conv_b_{i}", dense(in_channels, inter_c))
        for i in range(num_subset):
            self.add_module(f"conv_d_{i}", dense(in_channels, out_channels))
        self.bn = BatchNorm(out_channels, device, scale_init=1e-6)
        if in_channels != out_channels:
            self.down_conv = dense(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels, device)
        if attention:
            ker_jpt = V - 1 if V % 2 == 0 else V
            pad_j = (ker_jpt - 1) // 2
            self.conv_sa = Conv(out_channels, 1, (ker_jpt,),
                                padding=((pad_j, pad_j),),
                                kernel_init=xavier_normal, device=device,
                                generator=generator)
            self.conv_ta = Conv(out_channels, 1, (9,), padding=((4, 4),),
                                kernel_init=_zeros_init, device=device,
                                generator=generator)
            self.fc1c = dense(out_channels, out_channels // 2, kaiming_normal)
            self.fc2c = dense(out_channels // 2, out_channels, _zeros_init)

    def forward(self, x: torch.Tensor, a: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        B, T, V, C = x.shape
        y = 0.0
        for i in range(self.num_subset):
            if self.adaptive:
                a1 = getattr(self, f"conv_a_{i}")(x)  # (B, T, V, ic)
                a2 = getattr(self, f"conv_b_{i}")(x)
                a1 = a1.permute(0, 2, 1, 3).reshape(B, V, -1)
                a2 = a2.permute(0, 1, 3, 2).reshape(B, -1, V)
                aff = torch.tanh(a1 @ a2 / a1.shape[-1])  # (B, V, V)
                a_eff = self.PA[i][None] + aff * self.alpha
                z = torch.einsum("btwc,bwv->btvc", x, a_eff)
            else:
                z = torch.einsum("btwc,wv->btvc", x, a[i])
            y = y + getattr(self, f"conv_d_{i}")(z)
        y = self.bn(y, train)
        down = x
        if C != self.out_channels:
            down = self.down_bn(self.down_conv(x), train)
        y = torch.relu(y + down)

        if self.attention:
            # spatial attention (conv over the node axis)
            se1 = torch.sigmoid(self.conv_sa(y.mean(dim=1)))  # (B, V, 1)
            y = y * se1[:, None] + y
            # temporal attention
            se1 = torch.sigmoid(self.conv_ta(y.mean(dim=2)))  # (B, T, 1)
            y = y * se1[:, :, None] + y
            # channel attention (squeeze-excite)
            se1 = torch.relu(self.fc1c(y.mean(dim=(1, 2))))   # (B, C/2)
            se2 = torch.sigmoid(self.fc2c(se1))
            y = y * se2[:, None, None] + y
        return y


class AAGCN(FlaxModule):
    """forward: (X (B, C_in, T, V), train=False) -> (B, out_channels,
    T//stride, V)."""

    def __init__(self, in_channels: int, out_channels: int, edge_index,
                 num_nodes: int, stride: int = 1, residual: bool = True,
                 adaptive: bool = True, attention: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_nodes = num_nodes
        # a plain attribute, not a buffer: the buffers are flax's batch_stats
        self.A = GraphAAGCN(edge_index, num_nodes, device).A
        self.gcn1 = UnitGCN(in_channels, out_channels, self.A,
                            adaptive=adaptive, attention=attention,
                            device=device, generator=generator)
        self.tcn1 = UnitTCN(out_channels, out_channels, stride=stride,
                            device=device, generator=generator)
        self.residual = residual
        self.residual_tcn = None
        if residual and not (in_channels == out_channels and stride == 1):
            self.residual_tcn = UnitTCN(in_channels, out_channels,
                                        kernel_size=1, stride=stride,
                                        device=device, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != self.num_nodes:
            raise ValueError(
                f"AAGCN expects X (B, C_in, T, V={self.num_nodes}); got "
                f"shape {tuple(x.shape)}."
            )
        x = x.movedim(1, -1)  # (B, T, V, C)
        out = self.tcn1(self.gcn1(x, self.A, train), train)
        if not self.residual:
            res = 0.0
        elif self.residual_tcn is None:
            res = x
        else:
            res = self.residual_tcn(x, train)
        return torch.relu(out + res).movedim(-1, 1)
