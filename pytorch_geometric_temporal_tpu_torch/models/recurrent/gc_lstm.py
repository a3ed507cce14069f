"""GC-LSTM: graph convolution embedded LSTM for dynamic link prediction
(Chen et al., arXiv 1812.04206).

Port of the JAX package's ``models/recurrent/gc_lstm.py``: X enters each
gate through a dense matmul ``W_*``, only the hidden state H is
graph-convolved (Chebyshev basis, ``w_conv_*``); biases ``b_conv_*`` (C,)
and ``b_*`` (1, C) keep the flax names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..._device import resolve_device
from .._cells import FlaxModule, glorot, zeros
from ..conv import cheb_basis


class GCLSTM(FlaxModule):
    """forward: (X, graph, H=None, C=None, lambda_max=None) -> (H, C)."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 normalization: str = "sym", use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        C = self.out_channels = out_channels
        self.K, self.normalization, self.use_bias = K, normalization, use_bias
        for gate in "ifco":
            setattr(self, f"W_{gate}", nn.Parameter(
                glorot((in_channels, C), generator, device)))
            setattr(self, f"w_conv_{gate}", nn.Parameter(
                glorot((K * C, C), generator, device)))
            if use_bias:
                setattr(self, f"b_conv_{gate}",
                        nn.Parameter(zeros((C,), device)))
            setattr(self, f"b_{gate}", nn.Parameter(zeros((1, C), device)))

    def forward(self, x: torch.Tensor, graph,
                h: Optional[torch.Tensor] = None,
                c: Optional[torch.Tensor] = None, lambda_max=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if h is None:
            h = x.new_zeros(x.shape[:-1] + (self.out_channels,))
        if c is None:
            c = x.new_zeros(x.shape[:-1] + (self.out_channels,))
        bh = cheb_basis(graph, h, self.K, self.normalization, lambda_max)

        def gate(name):
            out = (x @ getattr(self, f"W_{name}").to(x.dtype)
                   + (bh @ getattr(self, f"w_conv_{name}").to(bh.dtype)
                      ).to(x.dtype))
            if self.use_bias:
                out = out + getattr(self, f"b_conv_{name}")
            return out + getattr(self, f"b_{name}")

        i = torch.sigmoid(gate("i"))
        f = torch.sigmoid(gate("f"))
        c_new = f * c + i * torch.tanh(gate("c"))
        o = torch.sigmoid(gate("o"))
        return o * torch.tanh(c_new), c_new
