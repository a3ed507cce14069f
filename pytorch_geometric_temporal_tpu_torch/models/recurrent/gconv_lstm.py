"""Chebyshev graph-convolutional LSTM (GConvLSTM) with peephole connections
(Seo et al., arXiv 1612.07659).

Port of the JAX package's ``models/recurrent/gconv_lstm.py``.  Gate math:

    I = σ(Cheb(X)W_xi + Cheb(H)W_hi + w_ci ⊙ C + b_i)
    F = σ(Cheb(X)W_xf + Cheb(H)W_hf + w_cf ⊙ C + b_f)
    C' = F⊙C + I⊙tanh(Cheb(X)W_xc + Cheb(H)W_hc + b_c)
    O = σ(Cheb(X)W_xo + Cheb(H)W_ho + w_co ⊙ C' + b_o)
    H' = O ⊙ tanh(C')

One Chebyshev basis per source (X, H) feeds all four gates.  Parameters
keep the flax names: ``w_x*``/``w_h*`` (K·in, C), ``b_conv_*`` (C,),
peepholes ``w_c*`` (1, C) and gate biases ``b_*`` (1, C).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..._device import resolve_device
from .._cells import FlaxModule, glorot, zeros
from ..conv import cheb_basis


class GConvLSTM(FlaxModule):
    """forward: (X, graph, H=None, C=None, lambda_max=None) -> (H, C)."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 normalization: str = "sym", use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        C = self.out_channels = out_channels
        self.K, self.normalization, self.use_bias = K, normalization, use_bias
        for gate in "ifco":
            setattr(self, f"w_x{gate}", nn.Parameter(
                glorot((K * in_channels, C), generator, device)))
            setattr(self, f"w_h{gate}", nn.Parameter(
                glorot((K * C, C), generator, device)))
            if use_bias:
                setattr(self, f"b_conv_{gate}",
                        nn.Parameter(zeros((C,), device)))
            if gate != "c":
                setattr(self, f"w_c{gate}", nn.Parameter(
                    glorot((1, C), generator, device)))
            setattr(self, f"b_{gate}", nn.Parameter(zeros((1, C), device)))

    def forward(self, x: torch.Tensor, graph,
                h: Optional[torch.Tensor] = None,
                c: Optional[torch.Tensor] = None, lambda_max=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if h is None:
            h = x.new_zeros(x.shape[:-1] + (self.out_channels,))
        if c is None:
            c = x.new_zeros(x.shape[:-1] + (self.out_channels,))
        bx = cheb_basis(graph, x, self.K, self.normalization, lambda_max)
        bh = cheb_basis(graph, h, self.K, self.normalization, lambda_max)

        def conv_pair(name):
            out = (bx @ getattr(self, f"w_x{name}").to(bx.dtype)
                   + bh @ getattr(self, f"w_h{name}").to(bh.dtype))
            if self.use_bias:
                out = out + getattr(self, f"b_conv_{name}")
            return out.to(x.dtype) + getattr(self, f"b_{name}")

        i = torch.sigmoid(conv_pair("i") + self.w_ci * c)
        f = torch.sigmoid(conv_pair("f") + self.w_cf * c)
        c_new = f * c + i * torch.tanh(conv_pair("c"))
        o = torch.sigmoid(conv_pair("o") + self.w_co * c_new)
        return o * torch.tanh(c_new), c_new
