"""DyGrEncoder: gated graph convolution + LSTM over node embeddings (IEEE
9073186).

Port of the JAX package's ``models/recurrent/dygrae.py``: a stack of LSTM
cells (``lstm_0`` …) with the (H, C) state carried explicitly by the
caller; state shapes are (L, N, C) — or (N, C) when ``lstm_num_layers ==
1``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._cells import FlaxModule, LSTMCell
from ..conv import GatedGraphConv


class DyGrEncoder(FlaxModule):
    """forward: (X, graph, H=None, C=None) -> (H_tilde, H, C)."""

    def __init__(self, conv_out_channels: int, conv_num_layers: int,
                 conv_aggr: str, lstm_out_channels: int,
                 lstm_num_layers: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_aggr = conv_aggr
        self.lstm_out_channels = lstm_out_channels
        self.lstm_num_layers = lstm_num_layers
        self.conv_layer = GatedGraphConv(
            conv_out_channels, conv_num_layers, conv_aggr, device=device,
            generator=generator)
        width = conv_out_channels
        for layer in range(lstm_num_layers):
            self.add_module(f"lstm_{layer}", LSTMCell(
                width, lstm_out_channels, device=device, generator=generator))
            width = lstm_out_channels

    def forward(self, x: torch.Tensor, graph,
                h: Optional[torch.Tensor] = None,
                c: Optional[torch.Tensor] = None):
        if self.conv_aggr not in ("mean", "add", "max"):
            raise ValueError("Wrong aggregator.")
        if (h is None) != (c is None):
            raise ValueError("Invalid hidden state and cell matrices.")
        h_tilde = self.conv_layer(x, graph)

        L = self.lstm_num_layers
        squeeze = False
        if h is None:
            h = x.new_zeros((L, x.shape[-2], self.lstm_out_channels))
            c = torch.zeros_like(h)
        elif h.dim() == 2:  # single-layer squeezed state
            squeeze = True
            h, c = h[None], c[None]
        hs, cs = [], []
        inp = h_tilde
        for layer in range(L):
            (c_new, h_new), inp = getattr(self, f"lstm_{layer}")(
                (c[layer], h[layer]), inp)
            hs.append(h_new)
            cs.append(c_new)
        h_out, c_out = torch.stack(hs), torch.stack(cs)
        if squeeze or L == 1:
            h_out, c_out = h_out[0], c_out[0]
        return inp, h_out, c_out
