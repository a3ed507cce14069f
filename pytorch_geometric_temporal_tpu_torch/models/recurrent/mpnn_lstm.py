"""MPNN-LSTM for pandemic forecasting (Panagopoulos et al., arXiv
2009.08388).

Port of the JAX package's ``models/recurrent/mpnn_lstm.py``.  Input X is
(window·N, F) with the window folded into the node axis; output is
(N·B, 2·hidden + in_channels + window − 1).  The two ``BatchNorm``s keep
running statistics in buffers (flax's ``batch_stats``); pass ``train=True``
during training: batch statistics normalize and update the buffers, and
dropout is on.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._cells import BatchNorm, FlaxModule, LSTMCell
from ..conv import GCNConv


class MPNNLSTM(FlaxModule):
    """forward: (X (window·N, F), graph, train=False) -> (N, 2·hidden + F +
    window − 1)."""

    def __init__(self, in_channels: int, hidden_size: int, num_nodes: int,
                 window: int, dropout: float = 0.5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size, self.num_nodes, self.window, self.dropout = (
            hidden_size, num_nodes, window, dropout)
        self.conv_1 = GCNConv(in_channels, hidden_size, device=device,
                              generator=generator)
        self.conv_2 = GCNConv(hidden_size, hidden_size, device=device,
                              generator=generator)
        self.bn_1 = BatchNorm(hidden_size, device=device)
        self.bn_2 = BatchNorm(hidden_size, device=device)
        self.lstm_1 = LSTMCell(2 * hidden_size, hidden_size, device=device,
                               generator=generator)
        self.lstm_2 = LSTMCell(hidden_size, hidden_size, device=device,
                               generator=generator)

    def forward(self, x: torch.Tensor, graph,
                train: bool = False) -> torch.Tensor:
        nhid, w, n = self.hidden_size, self.window, self.num_nodes
        in_ch = x.shape[-1]

        # skip connection S: full features of period 0 + last channel of
        # later periods
        s = x.reshape(-1, w, n, in_ch).transpose(1, 2).reshape(-1, w, in_ch)
        s = torch.cat([s[:, 0, :]] + [s[:, l, in_ch - 1:in_ch]
                                      for l in range(1, w)], dim=1)

        def gconv(conv, bn, h_in):
            out = bn(torch.relu(conv(h_in, graph)), train)
            return torch.nn.functional.dropout(out, self.dropout, train)

        h1 = gconv(self.conv_1, self.bn_1, x)
        h2 = gconv(self.conv_2, self.bn_2, h1)
        hcat = torch.cat([h1, h2], dim=-1)  # (w·N, 2·nhid)

        # the window comes back out as the LSTM time axis
        seq = hcat.reshape(-1, w, n, 2 * nhid).transpose(0, 1).reshape(
            w, -1, 2 * nhid)

        def run_lstm(cell, inputs, features):
            zero = inputs.new_zeros((inputs.shape[1], features))
            carry, outs = (zero, zero), []
            for t in range(inputs.shape[0]):
                carry, out = cell(carry, inputs[t])
                outs.append(out)
            return torch.stack(outs), carry[1]  # (w, B·N, C), final h

        seq1, h_1 = run_lstm(self.lstm_1, seq, nhid)
        _, h_2 = run_lstm(self.lstm_2, seq1, nhid)
        return torch.cat([h_1, h_2, s], dim=1)
