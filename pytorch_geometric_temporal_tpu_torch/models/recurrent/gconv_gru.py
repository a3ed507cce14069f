"""Chebyshev graph-convolutional GRU (GConvGRU; Seo et al., arXiv
1612.07659).

Port of the JAX package's ``models/recurrent/gconv_gru.py``: the six
per-gate ChebConvs are three stacked-basis matmuls — the Chebyshev basis
is computed once per input (X, H, H·R) and each gate is a single
``(N, K·F) @ (K·F, C)`` matmul.  Parameters keep the flax names and the
``(in, out)`` layout (``w_xz … w_hh``, ``b_z/b_r/b_h``), so
:meth:`GConvGRU.params_from_flax` is a copy.  Accepts (..., N, F).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..._device import resolve_device
from .._cells import FlaxModule, glorot, zeros
from ..conv import cheb_basis


class GConvGRU(FlaxModule):
    """forward: (X, graph, H=None, lambda_max=None) -> H.

    ``graph`` is a Graph (normalized per call, memoized on the graph) or a
    :class:`~...ops.operators.Prenormalized` operator — the large-graph
    path, where every basis hop is one aggregation through the BCSR
    kernel.
    """

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 normalization: str = "sym", use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.out_channels = out_channels
        self.K = K
        self.normalization = normalization
        for gate in "zrh":
            for src, width in (("x", in_channels), ("h", out_channels)):
                setattr(self, f"w_{src}{gate}", nn.Parameter(
                    glorot((K * width, out_channels), generator, device)))
            setattr(self, f"b_{gate}",
                    nn.Parameter(zeros((out_channels,), device))
                    if use_bias else None)

    def forward(self, x: torch.Tensor, graph,
                h: Optional[torch.Tensor] = None,
                lambda_max=None) -> torch.Tensor:
        if h is None:
            h = x.new_zeros(x.shape[:-1] + (self.out_channels,))

        def basis(v):
            return cheb_basis(graph, v, self.K, self.normalization,
                              lambda_max)

        def gate(name, bx_, bh_):
            out = (bx_ @ getattr(self, f"w_x{name}").to(bx_.dtype)
                   + bh_ @ getattr(self, f"w_h{name}").to(bh_.dtype))
            b = getattr(self, f"b_{name}")
            return (out if b is None else out + b).to(x.dtype)

        bx, bh = basis(x), basis(h)
        z = torch.sigmoid(gate("z", bx, bh))
        r = torch.sigmoid(gate("r", bx, bh))
        h_tilde = torch.tanh(gate("h", bx, basis(h * r)))
        return z * h + (1.0 - z) * h_tilde
