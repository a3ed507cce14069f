"""Graph convolution primitives over the spmm core, and the parameter
initializers shared by the models (flax's defaults).

Port of the Chebyshev and GCN layers of the JAX package's
``models/conv.py``.  The Chebyshev basis is stacked on the feature axis and
applied with a single ``(N, K·C_in) @ (K·C_in, C_out)`` matmul; parameters
keep the flax layout ``(in, out)``, so ``params_from_flax`` is a copy.
All layers accept leading batch dims ``(..., N, F)``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..ops.graph import cheb_norm, gcn_norm
from ..ops.operators import Prenormalized
from ..ops.spmm import spmm
from ._validate import check_node_axis


def glorot(shape, generator=None, device=None,
           dtype=torch.float32) -> torch.Tensor:
    """Glorot/Xavier uniform for an (in, out) weight: U(±sqrt(6/(in+out))),
    flax's ``glorot_uniform``.  Drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``), so a seed gives the same weights on any device."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return ((2.0 * u - 1.0) * limit).to(device=device, dtype=dtype)


def zeros(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, device=device, dtype=dtype)


def load_param(param: nn.Parameter, value) -> None:
    """Copy a numpy array of the same shape into ``param``."""
    value = torch.from_numpy(np.array(value, np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not match the "
                         f"parameter's {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value.to(param.device, param.dtype))


def flax_params(tree):
    """The ``params`` collection of a flax variable tree (or the tree)."""
    return tree["params"] if "params" in tree else tree


def load_linear(linear: nn.Linear, tree) -> nn.Linear:
    """Load a flax ``Dense`` (``kernel`` (in, out), ``bias``) into an
    ``nn.Linear``, whose weight is (out, in)."""
    p = flax_params(tree)
    load_param(linear.weight, np.asarray(p["kernel"]).T)
    if linear.bias is not None:
        load_param(linear.bias, p["bias"])
    return linear


def cat_features(terms) -> torch.Tensor:
    """Concatenate basis terms on the feature axis in their promoted dtype
    (aggregations through the BCSR kernel come back f32)."""
    dtype = terms[0].dtype
    for t in terms[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.to(dtype) for t in terms], dim=-1)


def cheb_basis(graph, x: torch.Tensor, K: int, normalization: str = "sym",
               lambda_max=None) -> torch.Tensor:
    """Stacked Chebyshev basis [T_0(L̂)x … T_{K-1}(L̂)x] on the feature axis.

    T_0 = x, T_1 = L̂x, T_k = 2 L̂ T_{k-1} − T_{k-2} with
    L̂ = 2L/λ_max − I (PyG ``ChebConv.__norm__`` semantics).
    Returns (..., N, K·F).

    ``graph`` may also be a :class:`~..ops.operators.Prenormalized` wrapper
    (from :func:`~..ops.operators.prenormalize_cheb`): the norm rebuild is
    skipped and the wrapped operator (Graph or BCSRMatrix) is applied
    directly — the large-graph path.
    """
    check_node_axis(x, graph, "ChebConv/cheb_basis", "(..., N, F)")
    if isinstance(graph, Prenormalized):
        lhat = graph.op
    else:
        lhat = cheb_norm(graph, normalization, lambda_max)
    tx = [x]
    if K > 1:
        tx.append(spmm(lhat, x))
    for _ in range(2, K):
        tx.append(2.0 * spmm(lhat, tx[-1]) - tx[-2])
    return cat_features(tx)


class ChebConv(nn.Module):
    """Chebyshev spectral graph convolution (replaces PyG ``ChebConv``):
    ``cheb_basis(graph, x, K) @ weight (+ bias)``."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 normalization: str = "sym", use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.K = K
        self.normalization = normalization
        self.weight = nn.Parameter(
            glorot((K * in_channels, out_channels), generator, device))
        self.bias = (nn.Parameter(zeros((out_channels,), device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, graph, lambda_max=None):
        z = cheb_basis(graph, x, self.K, self.normalization, lambda_max)
        out = (z @ self.weight.to(z.dtype)).to(x.dtype)
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)
        return out

    def params_from_flax(self, tree) -> "ChebConv":
        p = flax_params(tree)
        load_param(self.weight, p["weight"])
        if self.bias is not None:
            load_param(self.bias, p["bias"])
        return self


def gcn_conv_fixed_w(x, graph, weight, *, improved: bool = False,
                     add_self_loops: bool = True, normalize: bool = True):
    """GCN conv whose weight is supplied per call (EvolveGCN, where a GRU
    evolves the conv weight itself)."""
    g = gcn_norm(graph, improved, add_self_loops) if normalize else graph
    return spmm(g, x @ weight.to(x.dtype)).to(x.dtype)


class GCNConv(nn.Module):
    """Kipf-Welling GCN convolution (replaces PyG ``GCNConv`` +
    ``gcn_norm``).

    ``normalize=False`` skips the normalization when the caller provides an
    already-normalized operator (from
    :func:`~..ops.operators.prenormalize_gcn`).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 improved: bool = False, add_self_loops: bool = True,
                 normalize: bool = True, use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.improved = improved
        self.add_self_loops = add_self_loops
        self.normalize = normalize
        self.weight = nn.Parameter(
            glorot((in_channels, out_channels), generator, device))
        self.bias = (nn.Parameter(zeros((out_channels,), device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        check_node_axis(x, graph, "GCNConv", "(..., N, F)")
        out = gcn_conv_fixed_w(
            x, graph, self.weight, improved=self.improved,
            add_self_loops=self.add_self_loops, normalize=self.normalize)
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)
        return out

    def params_from_flax(self, tree) -> "GCNConv":
        p = flax_params(tree)
        load_param(self.weight, p["weight"])
        if self.bias is not None:
            load_param(self.bias, p["bias"])
        return self
