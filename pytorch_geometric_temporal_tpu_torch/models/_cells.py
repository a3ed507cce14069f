"""The parameter initializers and loaders shared by the models, and the
counterparts of the flax building blocks the JAX package's models use:
``Dense``, ``Conv``, ``GRUCell``, ``OptimizedLSTMCell``, ``BatchNorm``,
``LayerNorm``, ``Embed``, ``Dropout``.

Each keeps flax's parameter names, the ``(in, out)`` kernel layout, flax's
gate equations and its default initial distributions (lecun-normal kernels,
zero biases, orthogonal recurrent kernels), so that a flax parameter tree
maps onto ``named_parameters()`` path by path: :func:`load_flax` is the one
loader behind every ``params_from_flax``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .._device import resolve_device


def glorot(shape, generator=None, device=None,
           dtype=torch.float32) -> torch.Tensor:
    """Glorot/Xavier uniform, flax's ``glorot_uniform``: U(±sqrt(6/(fan_in +
    fan_out))) with the last two axes as (in, out) and any leading axes
    counted into both fans.  Drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``), so a seed gives the same weights on any device."""
    field = math.prod(shape[:-2])
    limit = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * field))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return ((2.0 * u - 1.0) * limit).to(device=device, dtype=dtype)


def zeros(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, device=device, dtype=dtype)


def load_param(param: torch.Tensor, value) -> None:
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


def lecun_normal(shape, generator=None, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """flax's default kernel initializer: a normal truncated at ±2 standard
    deviations, scaled to variance 1/fan_in (a conv kernel's leading axes,
    its receptive field, count into the fan).  Drawn on the CPU from
    ``generator`` by inverting the normal CDF."""
    fan_in = shape[-2] * math.prod(shape[:-2])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    u = (lo + u * (1.0 - 2.0 * lo)).clamp(1e-12, 1.0 - 1e-12)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (x * std).to(device=device, dtype=dtype)


def uniform(shape, generator=None, device=None,
            dtype=torch.float32) -> torch.Tensor:
    """flax's ``uniform(scale=1.0)``: U[0, 1)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return u.to(device=device, dtype=dtype)


def _normal(shape, variance, generator, device, dtype):
    x = torch.randn(shape, generator=generator, dtype=torch.float64)
    return (x * math.sqrt(variance)).to(device=device, dtype=dtype)


def kaiming_normal(shape, generator=None, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """flax's ``kaiming_normal``: N(0, 2/fan_in), not truncated; leading
    axes count into the fan."""
    fan_in = shape[-2] * math.prod(shape[:-2])
    return _normal(shape, 2.0 / fan_in, generator, device, dtype)


def xavier_normal(shape, generator=None, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """flax's ``xavier_normal``: N(0, 2/(fan_in + fan_out)), not truncated;
    leading axes count into both fans."""
    fans = (shape[-2] + shape[-1]) * math.prod(shape[:-2])
    return _normal(shape, 2.0 / fans, generator, device, dtype)


def embed_normal(shape, generator=None, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """flax's default embedding initializer: N(0, 1/features)."""
    return _normal(shape, 1.0 / shape[-1], generator, device, dtype)


def orthogonal(shape, generator=None, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """flax's ``orthogonal`` initializer for a 2-D kernel: Q of the QR
    decomposition of a normal matrix, columns signed by R's diagonal."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.to(device=device, dtype=dtype)


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if hasattr(value, "items"):
            out.update(_flatten(value, path + "."))
        else:
            out[path] = value
    return out


def load_flax(module: nn.Module, tree) -> nn.Module:
    """Load a flax variable tree (numpy leaves) into ``module``: the
    ``params`` collection into the parameters and, when present, the
    ``batch_stats`` collection into the buffers, each matched by its path
    (flax's ``a/b/kernel`` is ``a.b.kernel`` here).  Raises when the two
    sets of names differ."""
    pairs = [(dict(module.named_parameters()), _flatten(flax_params(tree)))]
    if "batch_stats" in tree:
        pairs.append((dict(module.named_buffers()),
                      _flatten(tree["batch_stats"])))
    for mine, theirs in pairs:
        if set(mine) != set(theirs):
            raise ValueError(
                f"parameter names differ: only here "
                f"{sorted(set(mine) - set(theirs))}, only in the tree "
                f"{sorted(set(theirs) - set(mine))}")
        for name, value in mine.items():
            load_param(value, theirs[name])
    return module


class FlaxModule(nn.Module):
    """A module whose parameter paths are its flax counterpart's."""

    def params_from_flax(self, tree):
        return load_flax(self, tree)


class Dense(FlaxModule):
    """flax ``nn.Dense``: ``x @ kernel (+ bias)``, kernel (in, out)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, kernel_init=lecun_normal,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.kernel = nn.Parameter(
            kernel_init((in_features, features), generator, device))
        self.bias = (nn.Parameter(zeros((features,), device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.kernel.to(x.dtype)
        return out if self.bias is None else out + self.bias.to(x.dtype)


class GRUCell(FlaxModule):
    """flax ``nn.GRUCell``: forward ``(carry, inputs) -> (new, new)``.

    r = σ(ir(x) + hr(h)), z = σ(iz(x) + hz(h)), n = tanh(in(x) + r·hn(h)),
    h' = (1 − z)·n + z·h; the input layers and ``hn`` carry a bias, ``hr``
    and ``hz`` none.
    """

    def __init__(self, in_features: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for gate in "rzn":
            self.add_module("i" + gate, Dense(
                in_features, features, True, lecun_normal, device, generator))
            self.add_module("h" + gate, Dense(
                features, features, gate == "n", orthogonal, device,
                generator))

    def forward(self, carry: torch.Tensor, inputs: torch.Tensor):
        h, m = carry, self._modules
        r = torch.sigmoid(m["ir"](inputs) + m["hr"](h))
        z = torch.sigmoid(m["iz"](inputs) + m["hz"](h))
        n = torch.tanh(m["in"](inputs) + r * m["hn"](h))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class LSTMCell(FlaxModule):
    """flax ``nn.OptimizedLSTMCell``: forward ``((c, h), inputs) ->
    ((c', h'), h')``; input kernels ``ii, if, ig, io`` without bias,
    recurrent kernels ``hi, hf, hg, ho`` with one."""

    def __init__(self, in_features: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for gate in "ifgo":
            self.add_module("i" + gate, Dense(
                in_features, features, False, lecun_normal, device,
                generator))
            self.add_module("h" + gate, Dense(
                features, features, True, orthogonal, device, generator))

    def forward(self, carry, inputs: torch.Tensor):
        c, h = carry
        m = self._modules

        def gate(name):
            return m["h" + name](h) + m["i" + name](inputs)

        i = torch.sigmoid(gate("i"))
        f = torch.sigmoid(gate("f"))
        g = torch.tanh(gate("g"))
        o = torch.sigmoid(gate("o"))
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class BatchNorm(FlaxModule):
    """flax ``nn.BatchNorm``: statistics over every axis but ``axis`` (the
    last by default), ``momentum`` the share the running value keeps (flax's
    default 0.99), eps 1e-5, biased variance both in the normalization and
    in the running statistics (buffers ``mean`` and ``var``, flax's
    ``batch_stats``).  ``scale_init`` is the constant the scale starts at."""

    epsilon = 1e-5      # flax's default

    def __init__(self, features: int, device=None, axis: int = -1,
                 momentum: float = 0.99, scale_init: float = 1.0):
        super().__init__()
        device = resolve_device(device)
        self.axis, self.momentum = axis, momentum
        self.scale = nn.Parameter(
            torch.full((features,), float(scale_init), device=device))
        self.bias = nn.Parameter(zeros((features,), device))
        self.register_buffer("mean", zeros((features,), device))
        self.register_buffer("var", torch.ones((features,), device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        axis = self.axis % x.dim()
        if train:
            axes = tuple(a for a in range(x.dim()) if a != axis)
            mean = x.mean(axes)
            # flax's fast variance: E[x²] − E[x]², clipped at 0
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1.0 - m) * mean)
                self.var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        shape = [1] * x.dim()
        shape[axis] = -1
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x - mean.reshape(shape)) * mul.reshape(shape)
                + self.bias.reshape(shape))


def _per_axis(value, nd: int):
    return (value,) * nd if isinstance(value, int) else tuple(value)


class Conv(FlaxModule):
    """flax ``nn.Conv`` on channel-last input ``(B, *spatial, C)``: kernel
    ``(*kernel_size, in, out)`` (one or two spatial axes), ``strides``,
    ``kernel_dilation``, and ``padding`` as ``"VALID"``, ``"SAME"`` or a
    (low, high) pair per spatial axis."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides=1,
                 padding: Union[str, Sequence] = "SAME", kernel_dilation=1,
                 use_bias: bool = True, kernel_init=lecun_normal,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        nd = len(kernel_size)
        if nd not in (1, 2):
            raise ValueError(f"Conv takes 1 or 2 spatial axes, got {nd}")
        self.strides = _per_axis(strides, nd)
        self.dilation = _per_axis(kernel_dilation, nd)
        self.padding = (padding if isinstance(padding, str)
                        else tuple(tuple(p) for p in padding))
        self.kernel = nn.Parameter(kernel_init(
            tuple(kernel_size) + (in_features, features), generator, device))
        self.bias = (nn.Parameter(zeros((features,), device))
                     if use_bias else None)

    def _pads(self, spatial):
        if self.padding == "VALID":
            return [(0, 0)] * len(spatial)
        if self.padding == "SAME":
            pads = []
            for size, k, s, d in zip(spatial, self.kernel.shape, self.strides,
                                     self.dilation):
                total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size,
                            0)
                pads.append((total // 2, total - total // 2))
            return pads
        return list(self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = self.kernel.dim() - 2
        if x.dim() != nd + 2:
            raise ValueError(
                f"Conv with a {nd}-d kernel expects (B, *spatial, C) of rank "
                f"{nd + 2}; got shape {tuple(x.shape)}")
        x = x.movedim(-1, 1)
        pads = self._pads(x.shape[2:])
        if any(p != (0, 0) for p in pads):
            # F.pad lists the last axis first
            x = torch.nn.functional.pad(
                x, [v for lo_hi in reversed(pads) for v in lo_hi])
        weight = self.kernel.to(x.dtype).permute(
            nd + 1, nd, *range(nd))         # (out, in, *kernel_size)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        conv = (torch.nn.functional.conv1d if nd == 1
                else torch.nn.functional.conv2d)
        out = conv(x, weight, bias, stride=self.strides,
                   dilation=self.dilation)
        return out.movedim(1, -1)


class LayerNorm(FlaxModule):
    """flax ``nn.LayerNorm`` over the last axis: eps 1e-6 (torch's default
    is 1e-5), biased variance computed as E[x²] − E[x]² clipped at 0."""

    def __init__(self, features: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        device = resolve_device(device)
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones((features,), device=device))
        self.bias = nn.Parameter(zeros((features,), device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return ((x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale)
                + self.bias)


class Embed(FlaxModule):
    """flax ``nn.Embed``: a lookup into ``embedding`` (num, features)."""

    def __init__(self, num_embeddings: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.embedding = nn.Parameter(
            embed_normal((num_embeddings, features), generator, device))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding[idx]


class Dropout(nn.Module):
    """flax ``nn.Dropout``: identity unless ``train``; else each entry is
    kept with probability ``1 − rate`` and scaled by ``1/(1 − rate)``.  The
    mask is drawn from ``generator`` on the generator's device (``x``'s
    device when None) — every draw is the caller's to seed."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        device = x.device if generator is None else generator.device
        mask = torch.rand(x.shape, generator=generator, device=device) < keep
        return x * (mask.to(x.device, x.dtype) / keep)
