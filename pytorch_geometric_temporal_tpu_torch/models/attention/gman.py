"""GMAN: graph multi-attention network (Zheng et al., AAAI'20).

Port of the JAX package's ``models/attention/gman.py``: ``FullyConnected``
(Dense + BatchNorm stacks), ``SpatioTemporalEmbedding``,
``SpatialAttention``, ``TemporalAttention`` (causal mask filled with
−2¹⁵+1), ``GatedFusion``, ``SpatioTemporalAttention``,
``TransformAttention``, ``GMAN``.

Head-splitting preserves the upstream quirk of splitting the D = K·d
feature dim into chunks of *size K* (d heads of size K) while scaling by
√d.  The attention products are ``torch.einsum`` + ``torch.softmax`` (the
masking and scaling differ from ``scaled_dot_product_attention``'s).

All 1×1 "convs" are Dense layers; batch norm runs over the feature axis
with statistics across (B, T, N), its momentum ``1 − bn_decay``.  Pass
``train=True`` during training.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .._cells import BatchNorm, Dense, FlaxModule, glorot

relu = torch.relu


class FullyConnected(FlaxModule):
    """Stack of (Dense → BatchNorm → activation) blocks."""

    def __init__(self, input_dims: int, units: Sequence[int],
                 activations: Sequence[Optional[Callable]],
                 bn_decay: Optional[float] = None, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        momentum = 1.0 - (bn_decay if bn_decay is not None else 0.1)
        self.activations = list(activations)
        for i, unit in enumerate(units):
            self.add_module(f"dense_{i}", Dense(
                input_dims, unit, use_bias, glorot, device, generator))
            self.add_module(f"bn_{i}", BatchNorm(unit, device,
                                                 momentum=momentum))
            input_dims = unit

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i, act in enumerate(self.activations):
            x = getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x),
                                         train)
            if act is not None:
                x = act(x)
        return x


def _heads(x: torch.Tensor, K: int) -> torch.Tensor:
    """Split the last dim into chunks of size K (the upstream head
    quirk)."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // K, K))  # (..., h, K)


def _merge(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


class SpatioTemporalEmbedding(FlaxModule):
    def __init__(self, D: int, bn_decay: float, steps_per_day: int,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.steps_per_day = steps_per_day
        self.fc_se = FullyConnected(D, [D, D], [relu, None], bn_decay,
                                    use_bias, device, generator)
        self.fc_te = FullyConnected(7 + steps_per_day, [D, D], [relu, None],
                                    bn_decay, use_bias, device, generator)

    def forward(self, se, te, train: bool = False) -> torch.Tensor:
        """se: (N, D) spatial embedding; te: (B, T_his+T_pred, 2) int
        (day-of-week, time-of-day).  Returns (B, T, N, D)."""
        one_hot = torch.nn.functional.one_hot
        se = self.fc_se(se[None, None], train)  # (1, 1, N, D)
        te = te.long()
        dow = one_hot(te[..., 0] % 7, 7)
        tod = one_hot(te[..., 1] % self.steps_per_day, self.steps_per_day)
        te = torch.cat([dow, tod], dim=-1)[:, :, None, :].to(se.dtype)
        return se + self.fc_te(te, train)


class _QKV(FlaxModule):
    """The four one-layer stacks of an attention block: ``fc_q``, ``fc_k``,
    ``fc_v`` from ``in_dims`` and ``fc_out`` from D = K·d."""

    def __init__(self, in_dims: int, K: int, d: int, bn_decay: float,
                 device, generator):
        super().__init__()
        self.K, self.d = K, d
        for name, dims in (("fc_q", in_dims), ("fc_k", in_dims),
                           ("fc_v", in_dims), ("fc_out", K * d)):
            self.add_module(name, FullyConnected(
                dims, [K * d], [relu], bn_decay, True, device, generator))


class SpatialAttention(_QKV):
    def __init__(self, K: int, d: int, bn_decay: float, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(2 * K * d, K, d, bn_decay, device, generator)

    def forward(self, x, ste, train: bool = False) -> torch.Tensor:
        xs = torch.cat([x, ste], dim=-1)
        q = _heads(self.fc_q(xs, train), self.K)  # (B, T, N, h, K)
        k = _heads(self.fc_k(xs, train), self.K)
        v = _heads(self.fc_v(xs, train), self.K)
        att = torch.einsum("btnhk,btmhk->bthnm", q, k) / (self.d ** 0.5)
        att = torch.softmax(att, dim=-1)
        out = torch.einsum("bthnm,btmhk->btnhk", att, v)
        return self.fc_out(_merge(out), train)


class TemporalAttention(_QKV):
    def __init__(self, K: int, d: int, bn_decay: float, mask: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(2 * K * d, K, d, bn_decay, device, generator)
        self.mask = mask

    def forward(self, x, ste, train: bool = False) -> torch.Tensor:
        T = x.shape[1]
        xs = torch.cat([x, ste], dim=-1)
        q = _heads(self.fc_q(xs, train), self.K)  # (B, T, N, h, K)
        k = _heads(self.fc_k(xs, train), self.K)
        v = _heads(self.fc_v(xs, train), self.K)
        att = torch.einsum("btnhk,bsnhk->bhnts", q, k) / (self.d ** 0.5)
        if self.mask:
            causal = torch.ones((T, T), dtype=torch.bool,
                                device=x.device).tril()
            att = torch.where(causal, att,
                              att.new_full((), float(-(2 ** 15) + 1)))
        att = torch.softmax(att, dim=-1)
        out = torch.einsum("bhnts,bsnhk->btnhk", att, v)
        return self.fc_out(_merge(out), train)


class GatedFusion(FlaxModule):
    def __init__(self, D: int, bn_decay: float, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc_xs = FullyConnected(D, [D], [None], bn_decay, False, device,
                                    generator)
        self.fc_xt = FullyConnected(D, [D], [None], bn_decay, True, device,
                                    generator)
        self.fc_h = FullyConnected(D, [D, D], [relu, None], bn_decay, True,
                                   device, generator)

    def forward(self, hs, ht, train: bool = False) -> torch.Tensor:
        z = torch.sigmoid(self.fc_xs(hs, train) + self.fc_xt(ht, train))
        return self.fc_h(z * hs + (1.0 - z) * ht, train)


class SpatioTemporalAttention(FlaxModule):
    def __init__(self, K: int, d: int, bn_decay: float, mask: bool,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spatial = SpatialAttention(K, d, bn_decay, device, generator)
        self.temporal = TemporalAttention(K, d, bn_decay, mask, device,
                                          generator)
        self.fusion = GatedFusion(K * d, bn_decay, device, generator)

    def forward(self, x, ste, train: bool = False) -> torch.Tensor:
        hs = self.spatial(x, ste, train)
        ht = self.temporal(x, ste, train)
        return x + self.fusion(hs, ht, train)


class TransformAttention(_QKV):
    def __init__(self, K: int, d: int, bn_decay: float, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(K * d, K, d, bn_decay, device, generator)

    def forward(self, x, ste_his, ste_pred,
                train: bool = False) -> torch.Tensor:
        q = _heads(self.fc_q(ste_pred, train), self.K)  # (B, P, N, h, K)
        k = _heads(self.fc_k(ste_his, train), self.K)   # (B, H, N, h, K)
        v = _heads(self.fc_v(x, train), self.K)
        att = torch.einsum("bpnhk,bsnhk->bhnps", q, k) / (self.d ** 0.5)
        att = torch.softmax(att, dim=-1)
        out = torch.einsum("bhnps,bsnhk->bpnhk", att, v)
        return self.fc_out(_merge(out), train)


class GMAN(FlaxModule):
    """forward: (X (B, num_his, N), SE (N, K·d), TE (B, num_his+num_pred, 2),
    train=False) -> (B, num_pred, N)."""

    def __init__(self, L: int, K: int, d: int, num_his: int, bn_decay: float,
                 steps_per_day: int, use_bias: bool = True, mask: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        D = K * d
        self.L, self.K, self.d, self.num_his = L, K, d, num_his
        self.fc_in = FullyConnected(1, [D, D], [relu, None], bn_decay, True,
                                    device, generator)
        self.st_embedding = SpatioTemporalEmbedding(
            D, bn_decay, steps_per_day, use_bias, device, generator)
        for i in range(L):
            self.add_module(f"enc_{i}", SpatioTemporalAttention(
                K, d, bn_decay, mask, device, generator))
        self.transform = TransformAttention(K, d, bn_decay, device, generator)
        for i in range(L):
            self.add_module(f"dec_{i}", SpatioTemporalAttention(
                K, d, bn_decay, mask, device, generator))
        self.fc_out = FullyConnected(D, [D, 1], [relu, None], bn_decay, True,
                                     device, generator)

    def forward(self, x, se, te, train: bool = False) -> torch.Tensor:
        if x.dim() != 3 or x.shape[1] != self.num_his:
            raise ValueError(
                f"GMAN expects X (B, num_his={self.num_his}, N); got shape "
                f"{tuple(x.shape)}."
            )
        if se.shape[-1] != self.K * self.d or se.shape[0] != x.shape[2]:
            raise ValueError(
                f"GMAN expects SE (N={x.shape[2]}, K*d={self.K * self.d}); "
                f"got shape {tuple(se.shape)}."
            )
        if te.dim() != 3 or te.shape[-1] != 2 or te.shape[1] <= self.num_his:
            raise ValueError(
                "GMAN expects TE (B, num_his+num_pred, 2) of (day-of-week, "
                f"time-of-day) indices; got shape {tuple(te.shape)}."
            )
        x = self.fc_in(x[..., None], train)
        ste = self.st_embedding(se, te, train)
        ste_his = ste[:, :self.num_his]
        ste_pred = ste[:, self.num_his:]
        for i in range(self.L):
            x = getattr(self, f"enc_{i}")(x, ste_his, train)
        x = self.transform(x, ste_his, ste_pred, train)
        for i in range(self.L):
            x = getattr(self, f"dec_{i}")(x, ste_pred, train)
        return self.fc_out(x, train)[..., 0]
