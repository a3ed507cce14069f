"""DNNTSP: deep neural network for temporal set prediction (Yu et al.,
KDD'20).

Port of the JAX package's ``models/attention/dnntsp.py``:
``MaskedSelfAttention``, ``GlobalGatedUpdater``, ``WeightedGCNBlock``,
``DNNTSP``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..._device import resolve_device
from .._cells import BatchNorm, Dense, Embed, FlaxModule, uniform
from ..conv import GCNConv


class MaskedSelfAttention(FlaxModule):
    """Causal multi-head self-attention over (B, L, F); the heads are
    concatenated (``"concat"``) or averaged (``"mean"``)."""

    def __init__(self, input_dim: int, output_dim: int, n_heads: int,
                 attention_aggregate: str = "mean", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attention_aggregate == "concat":
            self.d = output_dim // n_heads
        elif attention_aggregate == "mean":
            self.d = output_dim
        else:
            raise ValueError(
                f"wrong value for aggregate {attention_aggregate}"
            )
        self.n_heads, self.aggregate = n_heads, attention_aggregate
        for name in ("Wq", "Wk", "Wv"):
            self.add_module(name, Dense(input_dim, n_heads * self.d, False,
                                        device=device, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        h, d = self.n_heads, self.d
        q = self.Wq(x).reshape(B, L, h, d)
        k = self.Wk(x).reshape(B, L, h, d)
        v = self.Wv(x).reshape(B, L, h, d)
        att = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(d)
        causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        att = torch.where(causal, att, att.new_full((), float("-inf")))
        att = torch.softmax(att, dim=-1)
        out = torch.einsum("bhlm,bmhd->blhd", att, v)
        if self.aggregate == "concat":
            return out.reshape(B, L, h * d)
        return out.mean(dim=2)


class GlobalGatedUpdater(FlaxModule):
    """Gated blend of static item embeddings with dynamic node outputs."""

    def __init__(self, items_total: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.items_total = items_total
        self.alpha = nn.Parameter(
            uniform((items_total, 1), generator, resolve_device(device)))

    def forward(self, nodes_output: torch.Tensor,
                items_embedding: torch.Tensor) -> torch.Tensor:
        # nodes_output: (B·items, F) -> (B, items, F)
        batched = nodes_output.reshape(-1, self.items_total,
                                       nodes_output.shape[-1])
        return ((1.0 - self.alpha) * items_embedding[None]
                + self.alpha * batched)


class WeightedGCNBlock(FlaxModule):
    """Stack of GCNConv → BatchNorm → ReLU."""

    def __init__(self, in_features: int, hidden_sizes: Sequence[int],
                 out_features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        sizes = list(hidden_sizes) + [out_features]
        self.depth = len(sizes)
        for i, size in enumerate(sizes):
            self.add_module(f"gcn_{i}", GCNConv(in_features, size,
                                                device=device,
                                                generator=generator))
            self.add_module(f"bn_{i}", BatchNorm(size, device))
            in_features = size

    def forward(self, x: torch.Tensor, graph,
                train: bool = False) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"gcn_{i}")(x, graph)
            x = torch.relu(getattr(self, f"bn_{i}")(x, train))
        return x


class DNNTSP(FlaxModule):
    """forward: (X (T·items, F), graph, train=False) -> (T, items, F) with
    F = ``item_embedding_dim``."""

    def __init__(self, items_total: int, item_embedding_dim: int,
                 n_heads: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dim = item_embedding_dim
        self.items_total, self.dim = items_total, dim
        self.item_embedding = Embed(items_total, dim, device, generator)
        self.stacked_gcn = WeightedGCNBlock(dim, [dim], dim, device,
                                            generator)
        self.masked_self_attention = MaskedSelfAttention(
            dim, dim, n_heads, device=device, generator=generator)
        self.aggregate_Wq = Dense(dim, dim, False, device=device,
                                  generator=generator)
        self.global_gated_updater = GlobalGatedUpdater(items_total, device,
                                                       generator)

    def forward(self, x: torch.Tensor, graph,
                train: bool = False) -> torch.Tensor:
        h = self.stacked_gcn(x, graph, train)
        h = h.reshape(-1, self.items_total, self.dim)
        h = self.masked_self_attention(h)
        # per-step linear aggregation, flattened back to (T·items, F)
        h = self.aggregate_Wq(h).reshape(-1, self.dim)
        items = self.item_embedding.embedding
        return self.global_gated_updater(h, items)
