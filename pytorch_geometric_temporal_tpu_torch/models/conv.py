"""Graph convolution primitives over the spmm core.

Port of the JAX package's ``models/conv.py``: ChebConv, GCNConv,
RGCNConv, SAGEConv, GatedGraphConv, top-k pooling and AGCRN's
embedding-parameterized AVWGCN.  The Chebyshev basis is stacked on the
feature axis and applied with a single ``(N, K·C_in) @ (K·C_in, C_out)``
matmul; parameters keep the flax names and the ``(in, out)`` layout, so
``params_from_flax`` is a copy.  All layers accept leading batch dims
``(..., N, F)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..ops.graph import cheb_norm, gcn_norm
from ..ops.operators import Prenormalized
from ..ops.spmm import spmm
from ._cells import (Dense, FlaxModule, GRUCell, flax_params, glorot,
                     load_param, zeros)
from ._validate import check_node_axis


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


class ChebConv(FlaxModule):
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


def gcn_conv_fixed_w(x, graph, weight, *, improved: bool = False,
                     add_self_loops: bool = True, normalize: bool = True):
    """GCN conv whose weight is supplied per call (EvolveGCN, where a GRU
    evolves the conv weight itself)."""
    g = gcn_norm(graph, improved, add_self_loops) if normalize else graph
    return spmm(g, x @ weight.to(x.dtype)).to(x.dtype)


class GCNConv(FlaxModule):
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


def _inv_degree(deg: torch.Tensor) -> torch.Tensor:
    """1/deg where deg > 0, else 0."""
    return torch.where(deg > 0, 1.0 / torch.where(deg > 0, deg,
                                                  torch.ones_like(deg)),
                       torch.zeros_like(deg))


class RGCNConv(FlaxModule):
    """Relational GCN with basis decomposition (replaces PyG ``RGCNConv``).

    Mean aggregation per relation + root transform, as LRGCN uses it.
    Relations are passed as a sequence of :class:`Graph` (one per
    relation, padded to a common edge count); the mean divides by the
    unweighted in-degree over real edges.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 num_relations: int, num_bases: Optional[int] = None,
                 root_weight: bool = True, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_relations = num_relations
        shape = (in_channels, out_channels)
        if num_bases is not None:
            self.basis = nn.Parameter(
                glorot((num_bases,) + shape, generator, device))
            self.coef = nn.Parameter(
                glorot((num_relations, num_bases), generator, device))
        else:
            self.weight = nn.Parameter(
                glorot((num_relations,) + shape, generator, device))
        self.root = (nn.Parameter(glorot(shape, generator, device))
                     if root_weight else None)
        self.bias = (nn.Parameter(zeros((out_channels,), device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, rel_graphs: Sequence) -> torch.Tensor:
        if len(rel_graphs) != self.num_relations:
            raise ValueError(
                f"expected {self.num_relations} relation graphs, got "
                f"{len(rel_graphs)}")
        if hasattr(self, "basis"):
            w = torch.einsum("rb,bio->rio", self.coef, self.basis)
        else:
            w = self.weight
        w = w.to(x.dtype)
        out = 0.0
        for r, g in enumerate(rel_graphs):
            inv = _inv_degree(g.in_degree(weighted=False)).to(x.dtype)
            agg = spmm(g, x, weights=g.edge_mask()).to(x.dtype)
            out = out + (agg * inv[:, None]) @ w[r]
        if self.root is not None:
            out = out + x @ self.root.to(x.dtype)
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)
        return out


class SAGEConv(FlaxModule):
    """GraphSAGE with mean aggregation (replaces PyG ``SAGEConv``):
    ``lin_l(mean of x over in-edges) + lin_r(x_dst)``.

    ``in_channels`` is one width, or a (source, destination) pair for
    bipartite (hetero) edges, whose destination features come in as
    ``x_dst``.  The mean divides by the unweighted in-degree over real
    edges; the aggregation always takes the segment path above the dense
    threshold (a per-call weight override), as in the JAX package.
    """

    def __init__(self, in_channels, out_channels: int,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        src, dst = (in_channels if isinstance(in_channels, (tuple, list))
                    else (in_channels, in_channels))
        self.lin_l = Dense(src, out_channels, use_bias, device=device,
                           generator=generator)
        self.lin_r = Dense(dst, out_channels, False, device=device,
                           generator=generator)

    def forward(self, x: torch.Tensor, graph, x_dst=None) -> torch.Tensor:
        if x_dst is None:
            x_dst = x
        inv = _inv_degree(graph.in_degree(weighted=False)).to(x.dtype)
        agg = spmm(graph, x, weights=graph.edge_mask()).to(x.dtype)
        return self.lin_l(agg * inv[:, None]) + self.lin_r(x_dst)


class GatedGraphConv(FlaxModule):
    """Gated graph convolution (replaces PyG ``GatedGraphConv``), used by
    DyGrEncoder.  ``aggr`` ∈ {'add', 'mean', 'max'}; the input is
    zero-padded to ``out_channels`` and every layer's aggregated message
    drives one GRU step on the node state."""

    def __init__(self, out_channels: int, num_layers: int, aggr: str = "add",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.out_channels, self.num_layers, self.aggr = (
            out_channels, num_layers, aggr)
        self.weight = nn.Parameter(glorot(
            (num_layers, out_channels, out_channels), generator, device))
        self.gru = GRUCell(out_channels, out_channels, device, generator)

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        n_in = x.shape[-1]
        if n_in > self.out_channels:
            raise ValueError("input channels must be <= out_channels")
        h = torch.nn.functional.pad(x, (0, self.out_channels - n_in))
        for layer in range(self.num_layers):
            m = h @ self.weight[layer].to(x.dtype)
            if self.aggr == "add":
                m = spmm(graph, m).to(x.dtype)
            elif self.aggr == "mean":
                inv = _inv_degree(graph.in_degree(weighted=True))
                m = spmm(graph, m).to(x.dtype) * inv[:, None].to(x.dtype)
            elif self.aggr == "max":
                # padded edges send a zero message to node 0, as in the JAX
                # package; nodes with no edge at all come out 0
                msgs = (m.index_select(-2, graph.senders)
                        * graph.masked_weights()[:, None].to(x.dtype))
                m = torch.full_like(m, float("-inf")).scatter_reduce(
                    -2, graph.receivers[:, None].expand(msgs.shape), msgs,
                    "amax", include_self=True)
                m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            else:
                raise ValueError(f"unknown aggr {self.aggr!r}")
            h, _ = self.gru(h, m)
        return h


def _order_key(scores: torch.Tensor) -> torch.Tensor:
    """Integer keys in the float total order (-NaN < -inf < … < -0.0 < 0.0
    < … < +inf < +NaN), the order ``jax.lax.top_k`` ranks by: int32 for
    2- and 4-byte floats, int64 for 8-byte ones."""
    size = scores.element_size()
    vtype = {2: torch.int16, 4: torch.int32, 8: torch.int64}[size]
    bits = scores.detach().view(vtype)
    if size == 2:
        bits = bits.int()
    return torch.where(bits < 0, bits ^ torch.iinfo(vtype).max, bits)


def _top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis in
    ``jax.lax.top_k``'s order: by the float total order of
    :func:`_order_key`, the lowest index first among equal scores
    (``torch.topk`` promises no order among equals).

    Linear in the row length: ``torch.topk`` finds the k-th largest key,
    every key above it is kept and, of those equal to it, the lowest
    indices; the k kept are then sorted."""
    key = _order_key(scores)
    kth = torch.topk(key, k, dim=-1).values[..., -1:]
    above, equal = key > kth, key == kth
    need = k - above.sum(-1, keepdim=True)
    first = torch.cumsum(equal, -1, dtype=key.dtype) <= need
    keep = above | (equal & first)
    # the k kept positions in ascending order: the lowest index ranks first
    n = scores.shape[-1]
    rank = torch.where(keep, torch.arange(n, 0, -1, device=scores.device,
                                          dtype=key.dtype), 0)
    idx = torch.topk(rank, k, dim=-1).indices
    order = torch.sort(key.gather(-1, idx), dim=-1, descending=True,
                       stable=True).indices
    idx = idx.gather(-1, order)
    return scores.gather(-1, idx), idx


def topk_pool(x: torch.Tensor, score_weight: torch.Tensor, ratio: float):
    """Top-k node selection used by EvolveGCN-H's summarizer.

    Scores ``s = x·p / ||p||``, selects ``k = ceil(ratio·N)`` nodes of
    x (N, F), returns ``(x[perm] * tanh(s[perm]), perm)`` (PyG
    ``TopKPooling`` on a single graph)."""
    n = x.shape[-2]
    k = max(1, int(-(-n * ratio // 1)))  # ceil
    s = x @ score_weight / (torch.linalg.norm(score_weight) + 1e-16)
    vals, idx = _top_k(s, k)
    return x.index_select(-2, idx) * torch.tanh(vals)[..., :, None], idx


def _topk_support(e: torch.Tensor, k: int, chunk: int = 512):
    """Sparse learned support: top-k neighbors per row of relu(E Eᵀ).

    Returns ``(cols (N, k), vals (N, k))`` where ``vals`` row-softmax the
    kept scores.  Scores are computed in row chunks (O(chunk·N) memory,
    never (N, N)); the selection indices are structure without a gradient,
    while the kept scores are recomputed from the gathered embeddings so
    gradients flow to E.  The softmax normalizes over the k kept entries
    only (the dense form normalizes over all N).
    """
    n = e.shape[0]
    k = min(k, n)
    with torch.no_grad():
        cols = torch.cat([
            _top_k(torch.relu(e[lo:lo + chunk] @ e.T), k)[1]
            for lo in range(0, n, chunk)])
    kept = torch.relu(torch.einsum("nd,nkd->nk", e, e[cols]))
    return cols, torch.softmax(kept, dim=1)


class AVWGCN(FlaxModule):
    """Adaptive vertex-wise GCN from AGCRN.

    Graph-free: support = softmax(relu(E Eᵀ)); Chebyshev-style stack of
    [I, support, 2·support·prev − prev2 ...]; per-node weights pooled from
    the node embedding matrix E.  The dense form materializes a (K, N, N)
    support (guarded above 8192 nodes); ``topk`` keeps the top-``topk``
    neighbors per row and runs the recursion on vectors, with the softmax
    over the kept entries only.
    """

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 embedding_dimensions: int, topk: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.K, self.topk = K, topk
        self.weights_pool = nn.Parameter(glorot(
            (embedding_dimensions, K, in_channels, out_channels), generator,
            device))
        self.bias_pool = nn.Parameter(glorot(
            (embedding_dimensions, out_channels), generator, device))

    def forward(self, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        n = e.shape[0]
        if self.topk is None and n > 8192:
            raise ValueError(
                f"AVWGCN/AGCRN materializes a learned (K, N, N) dense "
                f"support — O(N²) memory; N={n} would allocate "
                f"{self.K * n * n * 4 / 2**30:.1f} GiB. Pass "
                "AVWGCN(..., topk=16) (or AGCRN(..., topk=16)) for the "
                "sparse learned support that never materializes (N, N) — "
                "a documented approximation: softmax over the kept "
                "entries instead of all N.")
        if self.topk is not None:
            cols, vals = _topk_support(e, self.topk)

            def s_matvec(v):  # (..., N, C) -> (..., N, C)
                gathered = v.index_select(-2, cols.reshape(-1)).reshape(
                    v.shape[:-2] + (n, self.topk) + v.shape[-1:])
                return torch.einsum("nk,...nkc->...nc", vals, gathered)

            terms = [x, s_matvec(x)]
            for _ in range(2, self.K):
                terms.append(2.0 * s_matvec(terms[-1]) - terms[-2])
            x_g = torch.stack(terms[:max(self.K, 1)], dim=-2)
        else:
            supports = torch.softmax(torch.relu(e @ e.T), dim=1)
            support_set = [torch.eye(n, dtype=x.dtype, device=x.device),
                           supports]
            for _ in range(2, self.K):
                support_set.append((2.0 * supports) @ support_set[-1]
                                   - support_set[-2])
            x_g = torch.einsum("knm,...mi->...nki",
                               torch.stack(support_set), x)
        weights = torch.einsum("nd,dkio->nkio", e, self.weights_pool)
        bias = e @ self.bias_pool
        return torch.einsum("...nki,nkio->...no", x_g, weights) + bias
