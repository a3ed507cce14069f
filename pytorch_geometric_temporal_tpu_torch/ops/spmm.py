"""Sparse matrix–matrix products (the framework's single hot primitive).

``spmm(graph, X)[r] = Σ_{edges s->r} w(s->r) · X[s]`` — port of the JAX
package's ``ops/spmm.py``.  Backends:

- ``dense``   : one ``torch.matmul`` against the dense adjacency
                (:meth:`Graph.to_adj_t`); the default for N up to
                ``dense_threshold``.
- ``segment`` : gather + ``index_add_``; any N, the reference path.
- ``bcsr``    : the hybrid block-sparse operator (``bcsr.py``) and its two
                CUDA kernels.  A large graph reaching ``spmm`` is tiled once
                on the host and the operator cached on the Graph instance.

With ``auto``, N above the threshold goes to ``bcsr`` for CUDA tensors and
to ``segment`` on the CPU.  ``spmm`` accepts X of shape (..., N, F).

The ``bcsr`` branch holds the rule stated in :mod:`.graph`: the operator is
built once per Graph instance (models memoize their derived graphs on the
caller's graph, so the instance is the same on every forward pass), and a
``transient`` graph, one whose weights were computed on the device inside
the forward pass (scaled by a power-iteration λ_max), takes the segment
path, as do per-call weights and bipartite graphs.  The JAX package does the
same with a graph whose weights are traced.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import get_config
from .graph import Graph, _memo


def _resolve_backend(graph: Graph, x: torch.Tensor,
                     backend: Optional[str]) -> str:
    cfg = get_config()
    b = backend or cfg.spmm_backend
    if b != "auto":
        return b
    if graph.num_nodes <= cfg.dense_threshold:
        return "dense"
    return "bcsr" if x.device.type == "cuda" else "segment"


def spmm_dense(graph: Graph, x: torch.Tensor, weights=None) -> torch.Tensor:
    if weights is not None:
        adj_t = graph.with_weights(weights).to_adj_t(dtype=x.dtype)
    else:
        adj_t = _memo(graph, ("adj_t", x.dtype),
                      lambda: graph.to_adj_t(dtype=x.dtype))
    return torch.matmul(adj_t, x)


def spmm_segment(graph: Graph, x: torch.Tensor, weights=None) -> torch.Tensor:
    w = (graph.masked_weights() if weights is None
         else weights * graph.edge_mask(weights.dtype))
    msgs = x.index_select(-2, graph.senders) * w[:, None].to(x.dtype)
    out = x.new_zeros(x.shape[:-2] + (graph.num_nodes,) + x.shape[-1:])
    return out.index_add_(-2, graph.receivers, msgs)


def _auto_bcsr(graph: Graph, x_dtype, width: int = 64):
    """Build (once, host-side) and cache the BCSR operator for this graph:
    bf16 tiles for bf16 activations, f32 otherwise; reordered per
    ``spmm_reorder``, the decision priced at ``width`` features (``spmm``
    passes the width ``bcsr_spmm`` flattens the building call's x to).
    The memo key holds no width: the first call's width decides the
    layout for every later call on this graph, at any width."""
    from .bcsr import BCSRMatrix

    tile_dtype = torch.bfloat16 if x_dtype == torch.bfloat16 else None
    reorder = "auto" if get_config().spmm_reorder == "auto" else None
    return _memo(graph, ("bcsr", str(tile_dtype), reorder),
                 lambda: BCSRMatrix.from_graph(graph, dtype=tile_dtype,
                                               reorder=reorder,
                                               expected_f=width))


def spmm(
    graph,
    x: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Aggregate node features along edges: out[..., r, :] = Σ w · x[..., s, :].

    Args:
        graph: the (padded) graph, or a prebuilt
            :class:`~.bcsr.BCSRMatrix` operator.
        weights: optional per-edge coefficients overriding
            ``graph.weights``.  Padding is masked internally.
        backend: 'dense' | 'segment' | 'bcsr' | None (config, then auto).
    """
    from .bcsr import BCSRMatrix, bcsr_spmm

    if isinstance(graph, BCSRMatrix):
        if weights is not None:
            raise ValueError(
                "weight override is not supported for prebuilt BCSRMatrix "
                "operators (weights are baked into the tiles)")
        return bcsr_spmm(graph, x)
    b = _resolve_backend(graph, x, backend)
    if b == "dense":
        return spmm_dense(graph, x, weights)
    if b == "segment":
        return spmm_segment(graph, x, weights)
    if b == "bcsr":
        # per-call weights and a transient graph's weights cannot be baked
        # into tiles, and the tiler assumes a square graph: all three take
        # the segment path
        if (weights is not None or graph.num_src is not None
                or graph.transient):
            return spmm_segment(graph, x, weights)
        # leading dims fold into the feature axis (bcsr_spmm)
        width = max(x.numel() // max(graph.num_nodes, 1), 1)
        return bcsr_spmm(_auto_bcsr(graph, x.dtype, width), x)
    raise ValueError(f"unknown spmm backend {b!r}")


def sddmm(graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul: per-edge scores e = <a[s], b[r]>.

    Returns (E_pad,) with padded entries zeroed: edge scores without
    materializing N×N.  ``graph`` may be a
    :class:`~.operators.PreparedGraph`.
    """
    graph = getattr(graph, "graph", graph)
    scores = (a[graph.senders] * b[graph.receivers]).sum(-1)
    return scores * graph.edge_mask(scores.dtype)
