"""Prenormalized diffusion operators — the large-graph model mode.

Port of the diffusion part of the JAX package's ``ops/operators.py``.  For a
large graph the normalization is computed ONCE on the host (float64 numpy,
cast to f32) and handed to the model as :class:`DiffusionOperators`: two
plain :class:`~.graph.Graph` operators, or two hybrid
:class:`~.bcsr.BCSRMatrix` operators (tiles + COO remainder) whose
aggregations run through the CUDA kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .._device import resolve_device
from .graph import Graph


def _host_edges(graph: Graph):
    s, r, w = graph.host_edges()
    e = graph.num_edges
    return (
        np.asarray(s)[:e].astype(np.int64),
        np.asarray(r)[:e].astype(np.int64),
        np.asarray(w)[:e].astype(np.float64),
    )


def _safe_inv(x):
    out = np.zeros_like(x)
    nz = x != 0
    out[nz] = 1.0 / x[nz]
    return out


def _graph_from(s, r, w, n, device) -> Graph:
    return Graph.from_edge_index(np.stack([s, r]), w.astype(np.float32),
                                 num_nodes=n, device=device)


def host_diffusion_norms(graph: Graph, device=None):
    """Numpy mirror of :func:`~.graph.diffusion_norms` → (P_fwd, P_bwd),
    built on ``device`` (default: the graph's)."""
    device = graph.device if device is None else device
    s, r, w = _host_edges(graph)
    n = graph.num_nodes
    deg_out = np.bincount(s, weights=w, minlength=n)
    deg_in = np.bincount(r, weights=w, minlength=n)
    p_fwd = _graph_from(r, s, w * _safe_inv(deg_out)[s], n, device)
    p_bwd = _graph_from(s, r, w * _safe_inv(deg_in)[r], n, device)
    return p_fwd, p_bwd


def _maybe_bcsr(g: Graph, bcsr: bool, dtype, min_block_edges: int,
                reorder=None):
    if not bcsr:
        return g
    from .bcsr import BCSRMatrix

    return BCSRMatrix.from_graph(g, dtype=dtype,
                                 min_block_edges=min_block_edges,
                                 reorder=reorder)


@dataclasses.dataclass(frozen=True)
class DiffusionOperators:
    """Prebuilt bidirectional diffusion operators for DCRNN-family models."""

    p_fwd: Any  # Graph or BCSRMatrix
    p_bwd: Any

    @property
    def num_nodes(self) -> int:
        return self.p_fwd.num_nodes

    @staticmethod
    def from_graph(graph: Graph, bcsr: bool = False, dtype=None,
                   min_block_edges: int = 32, reorder=None,
                   device=None) -> "DiffusionOperators":
        """Host-normalize ``graph`` and build both operators on ``device``
        (CUDA unless given ``device="cpu"``); ``bcsr=True`` tiles them,
        ``dtype=torch.bfloat16`` stores bf16 tiles."""
        device = resolve_device(device)
        f, b = host_diffusion_norms(graph, device)
        return DiffusionOperators(
            p_fwd=_maybe_bcsr(f, bcsr, dtype, min_block_edges, reorder),
            p_bwd=_maybe_bcsr(b, bcsr, dtype, min_block_edges, reorder),
        )
