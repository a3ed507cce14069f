"""Prenormalized graph operators — the large-graph model mode.

Port of the JAX package's ``ops/operators.py``.  For a large graph the
normalization is computed ONCE on the host (float64 numpy mirrors of the
tensor transforms in :mod:`.graph`, cast to f32) and handed to the model
as a prenormalized operator: a plain :class:`~.graph.Graph` (weights
already normalized) or a hybrid :class:`~.bcsr.BCSRMatrix` (tiles + COO
remainder) whose aggregations run through the CUDA kernel.  Models accept
these wherever they accept a Graph:

- ``GCNConv(normalize=False)`` / ``gcn_conv_fixed_w(normalize=False)``
  with an operator from :func:`prenormalize_gcn`,
- ``ChebConv`` / ``cheb_basis`` (and GConvGRU) with a
  :class:`Prenormalized` wrapper from :func:`prenormalize_cheb`,
- ``DCRNN``/``DCRNNSeq``/``diffusion_basis`` with
  :class:`DiffusionOperators`,

or take a :class:`PreparedGraph`, which bundles a raw graph with its
prebuilt operators so that the norm functions return them.  Every function
here puts its operators on ``device`` (CUDA unless given ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

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


def _safe_inv_sqrt(x):
    out = np.zeros_like(x)
    pos = x > 0
    out[pos] = 1.0 / np.sqrt(x[pos])
    return out


def _graph_from(s, r, w, n, device) -> Graph:
    return Graph.from_edge_index(np.stack([s, r]), w.astype(np.float32),
                                 num_nodes=n, device=device)


def host_gcn_norm(graph: Graph, improved: bool = False,
                  add_self_loops: bool = True, device=None) -> Graph:
    """Numpy mirror of :func:`~.graph.gcn_norm`, built on ``device``
    (default: the graph's)."""
    device = graph.device if device is None else device
    s, r, w = _host_edges(graph)
    n = graph.num_nodes
    if add_self_loops:
        loop = np.arange(n, dtype=s.dtype)
        s = np.concatenate([s, loop])
        r = np.concatenate([r, loop])
        w = np.concatenate([w, np.full(n, 2.0 if improved else 1.0)])
    dis = _safe_inv_sqrt(np.bincount(r, weights=w, minlength=n))
    return _graph_from(s, r, dis[s] * w * dis[r], n, device)


def host_cheb_norm(graph: Graph, normalization: Optional[str] = "sym",
                   lambda_max: Optional[float] = None, device=None) -> Graph:
    """Numpy mirror of :func:`~.graph.cheb_norm`: L̂ = 2L/λ_max − I, built
    on ``device`` (default: the graph's).  Input self-loops are dropped
    first, as PyG ``ChebConv.__norm__`` does."""
    device = graph.device if device is None else device
    if lambda_max is None:
        lambda_max = 2.0
    s, r, w = _host_edges(graph)
    keep = s != r
    s, r, w = s[keep], r[keep], w[keep]
    n = graph.num_nodes
    deg = np.bincount(s, weights=w, minlength=n)
    if normalization == "sym":
        dis = _safe_inv_sqrt(deg)
        off = -dis[s] * w * dis[r]
        diag = np.ones(n)
    elif normalization == "rw":
        off = -_safe_inv(deg)[s] * w
        diag = np.ones(n)
    elif normalization is None:
        off = -w
        diag = deg
    else:
        raise ValueError(f"unknown normalization {normalization!r}")
    loop = np.arange(n, dtype=s.dtype)
    # scale by 2/λ_max, then add the −I self-loops (cheb_norm's order)
    w2 = np.concatenate([off * (2.0 / lambda_max),
                         diag * (2.0 / lambda_max),
                         np.full(n, -1.0)])
    return _graph_from(np.concatenate([s, loop, loop]),
                       np.concatenate([r, loop, loop]), w2, n, device)


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
class Prenormalized:
    """Marker wrapper: ``op`` is an already-normalized aggregation operator
    (Graph or BCSRMatrix).  ``cheb_basis``/``ChebConv`` skip the norm
    rebuild when handed one of these."""

    op: Any

    @property
    def num_nodes(self) -> int:
        return self.op.num_nodes


def prenormalize_gcn(graph: Graph, improved: bool = False,
                     add_self_loops: bool = True, bcsr: bool = False,
                     dtype=None, min_block_edges: int = 32, device=None):
    """Host-build the sym-normalized GCN operator.  Pass the result to
    ``GCNConv(normalize=False)`` / ``gcn_conv_fixed_w(..., normalize=False)``."""
    g = host_gcn_norm(graph, improved, add_self_loops,
                      resolve_device(device))
    return _maybe_bcsr(g, bcsr, dtype, min_block_edges)


def stack_bcsr_gcn(graphs, improved: bool = False,
                   add_self_loops: bool = True, dtype=None,
                   min_block_edges="auto", expected_f: int = 64,
                   device=None):
    """Per-step prenormalized GCN operators for a dynamic-edge sequence:
    ``host_gcn_norm`` + BCSR for every snapshot, as one
    :func:`~.bcsr.stack_bcsr` sequence."""
    from .bcsr import BCSRMatrix, stack_bcsr

    device = resolve_device(device)
    return stack_bcsr([
        BCSRMatrix.from_graph(
            host_gcn_norm(g, improved, add_self_loops, device), dtype=dtype,
            min_block_edges=min_block_edges, expected_f=expected_f)
        for g in graphs
    ])


def prenormalize_cheb(graph: Graph, normalization: Optional[str] = "sym",
                      lambda_max: Optional[float] = None, bcsr: bool = False,
                      dtype=None, min_block_edges: int = 32,
                      device=None) -> Prenormalized:
    """Host-build the scaled Laplacian L̂.  Pass to ``ChebConv``/
    ``cheb_basis`` and the Cheb-gated cells (GConvGRU)."""
    g = host_cheb_norm(graph, normalization, lambda_max,
                       resolve_device(device))
    return Prenormalized(_maybe_bcsr(g, bcsr, dtype, min_block_edges))


class PreparedGraph:
    """A Graph bundled with host-prebuilt normalized operators.

    Pass it anywhere a Graph is accepted: :func:`~.graph.gcn_norm`,
    :func:`~.graph.cheb_norm` and :func:`~.graph.diffusion_norms` return
    the prebuilt operator whose key matches, and recompute from the raw
    graph otherwise.  ``ops`` keys are the norm functions' memo keys, e.g.
    ``("gcn_norm", False, True)``, ``("cheb_norm", "sym", 2.0)``,
    ``("diffusion_norms",)``.
    """

    def __init__(self, graph: Graph, ops: dict):
        self.graph = graph
        self.ops = dict(ops)

    def __getattr__(self, name):
        # only called when not found on self: delegate to the raw graph
        if name in ("graph", "ops"):  # guard against init-order recursion
            raise AttributeError(name)
        return getattr(self.graph, name)


def prepare_graph(
    graph: Graph,
    kinds=("gcn", "cheb", "diffusion"),
    bcsr: Optional[bool] = None,
    dtype=None,
    min_block_edges: int = 32,
    gcn_improved: bool = False,
    gcn_add_self_loops: bool = True,
    cheb_normalization: Optional[str] = "sym",
    cheb_lambda_max: Optional[float] = None,
    device=None,
) -> PreparedGraph:
    """Host-build the normalized operators a model will need, once.

    ``kinds`` ⊆ {'gcn', 'cheb', 'diffusion'}.  ``bcsr=None`` selects the
    block-sparse form for graphs above the dense threshold.
    """
    from ..config import get_config

    device = resolve_device(device)
    if bcsr is None:
        bcsr = graph.num_nodes > get_config().dense_threshold

    def op(g):
        return _maybe_bcsr(g, bcsr, dtype, min_block_edges)

    ops = {}
    if "gcn" in kinds:
        ops[("gcn_norm", gcn_improved, gcn_add_self_loops)] = op(
            host_gcn_norm(graph, gcn_improved, gcn_add_self_loops, device))
    if "cheb" in kinds:
        lam = 2.0 if cheb_lambda_max is None else float(cheb_lambda_max)
        ops[("cheb_norm", cheb_normalization, lam)] = op(
            host_cheb_norm(graph, cheb_normalization, lam, device))
    if "diffusion" in kinds:
        f, b = host_diffusion_norms(graph, device)
        ops[("diffusion_norms",)] = (op(f), op(b))
    return PreparedGraph(graph, ops)


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
