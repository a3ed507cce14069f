"""Static graph representation and the diffusion normalization.

Port of the JAX package's ``ops/graph.py`` (``Graph`` and
``diffusion_norms``).  A :class:`Graph` holds padded edge tensors
(``senders``, ``receivers``, ``weights``) on one device plus static
metadata; padded edges carry weight 0 and are masked out by
:meth:`Graph.masked_weights`.

Conventions match PyG: ``edge_index[0]`` is the message *source* and
``edge_index[1]`` the *target*; aggregation happens at the target.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Graph:
    """A padded sparse graph on one device.

    Attributes:
        senders:   (E_pad,) int64 — source node of each edge.  Padded 0.
        receivers: (E_pad,) int64 — target node of each edge.  Padded 0.
        weights:   (E_pad,) float — edge weights.  Padded 0.0.
        num_nodes: number of (receiver-side) nodes N.
        num_edges: number of *real* edges (<= E_pad).
        num_src:   sender-side node count for bipartite edges; None means
                   square (num_nodes).
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    weights: torch.Tensor
    num_nodes: int
    num_edges: int
    num_src: Optional[int] = None

    @property
    def src_count(self) -> int:
        return self.num_nodes if self.num_src is None else self.num_src

    @property
    def device(self) -> torch.device:
        return self.weights.device

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_edge_index(
        edge_index,
        edge_weight=None,
        num_nodes: Optional[int] = None,
        pad_to: Optional[int] = None,
        dtype=torch.float32,
        num_src: Optional[int] = None,
        device=None,
    ) -> "Graph":
        """Build from a PyG-style (2, E) edge index (host-side).

        ``device`` defaults to CUDA; pass ``device="cpu"`` to build on the
        CPU.  The host arrays are cached read-only on the instance for the
        BCSR construction (see :meth:`host_edges`).
        """
        device = resolve_device(device)
        edge_index = np.asarray(edge_index)
        if edge_index.ndim != 2 or edge_index.shape[0] != 2:
            raise ValueError(
                f"edge_index must be (2, E), got {edge_index.shape}")
        e = edge_index.shape[1]
        if num_nodes is None:
            num_nodes = int(edge_index.max()) + 1 if e > 0 else 0
        if edge_weight is None:
            edge_weight = np.ones((e,), dtype=np.float32)
        else:
            edge_weight = np.asarray(edge_weight, np.float32).reshape(e)
        e_pad = pad_to if pad_to is not None else e
        if e_pad < e:
            raise ValueError(f"pad_to={e_pad} < num_edges={e}")
        senders = np.zeros((e_pad,), np.int32)
        receivers = np.zeros((e_pad,), np.int32)
        weights = np.zeros((e_pad,), np.float32)
        senders[:e] = edge_index[0]
        receivers[:e] = edge_index[1]
        weights[:e] = edge_weight
        g = Graph(
            senders=torch.from_numpy(senders).to(device, torch.long),
            receivers=torch.from_numpy(receivers).to(device, torch.long),
            weights=torch.from_numpy(weights).to(device, dtype),
            num_nodes=int(num_nodes),
            num_edges=int(e),
            num_src=None if num_src is None else int(num_src),
        )
        for a in (senders, receivers, weights):
            a.flags.writeable = False
        object.__setattr__(g, "_host_edges", (senders, receivers, weights))
        return g

    def host_edges(self):
        """(senders int32, receivers int32, weights f32) as read-only numpy
        arrays, copied from the device at most once."""
        cached = getattr(self, "_host_edges", None)
        if cached is None:
            cached = (
                self.senders.cpu().numpy().astype(np.int32),
                self.receivers.cpu().numpy().astype(np.int32),
                self.weights.detach().float().cpu().numpy(),
            )
            for a in cached:
                a.flags.writeable = False
            object.__setattr__(self, "_host_edges", cached)
        return cached

    # -- basic properties --------------------------------------------------

    @property
    def edge_pad(self) -> int:
        return self.senders.shape[-1]

    def edge_mask(self, dtype=torch.float32) -> torch.Tensor:
        """(E_pad,) mask of real edges; 1.0 for real, 0.0 for padding."""
        if self.num_edges == self.edge_pad:
            return torch.ones((self.edge_pad,), dtype=dtype,
                              device=self.device)
        return (torch.arange(self.edge_pad, device=self.device)
                < self.num_edges).to(dtype)

    def masked_weights(self) -> torch.Tensor:
        return self.weights * self.edge_mask(self.weights.dtype)

    def with_weights(self, weights) -> "Graph":
        return dataclasses.replace(self, weights=weights)

    def reverse(self) -> "Graph":
        """Transposed graph (edges flipped). Weights carried along."""
        return dataclasses.replace(
            self,
            senders=self.receivers,
            receivers=self.senders,
            num_nodes=self.src_count,
            num_src=None if self.num_src is None else self.num_nodes,
        )

    # -- degrees -----------------------------------------------------------

    def out_degree(self, weighted: bool = True) -> torch.Tensor:
        w = self.masked_weights() if weighted else self.edge_mask()
        return torch.zeros(self.src_count, dtype=w.dtype,
                           device=self.device).index_add_(0, self.senders, w)

    def in_degree(self, weighted: bool = True) -> torch.Tensor:
        w = self.masked_weights() if weighted else self.edge_mask()
        return torch.zeros(self.num_nodes, dtype=w.dtype,
                           device=self.device).index_add_(0, self.receivers, w)

    # -- dense view --------------------------------------------------------

    def to_adj_t(self, dtype=None) -> torch.Tensor:
        """Dense (N, N) matrix M with M[r, s] = w(s -> r), so spmm == M @ X."""
        dtype = dtype or self.weights.dtype
        m = torch.zeros((self.num_nodes, self.src_count), dtype=dtype,
                        device=self.device)
        return m.index_put_((self.receivers, self.senders),
                            self.masked_weights().to(dtype), accumulate=True)


def _memo(graph: Graph, key, build):
    """Instance-level memo for derived operators of a constant graph.

    Models re-derive their normalization at every call site (DCRNN twice
    per cell step); the result is a pure function of the edge tensors, so
    it is built once per Graph instance.  Graphs whose weights require
    grad are never memoized (the result would pin a stale autograd graph).
    """
    if graph.weights.requires_grad:
        return build()
    cache = getattr(graph, "_op_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_op_cache", cache)
    out = cache.get(key)
    if out is None:
        out = cache[key] = build()
    return out


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, torch.zeros_like(x),
                       1.0 / torch.where(x == 0, torch.ones_like(x), x))


def diffusion_norms(graph: Graph) -> Tuple[Graph, Graph]:
    """Forward/backward random-walk transition operators for diffusion conv.

    Returns (P_fwd, P_bwd) with P_fwd = D_O^{-1} W applied as
    ``spmm(P_fwd, X)[i] = (1/deg_out(i)) Σ_j W[i,j] X[j]`` and
    P_bwd = D_I^{-1} Wᵀ, per the DCRNN paper (arXiv 1707.01926).
    """

    def build():
        w = graph.masked_weights()
        deg_out = graph.out_degree(weighted=True)
        deg_in = graph.in_degree(weighted=True)
        # P_fwd[i, j] = W[i, j] / deg_out(i): messages j -> i over the
        # reversed edges, weight of edge i -> j over deg_out(i)
        p_fwd = graph.reverse().with_weights(
            w * _safe_inv(deg_out)[graph.senders])
        # P_bwd[i, j] = W[j, i] / deg_in(i): the original edges j -> i
        p_bwd = graph.with_weights(w * _safe_inv(deg_in)[graph.receivers])
        return p_fwd, p_bwd

    return _memo(graph, ("diffusion_norms",), build)
