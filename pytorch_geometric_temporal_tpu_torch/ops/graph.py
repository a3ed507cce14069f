"""Static graph representation and normalization transforms.

Port of the JAX package's ``ops/graph.py``.  A :class:`Graph` holds padded
edge tensors (``senders``, ``receivers``, ``weights``) on one device plus
static metadata; padded edges carry weight 0 and are masked out by
:meth:`Graph.masked_weights`.  The normalizations (:func:`gcn_norm`,
:func:`cheb_norm`, :func:`diffusion_norms`) are ``Graph -> Graph``
functions on tensors, memoized on the source graph, and return a prebuilt
operator when handed a :class:`~.operators.PreparedGraph` that holds one.

Eager execution derives a graph every time a line runs, where a traced
program derives it once; the operators that :func:`~.spmm.spmm` tiles on the
host are cached on the Graph *instance* they were built from.  Hence the
rule: **a forward pass never host-builds a BCSR operator more than once per
caller's graph, and never for a graph whose weights were scaled by a
device-computed λ_max.**  Derived graphs of a constant graph are memoized on
it (:func:`_memo`), so the same instance — and its cached operator — comes
back on every call; a graph derived from a device-computed value
(:func:`cheb_norm` with a tensor ``lambda_max``, the Laplacian inside
:func:`lambda_max`) is marked ``transient``, and ``spmm`` aggregates it on
the segment path instead of tiling it.

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
        transient: the weights were computed on the device inside a forward
                   pass (they change from call to call): ``spmm`` never
                   host-builds a BCSR operator for such a graph.  Carried
                   along by ``reverse`` and ``with_weights``.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    weights: torch.Tensor
    num_nodes: int
    num_edges: int
    num_src: Optional[int] = None
    transient: bool = False

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

    def remove_self_loops(self) -> "Graph":
        """Zero the weight of every self-loop edge (shape preserved), so the
        loops contribute to no aggregation, degree or Laplacian entry."""
        keep = (self.senders != self.receivers).to(self.weights.dtype)
        return self.with_weights(self.weights * keep)

    def add_self_loops(self, fill_value: float = 1.0) -> "Graph":
        """Append one self-loop per node with the given weight
        (E_pad -> E_pad + N)."""
        loops = self.weights.new_full((self.num_nodes,), fill_value)
        return self.with_loop_block(self.weights, loops)

    def with_loop_block(self, weights, loop_weights) -> "Graph":
        """These edges under ``weights`` plus one (i, i) entry per node
        weighted ``loop_weights``.  The loop block goes at offset
        ``num_edges``, so the padding stays trailing with weight 0."""
        n, e = self.num_nodes, self.num_edges
        loop = torch.arange(n, dtype=self.senders.dtype, device=self.device)
        return Graph(
            senders=torch.cat([self.senders[:e], loop, self.senders[e:]]),
            receivers=torch.cat([self.receivers[:e], loop,
                                 self.receivers[e:]]),
            weights=torch.cat([weights[:e], loop_weights,
                               torch.zeros_like(weights[e:])]),
            num_nodes=n,
            num_edges=e + n,
        )

    # -- degrees -----------------------------------------------------------

    def out_degree(self, weighted: bool = True) -> torch.Tensor:
        return self._degree(self.senders, self.src_count, weighted)

    def in_degree(self, weighted: bool = True) -> torch.Tensor:
        return self._degree(self.receivers, self.num_nodes, weighted)

    def _degree(self, index: torch.Tensor, n: int,
                weighted: bool) -> torch.Tensor:
        """out[i] = Σ w[index == i], the same bits on every run."""
        if not weighted:
            # 0/1 counts are exact in any order (integers below 2**24), so
            # CUDA's atomics give the same bits every run
            return torch.zeros(n, device=self.device).index_add_(
                0, index, self.edge_mask())
        # Weights are summed in edge order: ``index_put_`` with
        # ``accumulate`` sorts the indices on CUDA and sums each run of
        # them in order (on the CPU one serial pass, ``index_add_``'s
        # bits), where CUDA's ``index_add_`` adds in an order that changes
        # from run to run, and a captured step would not reproduce an
        # eager one to the bit.
        w = self.masked_weights()
        return torch.zeros(n, dtype=w.dtype, device=self.device).index_put_(
            (index,), w, accumulate=True)

    # -- dense view --------------------------------------------------------

    def to_adj_t(self, dtype=None) -> torch.Tensor:
        """Dense (N, N) matrix M with M[r, s] = w(s -> r), so spmm == M @ X."""
        dtype = dtype or self.weights.dtype
        m = torch.zeros((self.num_nodes, self.src_count), dtype=dtype,
                        device=self.device)
        return m.index_put_((self.receivers, self.senders),
                            self.masked_weights().to(dtype), accumulate=True)

    def to_adj(self, dtype=None) -> torch.Tensor:
        """Dense (N, N) matrix A with A[s, r] = w(s -> r) (PyG
        ``to_dense_adj``)."""
        return self.to_adj_t(dtype).T


def reorder_graph(graph: Graph):
    """Relabel nodes by the shortcut-filtered RCM bandwidth-reduction order.

    Returns ``(graph', perm, iperm)`` with ``perm[new_id] = old_id`` and
    ``iperm[old_id] = new_id`` (numpy int32).  This is the MODEL-LEVEL
    form of the reordering ``BCSRMatrix.from_graph(reorder=...)`` applies
    internally: permute the graph (and the feature/target arrays, once, at
    the boundary — ``x_new = x[perm]``, ``out[old] = out_new[iperm[old]]``)
    and run the ENTIRE model in permuted space, so recurrent models doing
    many aggregations per step pay the permutation once per forward
    instead of two gathers per spmm.

    Host-side; bipartite graphs are rejected (the relabeling assumes one
    square node set).  A graph without edges gets the identity.
    """
    from ..native import bandwidth_reduction_order

    if graph.num_src is not None:
        raise ValueError("reorder_graph needs a square (non-bipartite) graph")
    e = graph.num_edges
    s_all, r_all, _ = graph.host_edges()
    s, r = np.asarray(s_all)[:e], np.asarray(r_all)[:e]
    n = graph.num_nodes
    perm = bandwidth_reduction_order(s, r, n)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(n, dtype=np.int32)
    new_s = np.zeros(graph.edge_pad, np.int64)
    new_r = np.zeros(graph.edge_pad, np.int64)
    new_s[:e] = iperm[s]
    new_r[:e] = iperm[r]
    g2 = dataclasses.replace(
        graph,
        senders=torch.from_numpy(new_s).to(graph.device),
        receivers=torch.from_numpy(new_r).to(graph.device),
    )
    return g2, perm, iperm


def pad_graphs(graphs, pad_to: Optional[int] = None):
    """Pad a list of Graphs to a common edge count (dynamic-edge
    sequences); padded edges are (0, 0) with weight 0."""
    if pad_to is None:
        pad_to = max(g.num_edges for g in graphs)
    out = []
    for g in graphs:
        ep = g.edge_pad
        if ep == pad_to:
            out.append(g)
            continue
        if ep > pad_to:
            raise ValueError("pad_to smaller than an existing edge_pad")
        pad = (0, pad_to - ep)
        out.append(Graph(
            senders=torch.nn.functional.pad(g.senders, pad),
            receivers=torch.nn.functional.pad(g.receivers, pad),
            weights=torch.nn.functional.pad(g.masked_weights(), pad),
            num_nodes=g.num_nodes,
            num_edges=g.num_edges,
        ))
    return out


def stack_graphs(graphs) -> Graph:
    """Stack equally padded Graphs along a new leading (time) axis.

    The result's edge tensors are (T, E_pad); slice per step.
    ``num_edges`` becomes the max; per-step masking relies on the zeroed
    padded weights from :func:`pad_graphs`.
    """
    graphs = pad_graphs(graphs)
    n = graphs[0].num_nodes
    if any(g.num_nodes != n for g in graphs):
        raise ValueError("all graphs must share num_nodes")
    return Graph(
        senders=torch.stack([g.senders for g in graphs]),
        receivers=torch.stack([g.receivers for g in graphs]),
        weights=torch.stack([g.masked_weights() for g in graphs]),
        num_nodes=n,
        num_edges=max(g.num_edges for g in graphs),
    )


def _prepared_lookup(graph, key):
    """(op_or_None, raw_graph): the prebuilt operator a
    :class:`~.operators.PreparedGraph` holds under ``key``, if any
    (duck-typed on its ``ops`` dict to avoid a circular import)."""
    ops = getattr(graph, "ops", None)
    if ops is None:
        return None, graph
    return ops.get(key), graph.graph


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


def _safe_inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0, torch.zeros_like(x),
                       torch.rsqrt(torch.where(x <= 0, torch.ones_like(x),
                                               x)))


def gcn_norm(graph: Graph, improved: bool = False,
             add_self_loops: bool = True) -> Graph:
    """Symmetric GCN normalization D̃^{-1/2} Ã D̃^{-1/2} (PyG ``gcn_norm``).
    Zero degrees produce 0."""
    key = ("gcn_norm", improved, add_self_loops)
    op, graph = _prepared_lookup(graph, key)
    if op is not None:
        return op

    def build():
        fill = 2.0 if improved else 1.0
        g = graph.add_self_loops(fill) if add_self_loops else graph
        dis = _safe_inv_sqrt(g.in_degree(weighted=True))
        return g.with_weights(
            dis[g.senders] * g.masked_weights() * dis[g.receivers])

    return _memo(graph, key, build)


def laplacian(graph: Graph, normalization: Optional[str] = "sym") -> Graph:
    """Graph Laplacian as an edge list (PyG ``get_laplacian``).

    - 'sym':  L = I - D^{-1/2} A D^{-1/2}
    - 'rw':   L = I - D^{-1} A
    - None:   L = D - A

    Degrees are scattered over the *source* node, as PyG does.
    """
    w = graph.masked_weights()
    deg = graph.out_degree(weighted=True)
    if normalization == "sym":
        dis = _safe_inv_sqrt(deg)
        off = -dis[graph.senders] * w * dis[graph.receivers]
        diag = torch.ones_like(deg)
    elif normalization == "rw":
        off = -_safe_inv(deg)[graph.senders] * w
        diag = torch.ones_like(deg)
    elif normalization is None:
        off = -w
        diag = deg
    else:
        raise ValueError(f"unknown normalization {normalization!r}")
    return graph.with_loop_block(off, diag)


def cheb_norm(graph: Graph, normalization: Optional[str] = "sym",
              lambda_max=None) -> Graph:
    """Scaled Laplacian L̂ = 2 L / λ_max − I of Chebyshev convolution.

    PyG ``ChebConv.__norm__`` semantics: input self-loops removed before
    the Laplacian, λ_max defaults to 2.0, self-loop fill −1.0, inf → 0.
    ``lambda_max`` may be a number or a 0-dim tensor; with a tensor the
    result is not memoized and comes back ``transient`` (see the module
    docstring: ``spmm`` aggregates it on the segment path at large N).
    """
    if lambda_max is None:
        lambda_max = 2.0
    fixed = isinstance(lambda_max, (int, float))
    key = ("cheb_norm", normalization, float(lambda_max)) if fixed else None
    if fixed:
        op, graph = _prepared_lookup(graph, key)
        if op is not None:
            return op

    def build():
        lap = laplacian(graph.remove_self_loops(), normalization)
        w = lap.weights * (2.0 / lambda_max)
        w = torch.where(torch.isinf(w), torch.zeros_like(w), w)
        return lap.with_weights(w).add_self_loops(fill_value=-1.0)

    if fixed:
        return _memo(graph, key, build)
    return dataclasses.replace(build(), transient=True)


def lambda_max(graph: Graph, normalization: Optional[str] = "sym",
               iters: int = 64) -> torch.Tensor:
    """Largest Laplacian eigenvalue by power iteration (0-dim tensor).  The
    Laplacian is derived anew on every call, so it is ``transient``: its
    ``iters + 1`` aggregations never tile an operator."""
    from .spmm import spmm  # local import to avoid a cycle

    lap = dataclasses.replace(
        laplacian(graph.remove_self_loops(), normalization), transient=True)
    n = graph.num_nodes
    v = lap.weights.new_full((n, 1), 1.0 / np.sqrt(n))
    for _ in range(iters):
        v = spmm(lap, v).to(v.dtype)
        v = v / (torch.linalg.norm(v) + 1e-12)
    lv = spmm(lap, v).to(v.dtype)
    return (v * lv).sum() / ((v * v).sum() + 1e-12)


def diffusion_norms(graph: Graph) -> Tuple[Graph, Graph]:
    """Forward/backward random-walk transition operators for diffusion conv.

    Returns (P_fwd, P_bwd) with P_fwd = D_O^{-1} W applied as
    ``spmm(P_fwd, X)[i] = (1/deg_out(i)) Σ_j W[i,j] X[j]`` and
    P_bwd = D_I^{-1} Wᵀ, per the DCRNN paper (arXiv 1707.01926).
    """
    op, graph = _prepared_lookup(graph, ("diffusion_norms",))
    if op is not None:
        return op

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
