"""ASTGCN: attention-based spatial-temporal GCN (Guo et al., AAAI'19).

Port of the JAX package's ``models/attention/astgcn.py``.

- ChebConvAttention has two execution modes.  **Dense** (N up to a few
  thousand): the scaled Laplacian becomes an (N, N) matrix and every hop is
  a batched einsum over the full (B, T, N, F) tensor.  **Edge** (large N):
  L̂ stays a sparse :class:`Graph`; the attention-scaled hop 1 is a weighted
  segment aggregation with the attention gathered at L̂'s edge pairs, and
  hops ≥ 2 are plain ``spmm`` on the reversed L̂.  Given the same attention
  matrix the two modes agree.
- Quirks of the upstream model preserved: hop-1 messages are
  attention-scaled, hops ≥ 2 use the raw Chebyshev norm; T_0 is X scaled by
  the attention diagonal; self-loops removed before the Laplacian.
- With ``normalization="sym"`` (λ_max = 2) L̂ and its reverse are derived
  once per Graph instance, so at large N on the card the reversed L̂ is
  tiled once and every hop ≥ 2 is one fused-kernel launch (the leading axes
  fold into the feature axis).  Otherwise λ_max comes from power iteration
  on the device, L̂ is a transient graph and its hops take the segment path
  (see ``ops/graph.py``).
- Dynamic per-step edge lists are supported by passing a list of Graphs
  (one per input step, pre-padded).
- ``ASTGCN(attention_mode='edge')``: spatial attention switches to
  :class:`SpatialAttentionSparse` (factored per-edge scores + column
  segment softmax; the (N, N) ``Vs``/``bs`` parameters of the dense module
  have no sparse counterpart, a documented deviation) and no (N, N) tensor
  is ever materialized.
- Edge mode's hop 1 (:class:`_WeightedHop`) on the card is a kernel of its
  own (``ops/weighted_hop.py``, ``csrc/weighted_hop.cu``): a segment sum
  by receiver forward and one pass by sender backward over CSR orders of
  the reversed L̂'s entries (built once per instance), on rows of T·F
  contiguous values (a T_0 that lies otherwise is copied once), writing
  the output's rows into an (N, B, T, F) buffer, which the combination's
  batched GEMM and ``bcsr_spmm``'s flattening read without a copy; it
  forms no message and adds nothing atomically.  On the CPU, its plain
  version forms the per-edge messages a few time steps at a time, forward
  and backward alike, and keeps none of them for the backward.  The
  counter ``astgcn_hop1`` counts hop 1's calls and the bytes of messages
  they formed, 0 on the card; ``weighted_hop`` the kernel's launches and
  the bytes it copied into rows (``_counters``); the spans
  ``astgcn.temporal_attention``, ``astgcn.spatial_attention``,
  ``astgcn.cheb`` ⊃ ``astgcn.hop1``, ``astgcn.time_conv`` mark a block's
  parts, ``astgcn.hop1_grad`` hop 1's backward.
- A stride-1 block's tail (time and residual convolutions, residual add,
  ReLU, LayerNorm) runs in the Chebyshev output's (B, T, N, C) layout
  (:class:`_BlockTail`, ``ops/block_tail.py``): the convolutions as GEMMs
  into one buffer, the rest one pass each way (on the card
  ``csrc/block_tail.cu``), no layout copy; the block's output is the
  (B, N, C, T) view of it, and the head one GEMM whose gradient gives each
  row's channels together.  The counter ``block_tail`` counts the kernel's
  launches and the bytes copied into the tail's layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ... import _counters
from ..._device import resolve_device
from ...config import get_config
from ...ops import block_tail
from ...ops.graph import (Graph, _memo, cheb_norm,
                          lambda_max as power_lambda_max)
from ...ops.spmm import spmm
from ...ops.weighted_hop import (HopCSR, as_rows, check as check_hop,
                                 hop_csrs, plain_backward, plain_forward,
                                 weighted_hop_backward,
                                 weighted_hop_forward)
from .._cells import Conv, FlaxModule, LayerNorm, glorot, uniform
from .._validate import check_node_axis, check_rank
from .mstgcn import final_conv

class EdgeScores(NamedTuple):
    """Spatial attention restricted to graph edges (the sparse form).

    ``edge`` (B, E_pad) holds scores for the ORIGINAL graph's edge list
    (padding entries ignored); ``diag`` (B, N) the per-node self scores —
    together the exact support ChebConvAttention reads from a dense S.
    """

    edge: torch.Tensor
    diag: torch.Tensor


def _lhat_graph(graph: Graph, normalization: Optional[str]) -> Graph:
    """Sparse scaled Laplacian L̂ as a Graph (edge layout is deterministic:
    [original E edges, Laplacian-diagonal N, −1 self-loop N, padding]).
    ``"sym"`` is derived once per Graph instance; any other normalization
    scales by a power-iteration λ_max and comes back transient."""
    if normalization == "sym":
        return _memo(graph, ("lhat", "sym"), lambda: cheb_norm(
            graph.remove_self_loops(), "sym", None))
    g = graph.remove_self_loops()
    return cheb_norm(g, normalization, power_lambda_max(g, normalization))


def _reversed(lhat: Graph) -> Graph:
    """``lhat.reverse()``, once per instance (the BCSR operator that
    ``spmm`` builds at large N is cached on the reversed instance)."""
    return _memo(lhat, ("reverse",), lhat.reverse)


def _lhat_dense(graph: Graph, normalization: Optional[str]) -> torch.Tensor:
    """Dense scaled Laplacian L̂[i, j] for ChebConvAttention."""
    if graph.num_nodes > 8192:
        raise ValueError(
            f"ChebConvAttention/ASTGCN in dense mode materializes the "
            f"(N, N) scaled Laplacian AND a per-batch (B, N, N) spatial "
            f"attention — O(N²) memory; N={graph.num_nodes} is past any "
            "sensible dense size. Use attention_mode='edge' (sparse L̂ + "
            "per-edge attention, no (N, N) tensors) for large graphs."
        )
    # [senders=row, receivers=col] -> L[row, col]
    return _lhat_graph(graph, normalization).to_adj()


# hop 1's calls and bytes of per-edge messages formed, forward and backward
_hop1_counts = [0, 0]


def hop1_counts() -> tuple:
    """(calls, bytes of per-edge messages formed in device memory) of hop
    1, forward and backward: each (B, t, E, F) block that a call gathers on
    the plain path.  On the card the kernel forms none: its calls count
    with 0 bytes."""
    return tuple(_hop1_counts)


def add_hop1_counts(delta) -> None:
    """Add ``delta`` (a :func:`hop1_counts` tuple); a CUDA graph's replays
    re-add what its capture counted (``_counters``)."""
    _hop1_counts[0] += delta[0]
    _hop1_counts[1] += delta[1]


_counters.register("astgcn_hop1", hop1_counts, add_hop1_counts)


class _WeightedHop(torch.autograd.Function):
    """Hop 1 of edge mode: out[b, t, r] = Σ_{e: s_e -> r} w[b, e] ·
    x[b, t, s_e] for x (B, T, N, F) and w (B, E) (``ops/weighted_hop.py``).
    A CUDA tensor takes the kernel over the CSR orders ``csrs`` (by
    receiver, by sender); a CPU tensor the plain version, whose per-edge
    messages (B, t, E, F) are formed a few time steps at a time and not
    kept.  The backward saves x, w and the index tensors alone."""

    @staticmethod
    def forward(ctx, x, w, senders, receivers, num_nodes, csrs=None):
        if x.device.type == "cpu":
            ctx.save_for_backward(x, w, senders, receivers)
            out, formed = plain_forward(x, w, senders, receivers, num_nodes)
            add_hop1_counts((1, formed))
            return out
        check_hop(x, w)
        # the rows the kernel reads, copied once where x's lie otherwise
        x = as_rows(x)
        ctx.save_for_backward(x, w, *csrs[1])
        add_hop1_counts((1, 0))
        return weighted_hop_forward(x, w, csrs[0], num_nodes)

    @staticmethod
    def backward(ctx, g):
        need_x, need_w = ctx.needs_input_grad[:2]
        with _counters.span("astgcn.hop1_grad"):
            if g.device.type == "cpu":
                x, w, senders, receivers = ctx.saved_tensors
                gx, gw, formed = plain_backward(g, x, w, senders, receivers,
                                                need_x, need_w)
                add_hop1_counts((1, formed))
            else:
                x, w, *csr = ctx.saved_tensors
                add_hop1_counts((1, 0))
                gx, gw = weighted_hop_backward(g, x, w, HopCSR(*csr),
                                               need_x, need_w)
        return gx, gw, None, None, None, None


def _weighted_hop(rev: Graph, x: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Per-batch weighted aggregation: out[b, t, r] = Σ_{s->r} w[b, e] ·
    x[b, t, s] for x (B, T, N, F) and w (B, E) (:class:`_WeightedHop`)."""
    with _counters.span("astgcn.hop1"):
        csrs = None if x.device.type == "cpu" else hop_csrs(rev)
        return _WeightedHop.apply(x, w, rev.senders, rev.receivers,
                                  rev.num_nodes, csrs)


class _BlockTail(torch.autograd.Function):
    """A stride-1 block's tail (``ops/block_tail.py``): the time and
    residual convolutions as GEMMs on the rows of xh (B, T, N, C_in) and
    xt (B, T, N, F) into one buffer ``pre``, then ReLU(pre + both biases) and
    flax's LayerNorm in one pass, the kernel on the card and the plain
    version on the CPU; y (B, T, N, C).  The backward saves ``pre``, each
    row's statistics and the inputs the GEMMs read, and makes the gradient
    of ``pre`` in one pass, which both convolutions' gradients read."""

    @staticmethod
    def forward(ctx, xh, xt, w_time, b_time, w_res, b_res, gamma, beta,
                eps):
        xh, xt_rows = block_tail.contiguous(xh), block_tail.rows(xt)
        pre = block_tail.conv_forward(xh, xt_rows, w_time, w_res)
        tail = (block_tail.plain_forward if pre.device.type == "cpu"
                else block_tail.block_tail_forward)
        y, stats = tail(pre, b_time, b_res, gamma, beta, eps)
        ctx.save_for_backward(xh, xt_rows, w_time, b_time, w_res, b_res,
                              gamma, pre, stats)
        ctx.eps, ctx.xt_shape = eps, xt.shape
        return y.view(xh.shape[:3] + (y.shape[1],))

    @staticmethod
    def backward(ctx, g):
        xh, xt_rows, w_time, b_time, w_res, b_res, gamma, pre, stats = (
            ctx.saved_tensors)
        need = ctx.needs_input_grad
        tail = (block_tail.plain_backward if g.device.type == "cpu"
                else block_tail.block_tail_backward)
        g_pre, sums = tail(g, pre, stats, b_time, b_res, gamma, ctx.eps)
        g_xh, g_xt, g_wt, g_wr = block_tail.conv_backward(
            g_pre, xh, xt_rows, w_time, w_res,
            (need[0], need[1], need[2], need[4]))
        if g_xt is not None:
            g_xt = g_xt.view(ctx.xt_shape)
        g_bias = sums[2]
        return (g_xh, g_xt, g_wt, g_bias if need[3] else None, g_wr,
                g_bias if need[5] else None, sums[0] if need[6] else None,
                sums[1] if need[7] else None, None)


class ChebConvAttention(FlaxModule):
    """Chebyshev conv with spatial-attention-scaled first hop.

    forward: (x (B, T, N, F) or (B, N, F), graph | [graphs], S) -> same
    leading shape with F -> out_channels.  ``S`` is either a dense
    (B, N, N) attention matrix or an :class:`EdgeScores` (sparse form).

    ``mode``: 'dense' | 'edge' | 'auto'.  Dense is one (N, N) einsum per
    hop; edge keeps L̂ sparse and scales the per-edge norm by the gathered
    attention — equal to dense given the same S, and the only mode that
    runs at large N.  'auto' picks edge when N exceeds the dense threshold
    or when S arrives as EdgeScores.
    """

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 normalization: Optional[str] = "sym", use_bias: bool = True,
                 mode: str = "auto", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.K, self.normalization, self.mode = K, normalization, mode
        self.weight = nn.Parameter(
            glorot((K, in_channels, out_channels), generator, device))
        self.bias = (nn.Parameter(uniform((out_channels,), generator, device))
                     if use_bias else None)

    def _edge_mode(self, n: int, s) -> bool:
        if self.mode in ("dense", "edge"):
            return self.mode == "edge"
        if isinstance(s, EdgeScores):
            return True
        return n > get_config().dense_threshold

    def _combine(self, tax0, hop1, hop):
        """Σ_k T_k W_k with T_1 = ``hop1`` and T_k = 2·hop(T_{k-1}) −
        T_{k-2}."""
        w = self.weight
        out = tax0 @ w[0]
        if self.K > 1:
            tax1 = hop1()
            out = out + tax1 @ w[1]
            for k in range(2, self.K):
                tax2 = 2.0 * hop(tax1).to(tax1.dtype) - tax0
                out = out + tax2 @ w[k]
                tax0, tax1 = tax1, tax2
        return out

    def _edge_path(self, x, graph, s):
        """Sparse-L̂ evaluation; x (B, T, N, F) -> (B, T, N, C)."""
        graph = getattr(graph, "graph", graph)  # PreparedGraph -> its Graph
        lhat = _lhat_graph(graph, self.normalization)
        # einsum('ij,btjf->btif', L, v) aggregates INTO the sender side of
        # the L̂ edge list: spmm on the reversed graph computes exactly that
        rev = _reversed(lhat)
        if isinstance(s, EdgeScores):
            e, n = graph.num_edges, graph.num_nodes
            pad = lhat.senders.shape[0] - (e + 2 * n)
            # L̂ layout: [orig E, lap-diag N, −1-loop N, padding] — both
            # diagonal entry groups read the per-node self score, as the
            # dense path reads S[b, i, i] twice
            s_edge = torch.cat(
                [s.edge[:, :e], s.diag, s.diag,
                 s.edge.new_zeros((s.edge.shape[0], pad))], dim=1)
            s_diag = s.diag
        else:
            s_edge = s[:, lhat.senders, lhat.receivers]  # (B, E_lhat)
            s_diag = torch.diagonal(s, dim1=1, dim2=2)
        tax0 = x * s_diag[:, None, :, None]
        w_e = rev.masked_weights()
        return self._combine(
            tax0, lambda: _weighted_hop(rev, tax0, w_e * s_edge),
            lambda v: spmm(rev, v))

    def forward(self, x: torch.Tensor, graph,
                spatial_attention) -> torch.Tensor:
        squeeze_t = x.dim() == 3
        if squeeze_t:
            x = x[:, None]  # (B, 1, N, F)
        s = spatial_attention  # (B, N, N) or EdgeScores
        per_step = isinstance(graph, (list, tuple))
        if self._edge_mode(x.shape[2], s) and not per_step:
            out = self._edge_path(x, graph, s)
        else:
            if isinstance(s, EdgeScores):
                raise ValueError(
                    "EdgeScores attention requires edge mode with a single "
                    "Graph (per-step graph lists run the dense path)"
                )
            tax0 = x * torch.diagonal(s, dim1=1, dim2=2)[:, None, :, None]
            if per_step:
                lap = torch.stack(
                    [_lhat_dense(g, self.normalization) for g in graph])
                out = self._combine(
                    tax0,
                    lambda: torch.einsum("tij,bij,btjf->btif", lap, s, tax0),
                    lambda v: torch.einsum("tij,btjf->btif", lap, v))
            else:
                lap = _lhat_dense(graph, self.normalization)  # (N, N)
                out = self._combine(
                    tax0,
                    lambda: torch.einsum("ij,bij,btjf->btif", lap, s, tax0),
                    lambda v: torch.einsum("ij,btjf->btif", lap, v))
        if self.bias is not None:
            out = out + self.bias
        return out[:, 0] if squeeze_t else out


class SpatialAttention(FlaxModule):
    """S = softmax_rows(Vs · σ(LHS·RHS + bs)) over (B, N, N)."""

    def __init__(self, in_channels: int, num_of_vertices: int,
                 num_of_timesteps: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        F_, N, T = in_channels, num_of_vertices, num_of_timesteps
        self.W1 = nn.Parameter(uniform((T,), generator, device))
        self.W2 = nn.Parameter(glorot((F_, T), generator, device))
        self.W3 = nn.Parameter(uniform((F_,), generator, device))
        self.bs = nn.Parameter(glorot((1, N, N), generator, device))
        self.Vs = nn.Parameter(glorot((N, N), generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, N, F, T)
        lhs = torch.einsum("bnft,t->bnf", x, self.W1) @ self.W2  # (B, N, T)
        rhs = torch.einsum("f,bnft->btn", self.W3, x)
        s = self.Vs @ torch.sigmoid(lhs @ rhs + self.bs)
        return torch.softmax(s, dim=1)


class SpatialAttentionSparse(FlaxModule):
    """Edge-restricted spatial attention producing :class:`EdgeScores`.

    The sparse counterpart of :class:`SpatialAttention` for large graphs:
    the same factored bilinear form ``lhs[b, i] · rhs[b, j]`` is evaluated
    ONLY at graph edge pairs plus the diagonal, passed through a sigmoid,
    and normalized with a segment softmax over each column j's incident
    entries — the dense module's ``softmax(dim=1)`` restricted to the
    support ChebConvAttention reads.

    Documented deviation from the dense module: the (N, N) ``Vs``
    row-mixing and (N, N) ``bs`` bias are dense by construction; this
    module replaces them with a scalar bias.
    """

    def __init__(self, in_channels: int, num_of_timesteps: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        F_, T = in_channels, num_of_timesteps
        self.W1 = nn.Parameter(uniform((T,), generator, device))
        self.W2 = nn.Parameter(glorot((F_, T), generator, device))
        self.W3 = nn.Parameter(uniform((F_,), generator, device))
        self.bs = nn.Parameter(uniform((1,), generator, device))

    def forward(self, x: torch.Tensor, graph) -> EdgeScores:
        # x: (B, N, F, T)
        graph = getattr(graph, "graph", graph)  # PreparedGraph
        lhs = torch.einsum("bnft,t->bnf", x, self.W1) @ self.W2  # (B, N, T)
        rhs = torch.einsum("f,bnft->bnt", self.W3, x)            # (B, N, T)
        i, j = graph.senders, graph.receivers
        raw_e = torch.sigmoid(
            (lhs.index_select(1, i) * rhs.index_select(1, j)).sum(-1)
            + self.bs)                                           # (B, E_pad)
        raw_d = torch.sigmoid((lhs * rhs).sum(-1) + self.bs)     # (B, N)
        # segment softmax over column j (edges into j + the diagonal entry)
        mask = graph.edge_mask(raw_e.dtype)
        cols = j[None].expand(raw_e.shape)
        masked = torch.where(mask > 0, raw_e.detach(),
                             raw_e.new_full((), -1e30))
        m = raw_d.detach().scatter_reduce(1, cols, masked, "amax",
                                          include_self=True)     # (B, N)
        exp_e = torch.exp(raw_e - m.index_select(1, j)) * mask
        exp_d = torch.exp(raw_d - m)
        denom = exp_d.index_add(1, j, exp_e)
        return EdgeScores(edge=exp_e / denom.index_select(1, j),
                          diag=exp_d / denom)


def _vector(n: int, init: str, generator, device) -> torch.Tensor:
    """A (n,) attention vector: "uniform" U[0, 1) (PGT's), "glorot" Glorot
    over (n, 1).  Both draw the same n numbers from ``generator``."""
    if init == "uniform":
        return uniform((n,), generator, device)
    if init == "glorot":
        return glorot((n, 1), generator, device).reshape(n)
    raise ValueError(f"vector_init must be 'uniform' or 'glorot'; got "
                     f"{init!r}")


class TemporalAttention(FlaxModule):
    """E = softmax(Ve · σ(LHS·RHS + be)) over (B, T, T).

    ``vector_init`` draws U1 (N,) and U3 (F,): "uniform" is PGT's U[0, 1);
    "glorot" is Glorot over (length, 1).  The logits LHS·RHS sum
    x·U1·U2·U3·x over every node twice, so with U[0, 1) on a large graph
    (N ≈ 10⁴) they reach 10⁴–10⁶, the sigmoid saturates, and the gradient
    comes from the few logits at its knee, where f32 rounding of so large a
    sum moves it by percents: two f32 evaluations of the first gradient
    then differ as much as either differs from float64.  Glorot vectors
    keep the logits within tens at any N."""

    def __init__(self, in_channels: int, num_of_vertices: int,
                 num_of_timesteps: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 vector_init: str = "uniform"):
        super().__init__()
        device = resolve_device(device)
        F_, N, T = in_channels, num_of_vertices, num_of_timesteps
        self.U1 = nn.Parameter(_vector(N, vector_init, generator, device))
        self.U2 = nn.Parameter(glorot((F_, N), generator, device))
        self.U3 = nn.Parameter(_vector(F_, vector_init, generator, device))
        self.be = nn.Parameter(glorot((1, T, T), generator, device))
        self.Ve = nn.Parameter(glorot((T, T), generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, N, F, T)
        lhs = torch.einsum("bnft,n->btf", x, self.U1) @ self.U2  # (B, T, N)
        rhs = torch.einsum("f,bnft->bnt", self.U3, x)
        e = self.Ve @ torch.sigmoid(lhs @ rhs + self.be)
        return torch.softmax(e, dim=1)


class ASTGCNBlock(FlaxModule):
    """temporal attn → spatial attn → attention ChebConv → time conv +
    residual + LayerNorm.  I/O layout (B, N, F, T).

    With ``time_strides`` 1 and ``nb_time_filter`` a width the tail's
    kernel takes (a multiple of 4 up to 128, ``ops/block_tail.py``
    ``takes``), the tail runs in the Chebyshev output's (B, T, N, C)
    layout (:class:`_BlockTail`): the convolutions as GEMMs, the residual
    add, ReLU and LayerNorm in one pass each way, and no layout copy; the
    output is the (B, N, C, T) view of a (B, T, N, C) tensor, so the next
    block's (B, T, N, F) input is contiguous.  Any other stride or width
    keeps the flax ``Conv`` and ``LayerNorm`` modules' formulation; either
    way the parameters are the same."""

    def __init__(self, in_channels: int, K: int, nb_chev_filter: int,
                 nb_time_filter: int, time_strides: int,
                 num_of_vertices: int, num_of_timesteps: int,
                 normalization: Optional[str] = None, use_bias: bool = True,
                 attention_mode: str = "dense", device=None,
                 generator: Optional[torch.Generator] = None,
                 temporal_vector_init: str = "uniform"):
        super().__init__()
        self.attention_mode = attention_mode
        self.temporal_attention = TemporalAttention(
            in_channels, num_of_vertices, num_of_timesteps, device, generator,
            temporal_vector_init)
        if attention_mode == "edge":
            self.spatial_attention = SpatialAttentionSparse(
                in_channels, num_of_timesteps, device, generator)
        else:
            self.spatial_attention = SpatialAttention(
                in_channels, num_of_vertices, num_of_timesteps, device,
                generator)
        self.chebconv_attention = ChebConvAttention(
            in_channels, nb_chev_filter, K, normalization, use_bias,
            mode="edge" if attention_mode == "edge" else "auto",
            device=device, generator=generator)
        self.time_convolution = Conv(
            nb_chev_filter, nb_time_filter, (1, 3),
            strides=(1, time_strides), padding=((0, 0), (1, 1)),
            device=device, generator=generator)
        self.residual_convolution = Conv(
            in_channels, nb_time_filter, (1, 1), strides=(1, time_strides),
            device=device, generator=generator)
        self.layer_norm = LayerNorm(nb_time_filter, device=device)
        self.fused_tail = time_strides == 1 and block_tail.takes(
            nb_time_filter)

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        span = _counters.span
        with span("astgcn.temporal_attention"):
            e = self.temporal_attention(x)
            x_tilde = torch.einsum("bnft,bts->bnfs", x, e)
        with span("astgcn.spatial_attention"):
            if self.attention_mode == "edge":
                g0 = graph[0] if isinstance(graph, (list, tuple)) else graph
                s = self.spatial_attention(x_tilde, g0)
            else:
                s = self.spatial_attention(x_tilde)
        xt = x.movedim(-1, 1)  # (B, T, N, F)
        with span("astgcn.cheb"):
            x_hat = torch.relu(self.chebconv_attention(xt, graph, s))
        with span("astgcn.time_conv"):
            if self.fused_tail:
                tc, rc, ln = (self.time_convolution,
                              self.residual_convolution, self.layer_norm)
                out = _BlockTail.apply(
                    x_hat, xt, tc.kernel, tc.bias, rc.kernel, rc.bias,
                    ln.scale, ln.bias, ln.epsilon)
                return out.permute(0, 2, 3, 1)  # (B, N, C, T)
            # time conv over T: layout (B, N, T, C); the residual conv and
            # the LayerNorm
            x_hat = self.time_convolution(x_hat.transpose(1, 2))
            res = self.residual_convolution(x.movedim(-1, 2))
            out = self.layer_norm(torch.relu(res + x_hat))
        return out.movedim(2, -1)  # (B, N, C, T')


class ASTGCN(FlaxModule):
    """forward: (X (B, N, F_in, T_in), graph | [graphs]) -> (B, N, T_out).

    ``attention_mode``: 'dense' (O(N²)), 'edge' (sparse L̂ + per-edge
    attention, no (N, N) tensors — the large-graph mode), or 'auto' (edge
    above the dense threshold).  ``temporal_vector_init``: each block's
    temporal-attention vectors U1, U3, PGT's "uniform" or "glorot", the
    one that stays well conditioned on large graphs
    (:class:`TemporalAttention`).
    """

    def __init__(self, nb_block: int, in_channels: int, K: int,
                 nb_chev_filter: int, nb_time_filter: int, time_strides: int,
                 num_for_predict: int, len_input: int, num_of_vertices: int,
                 normalization: Optional[str] = None, use_bias: bool = True,
                 attention_mode: str = "auto", device=None,
                 generator: Optional[torch.Generator] = None,
                 temporal_vector_init: str = "uniform"):
        super().__init__()
        device = resolve_device(device)
        self.len_input, self.nb_block = len_input, nb_block
        mode = attention_mode
        if mode == "auto":
            mode = ("edge" if num_of_vertices > get_config().dense_threshold
                    else "dense")
        self.block_0 = ASTGCNBlock(
            in_channels, K, nb_chev_filter, nb_time_filter, time_strides,
            num_of_vertices, len_input, normalization, use_bias, mode,
            device, generator, temporal_vector_init)
        for i in range(1, nb_block):
            self.add_module(f"block_{i}", ASTGCNBlock(
                nb_time_filter, K, nb_chev_filter, nb_time_filter, 1,
                num_of_vertices, len_input // time_strides, normalization,
                use_bias, mode, device, generator, temporal_vector_init))
        final_conv(self, num_for_predict, len_input // time_strides,
                   nb_time_filter, device, generator)

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        check_rank(x, "ASTGCN", "(B, N, F_in, T_in)", 4)
        g0 = graph[0] if isinstance(graph, (list, tuple)) else graph
        check_node_axis(x, g0, "ASTGCN", "(B, N, F_in, T_in)", axis=1)
        if x.shape[-1] != self.len_input:
            raise ValueError(
                f"ASTGCN expects T_in == len_input ({self.len_input}); got "
                f"trailing axis {x.shape[-1]} (shape {tuple(x.shape)})."
            )
        for i in range(self.nb_block):
            x = getattr(self, f"block_{i}")(x, graph)
        # the head: one GEMM over each (b, n)'s T·F values, so its gradient
        # comes back with each (b, t, n) row's F values contiguous, as the
        # fused tail reads it, whatever the loss's gradient's layout
        b, n, f, t = x.shape
        rows = x.permute(0, 1, 3, 2).reshape(b * n, t * f)
        out = rows @ self.final_conv_w.reshape(-1, t * f).t()
        return out.view(b, n, -1) + self.final_conv_b
