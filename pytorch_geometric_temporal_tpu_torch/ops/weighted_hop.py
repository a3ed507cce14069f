"""A weighted hop with a weight per batch and entry:

    out[b, t, r] = Σ_{e: s_e -> r} w[b, e] · x[b, t, s_e]

for x (B, T, N, F) and w (B, E), over a graph's edge list.  Edge-mode
ASTGCN's hop 1 is one (``models/attention/astgcn.py`` ``_WeightedHop``):
its attention scales each entry of L̂ by batch, so no tiled operator
applies.

- On the card, ``csrc/weighted_hop.cu``: a segment sum by receiver
  forward (:func:`weighted_hop_forward`) and one pass by sender backward
  (:func:`weighted_hop_backward`, g_x and g_w) over CSR orders of the
  entries (:class:`HopCSR`, built once per graph instance by
  :func:`hop_csrs`).  Each (b, node) row is read as T·F contiguous values,
  t-major ("dense rows"); an operand whose rows lie otherwise is copied
  once into dense rows (:func:`as_rows`), and the bytes are counted.  The
  output's rows are written into an (N, B, T, F) buffer, which a batched
  GEMM over its (B·T, N, F) view and ``bcsr_spmm``'s flattening read
  without a copy.  No message is formed and nothing is added atomically.
- On the CPU, the plain version (:func:`plain_forward`,
  :func:`plain_backward`): per-edge messages formed a few time steps at a
  time and not kept.

The counter ``weighted_hop`` holds the kernel's launches, forward and
backward, and the bytes copied into dense rows (``_counters``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _counters
from .bcsr import launch
from .graph import Graph, _memo

# elements of one chunk of the plain version's per-edge messages (1 GiB of
# f32)
_MESSAGE_CHUNK = 1 << 28


class HopCSR(NamedTuple):
    """One CSR order of the entries of an edge list: the entries of row
    ``i`` are ``ptr[i] .. ptr[i + 1]``, each with the node at its other end
    (``other``) and its index in the edge list (``entry``), in the list's
    order within a row.  int32, on the list's device."""

    ptr: torch.Tensor
    other: torch.Tensor
    entry: torch.Tensor


def hop_csr(rows: torch.Tensor, others: torch.Tensor,
            num_rows: int) -> HopCSR:
    """The entries ordered by ``rows`` (stable), on the device."""
    order = torch.argsort(rows, stable=True)
    ptr = torch.searchsorted(
        rows[order], torch.arange(num_rows + 1, dtype=rows.dtype,
                                  device=rows.device))
    return HopCSR(ptr.int(), others[order].int(), order.int())


def hop_csrs(graph: Graph) -> tuple:
    """(by receiver, by sender) CSR orders of ``graph``'s entries, once per
    instance (:func:`~.graph._memo`)."""
    return _memo(graph, ("hop_csr",), lambda: (
        hop_csr(graph.receivers, graph.senders, graph.num_nodes),
        hop_csr(graph.senders, graph.receivers, graph.src_count)))


# the values a lane holds that the kernel is built for, by values a unit:
# 16-byte units, or single values (rows off the 16-byte grid)
_UNITS = {4: (1, 2, 4, 6, 8), 1: (8,)}


def dense_rows(t: torch.Tensor) -> bool:
    """Each (b, node) row of the (B, T, N, F) tensor ``t`` is T·F
    contiguous values, t-major."""
    _, T, _, F = t.shape
    return (F == 1 or t.stride(3) == 1) and (T == 1 or t.stride(1) == F)


def empty_rows(like: torch.Tensor, n: int) -> torch.Tensor:
    """An uninitialized (B, T, n, F) tensor like ``like`` with dense rows in
    an (n, B, T, F) buffer."""
    B, T, _, F = like.shape
    return like.new_empty((n, B, T, F)).permute(1, 2, 0, 3)


def as_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` where its rows are dense (:func:`dense_rows`), else a copy
    with dense rows, counted in ``weighted_hop_forward.copied`` (a block's
    T_0 lies (B, F, N, T) or (B, T, N, F): runs of T or F values with gaps
    between them)."""
    if dense_rows(t):
        return t
    rows = empty_rows(t, t.shape[2]).copy_(t)
    weighted_hop_forward.copied += rows.numel() * rows.element_size()
    return rows


def hop_plan(p: int, aligned: bool) -> tuple:
    """(vec, units, chunk, chunks) of a launch over rows of ``p`` values:
    16-byte units (vec 4) where every row lies on the 16-byte grid, else
    single values; a lane holds ``units`` of them, so a row longer than a
    warp holds (32 · vec · 8 values) is walked in ``chunks`` runs of
    ``chunk`` values, the last shorter, each starting on a unit."""
    vec = 4 if aligned else 1
    most = 32 * vec * _UNITS[vec][-1]
    even = -(-p // max(1, -(-p // most)))
    chunk = max(vec, -(-even // vec) * vec)
    units = -(-chunk // (32 * vec))
    return (vec, next(u for u in _UNITS[vec] if u >= units), chunk,
            -(-p // chunk))


def _aligned(p: int, *rows) -> bool:
    """Rows of ``p`` values on the 16-byte grid in every tensor: its
    start, its batch stride and its node stride."""
    return p % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0
        and t.stride(2) % 4 == 0 for t in rows)


def _row_strides(t: torch.Tensor) -> tuple:
    return t.stride(0), t.stride(2)


def check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Refuse what the kernel does not take: f32 alone, on a CUDA device."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"weighted_hop: the kernel takes f32, got x "
                        f"{x.dtype} and w {w.dtype}")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"weighted_hop: no kernel for x on {x.device} and "
                         f"w on {w.device}")
    if x.shape[0] > 65535:
        raise ValueError(f"weighted_hop: batch {x.shape[0]} exceeds the "
                         "grid's 65,535")


def weighted_hop_forward(x: torch.Tensor, w: torch.Tensor, csr: HopCSR,
                         num_nodes: int) -> torch.Tensor:
    """The hop on the card (``pgtt_weighted_hop_fwd``) for x
    (B, T, N_src, F) and w (B, E) in f32, ``csr`` the entries by receiver:
    (B, T, num_nodes, F) with dense rows in an (N, B, T, F) buffer."""
    check(x, w)
    x = as_rows(x)
    out = empty_rows(x, num_nodes)
    p = x.shape[1] * x.shape[3]
    vec, units, chunk, chunks = hop_plan(p, _aligned(p, x, out))
    launch(weighted_hop_forward, "pgtt_weighted_hop_fwd", x, x.data_ptr(),
           *_row_strides(x), w.data_ptr(), *w.stride(), csr.ptr.data_ptr(),
           csr.other.data_ptr(), csr.entry.data_ptr(), out.data_ptr(),
           *_row_strides(out), x.shape[0], num_nodes, p, chunk, chunks, vec,
           units)
    return out


def weighted_hop_backward(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                          csr: HopCSR, need_x: bool, need_w: bool) -> tuple:
    """The hop's gradients on the card (``pgtt_weighted_hop_bwd``), one
    pass by sender (``csr``): g_x[b, t, u] = Σ_{e: u -> r_e} w[b, e] ·
    g[b, t, r_e] with dense rows, g_w[b, e] = Σ_{t, f} g[b, t, r_e] ·
    x[b, t, u]; None for an output not needed."""
    check(x, w)
    if not (need_x or need_w):
        return None, None
    g, x = as_rows(g), as_rows(x)
    gx = empty_rows(g, x.shape[2]) if need_x else None
    gw = w.new_empty(w.shape) if need_w else None
    p = g.shape[1] * g.shape[3]
    vec, units, chunk, chunks = hop_plan(
        p, _aligned(p, g, x, *([gx] if need_x else [])))
    launch(weighted_hop_backward, "pgtt_weighted_hop_bwd", x, g.data_ptr(),
           *_row_strides(g), x.data_ptr(), *_row_strides(x), w.data_ptr(),
           *w.stride(), csr.ptr.data_ptr(), csr.other.data_ptr(),
           csr.entry.data_ptr(), gx.data_ptr() if need_x else None,
           *(_row_strides(gx) if need_x else (0, 0)),
           gw.data_ptr() if need_w else None, w.shape[1], x.shape[0],
           x.shape[2], p, chunk, chunks, vec, units)
    return gx, gw


weighted_hop_forward.launches = 0
# bytes of operands copied into dense rows, forward and backward
weighted_hop_forward.copied = 0
weighted_hop_backward.launches = 0


def weighted_hop_counts() -> tuple:
    """(forward launches, backward launches, bytes copied into dense
    rows) of the kernel."""
    return (weighted_hop_forward.launches, weighted_hop_backward.launches,
            weighted_hop_forward.copied)


def add_weighted_hop_counts(delta) -> None:
    """Add ``delta`` (a :func:`weighted_hop_counts` tuple), as the captured
    steps do at each replay (``_counters``)."""
    weighted_hop_forward.launches += delta[0]
    weighted_hop_backward.launches += delta[1]
    weighted_hop_forward.copied += delta[2]


_counters.register("weighted_hop", weighted_hop_counts,
                   add_weighted_hop_counts)


def _steps(x: torch.Tensor, num_edges: int) -> int:
    """Time steps of the plain version's per-edge messages formed at a
    time."""
    B, _, _, F = x.shape
    return max(1, _MESSAGE_CHUNK // max(B * num_edges * F, 1))


def plain_forward(x, w, senders, receivers, num_nodes) -> tuple:
    """The plain version: (out, bytes of per-edge messages formed), the
    messages formed a few time steps at a time and not kept."""
    # a block's T_0 lies (B, F, N, T): gathered as it is, each edge's F
    # values would lie N·T apart
    xc = x.contiguous()
    step = _steps(x, w.shape[1])
    wv = w[:, None, :, None]
    outs, formed = [], 0
    for lo in range(0, x.shape[1], step):
        xt = xc[:, lo:lo + step]
        msgs = xt.index_select(2, senders).mul_(wv)
        formed += msgs.numel() * msgs.element_size()
        outs.append(xt.new_zeros(xt.shape[:2] + (num_nodes, x.shape[3]))
                    .index_add_(2, receivers, msgs))
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)), formed


def plain_backward(g, x, w, senders, receivers, need_x, need_w) -> tuple:
    """The plain version's gradients: (g_x, g_w, bytes of messages
    formed), each chunk gathered again."""
    x, g = x.contiguous(), g.contiguous()
    gx = torch.zeros_like(x) if need_x else None
    gw = torch.zeros_like(w) if need_w else None
    step = _steps(x, w.shape[1])
    wv = w[:, None, :, None]
    formed = 0
    for lo in range(0, x.shape[1], step):
        gg = g[:, lo:lo + step].index_select(2, receivers)
        formed += gg.numel() * gg.element_size()
        if need_w:
            # Σ over t and f of g[r_e] · x[s_e]
            xs = x[:, lo:lo + step].index_select(2, senders)
            formed += xs.numel() * xs.element_size()
            gw += xs.mul_(gg).sum((1, 3))
        if need_x:
            gx[:, lo:lo + step].index_add_(2, senders, gg.mul_(wv))
    return gx, gw, formed
