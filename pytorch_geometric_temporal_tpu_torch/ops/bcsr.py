"""Block-sparse (BCSR) aggregation operator and its two CUDA kernels.

Port of the JAX package's ``ops/bcsr.py``.  The aggregation matrix
``M[r, s] = w(s→r)`` of a large graph is cut into 128×128 tiles; tiles with
at least ``min_block_edges`` edges are stored dense, and the edges of
sparser tiles spill to a COO *remainder* grouped by row block.  The
host-side construction (:meth:`BCSRMatrix.from_graph`, ``_build_half`` and
its helpers) makes only what the kernels and their plain versions read:
the tiles, their coordinates and row pointers, the remainder unpadded (by
row block and by row), the fused kernel's item list and the walked tiles'
nonzero lists.

One fused kernel applies one half of the operator
(``csrc/hybrid_spmm.cu``, replaces both ``_tile_kernel_call`` and
``_rem_scatter_call`` with its ``x[rem_cols]`` gather):

- **hybrid SpMM** (:func:`hybrid_spmm`): ``out = tiles @ x + remainder``,
  the tile products of each row block and then each row's remainder edges
  in ascending column order, summed in f32 and written once; rows without
  tiles or edges come out zero.  An f32 tile of few nonzeros is walked
  through its nonzero lists (:func:`_walk_lists`) instead of multiplied
  densely, with the same bits for finite x.

The port's first two kernels (``csrc/bcsr_kernels.cu``) stay beside it as
its baseline, off the main path:

- **K1, tile SpMM** (:func:`tile_spmm`): ``out[rb] = Σ_t blocks[t] @
  x[block_cols[t]]`` over the row-sorted tiles of each row block.
- **K2, remainder scatter** (:func:`rem_scatter_`):
  ``out[rb·128 + lrow] += val · x[col]`` over each row block's remainder
  edges, in place on K1's output.

Each wrapper launches its kernel for a CUDA tensor and counts the launch;
for a CPU tensor it runs the plain PyTorch version beside it
(:func:`hybrid_spmm_plain`, :func:`tile_spmm_plain`,
:func:`rem_scatter_plain`), which the tests and ``chip_smoke.py`` hold the
kernels against.  In the bf16 path x is cast to bf16 and the remainder
values are rounded to bf16, as in the Pallas kernels.

Gradients (:class:`_BCSRSpmm`): ``d/dX spmm(M, X) = spmm(Mᵀ, ḡ)`` runs the
same kernel on the transposed half built with the operator.  Block values
are constants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _counters
from .graph import Graph

BLOCK = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _is_bf16(dtype) -> bool:
    return dtype == torch.bfloat16


@dataclasses.dataclass(frozen=True)
class _BCSRHalf:
    """One direction of the hybrid block-sparse operator, on one device.

    Tile fields: ``blocks`` holds the ``nnzb`` real tiles plus one trailing
    all-zero tile (the fused kernel encodes its tiles' TMA map over
    ``blocks.shape[0]`` tiles, which must be at least one: a half whose
    edges all spilled has none of its own), ``block_rows`` /
    ``block_cols`` their row-sorted coordinates, and ``tile_ptr``
    (num_rows/128 + 1) the row pointers K1 walks.

    Remainder fields (the ``num_rem`` edges, sorted by (row block, col),
    without padding): ``rem_cols`` gather sources, ``rem_vals`` edge values
    and ``rem_lrows`` rows within the row block, all (num_rem,);
    ``rem_rbs`` (R,) the distinct row blocks that own remainder edges and
    ``rem_ptr`` (R+1,) their edge pointers, which K2 walks.  The same edges
    sorted by (row, col) — a stable re-sort, so each row keeps its edge
    order — are what the fused kernel walks: ``rem_row_cols``,
    ``rem_row_vals`` (num_rem,) and ``rem_row_ptr`` (num_rows + 1,).

    The fused kernel's item list (:func:`_kernel_items`): ``items`` (B +
    K, 8) int32 descriptors (first row, rows, first and end tile, first and
    end remainder edge, two zeros), the first ``num_block_items`` = B of
    them the row blocks it walks whole, ascending — those that keep tiles
    and those with neither tiles nor remainder edges — the other K its
    remainder-only tasks, which cut the other row blocks into about equal
    remainder edges (``block_rbs`` and ``rem_tasks`` read them back).

    The walked tiles' nonzeros (f32 tiles only, :func:`_walk_lists`):
    ``walk_ptr`` (nnzb·4 + 1,) int32 bounds, in 16-byte units of
    ``walk_data``, of each (tile, K chunk)'s list — empty for a dense tile
    — and ``num_walked`` the tiles that have lists.

    Index tensors are int32, the kernels' type.
    """

    blocks: torch.Tensor
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    tile_ptr: torch.Tensor
    rem_cols: torch.Tensor
    rem_vals: torch.Tensor
    rem_lrows: torch.Tensor
    rem_rbs: torch.Tensor
    rem_ptr: torch.Tensor
    rem_row_cols: torch.Tensor
    rem_row_vals: torch.Tensor
    rem_row_ptr: torch.Tensor
    items: torch.Tensor
    walk_ptr: torch.Tensor
    walk_data: torch.Tensor
    num_block_items: int
    num_rows: int
    num_cols: int
    nnzb: int
    num_rem: int
    num_walked: int

    @property
    def block_rbs(self) -> torch.Tensor:
        """(B,) int32 the row blocks the fused kernel walks whole."""
        return self.items[:self.num_block_items, 0] // BLOCK

    @property
    def rem_tasks(self) -> torch.Tensor:
        """(K, 2) int32 [first row, end row) of its remainder-only tasks."""
        task = self.items[self.num_block_items:]
        return torch.stack([task[:, 0], task[:, 0] + task[:, 1]], 1)

    @property
    def rem_rows(self) -> torch.Tensor:
        """(num_rem,) global row of each remainder edge."""
        rbs = torch.repeat_interleave(self.rem_rbs.long(),
                                      torch.diff(self.rem_ptr).long())
        return rbs * BLOCK + self.rem_lrows.long()

    def row_block_layout(self):
        """(kept tiles, remainder edges) of each row block, int64 numpy:
        what the makespan cost model (:func:`cta_loads`) prices."""
        tiles = np.diff(self.tile_ptr.cpu().numpy()).astype(np.int64)
        rems = np.diff(self.rem_row_ptr.cpu().numpy()[::BLOCK])
        return tiles, rems.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class BCSRMatrix:
    """Forward + transposed block-sparse aggregation operator.

    When built with ``reorder=``, ``perm``/``iperm`` hold the node
    relabeling (``perm[new] = old``, padded with identity up to the padded
    row count) and :func:`bcsr_spmm` permutes inputs and un-permutes
    outputs, so callers see the original node ids.
    """

    fwd: _BCSRHalf
    bwd: _BCSRHalf
    num_nodes: int
    perm: Optional[torch.Tensor] = None
    iperm: Optional[torch.Tensor] = None

    @staticmethod
    def from_graph(graph: Graph, dtype=None, min_block_edges=32,
                   expected_f: int = 64, reorder=None,
                   costs: Optional[KernelCosts] = None) -> "BCSRMatrix":
        """Host-side construction from a Graph (aggregation M[r,s] = w),
        on the graph's device, with 128×128 tiles (the kernels' size).

        ``dtype=torch.bfloat16`` stores bf16 tiles (x is then cast to bf16
        in the kernels; accumulation stays f32).  ``min_block_edges``,
        ``expected_f`` and ``reorder`` mean what they mean in the JAX
        package.  Its two layout decisions, ``min_block_edges="auto"`` and
        ``reorder="auto"``, are priced by ``costs`` (default
        :data:`DEFAULT_COSTS`, the :data:`H100` makespan model of the fused
        kernel at width ``expected_f``); ``costs=TPU_V5E`` makes the JAX
        package's decisions.
        """
        block = BLOCK
        device = graph.device
        e = graph.num_edges
        s_all, r_all, w_all = graph.host_edges()
        s = np.asarray(s_all)[:e]
        r = np.asarray(r_all)[:e]
        w = np.asarray(w_all)[:e].copy()
        n = graph.num_nodes
        perm = iperm = None
        if reorder not in (None, "rcm", "auto"):
            raise ValueError(f"reorder must be None|'rcm'|'auto', "
                             f"got {reorder!r}")
        if reorder is not None and n > block and e > 0:
            from ..native import bandwidth_reduction_order

            p = bandwidth_reduction_order(s, r, n)
            ip = np.empty_like(p)
            ip[p] = np.arange(n, dtype=np.int32)
            s_new, r_new = ip[s], ip[r]
            keep = reorder == "rcm" or _reorder_pays_off(
                r, s, r_new, s_new, n, block, dtype, expected_f,
                min_block_edges, costs,
            )
            if keep:
                s, r = s_new, r_new
                n_pad = _round_up(n, block)
                perm = np.concatenate(
                    [p, np.arange(n, n_pad, dtype=np.int32)])
                iperm = np.concatenate(
                    [ip, np.arange(n, n_pad, dtype=np.int32)])
        if min_block_edges == "auto":
            min_block_edges = tune_min_block_edges(
                r, s, n, block, dtype, expected_f, costs=costs)

        def index(a):
            return None if a is None else torch.from_numpy(a).to(
                device, torch.long)

        return BCSRMatrix(
            fwd=_build_half(r, s, w, n, block, dtype, min_block_edges,
                            device=device),
            bwd=_build_half(s, r, w, n, block, dtype, min_block_edges,
                            device=device),
            num_nodes=n,
            perm=index(perm),
            iperm=index(iperm),
        )

    @property
    def density(self) -> float:
        """Kept tiles over the forward half's grid of 128×128 blocks."""
        nb = self.fwd.num_rows // BLOCK
        return self.fwd.nnzb / max(nb * (self.fwd.num_cols // BLOCK), 1)


# the JAX package's earlier public name of the operator
BCSRGraph = BCSRMatrix


# ---------------------------------------------------------------------------
# Cost models of the BCSR builder's two layout decisions: the spill threshold
# (min_block_edges="auto") and whether to keep the RCM order (reorder="auto")
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelCosts:
    """Kernel-time constants of one device, in ns, that the builder prices
    an operator's layout by.  Two forms:

    - **linear** (``sms == 0``), the JAX package's TPU v5e model: a kept
      tile costs ``tile_ns`` (its DMA share scaled by the tile's and x's
      bytes), a spilled edge ``edge_ns``, a row of each of the two per-call
      gathers ``row_ns``; one half (the forward one) is priced.
    - **makespan** (``sms > 0``), ``csrc/hybrid_spmm.cu`` on an NVIDIA card:
      ``sms`` persistent CTAs walk the kernel's item list (see
      :func:`cta_loads`), CTA c the items c, c + G, ... with G = min(items,
      sms).  An item costs ``a + b_tile·t·chunks + b_rem·⌈e/RE⌉`` over
      its kept tiles t and remainder edges e, with the feature tile FT, the K
      chunks a tile and the remainder stage's RE edges as the kernel derives
      them (see :func:`_fused_shape`).  A half costs ``launch`` plus its
      most loaded CTA's sum, floored by its bytes (kept tiles, 8 B a spilled
      edge, x once, the f32 output once) at ``bytes_per_ns``; both halves
      are priced.  ``bf16`` and ``f32`` hold, per tile dtype, (launch, a0,
      a1, b0, b1, r0, r1): a = a0 + a1·FT, b_tile = b0 + b1·FT, b_rem = r0 +
      r1·RE·FT.  ``gather`` is (g0, ns a row, bytes a ns) of one
      permutation gather: g0 + rows·row_ns + bytes/bw.
    """

    name: str
    tile_ns: float = 0.0
    edge_ns: float = 0.0
    row_ns: float = 0.0
    sms: int = 0
    bf16: tuple = ()
    f32: tuple = ()
    gather: tuple = ()
    bytes_per_ns: float = 0.0

    @property
    def makespan(self) -> bool:
        return self.sms > 0


# The JAX package's model, fitted there on a TPU v5e (see its ops/bcsr.py):
# a kept tile at pack=4 is 254 ns a grid step / 4 + 39 ns of DMA a slot; a
# spilled edge ~2 ns of XLA row gather + ~2.9 ns of one-hot scatter, ×1.24
# of chunk padding; a permuted row 2 ns.  Kept so that ``costs=TPU_V5E``
# makes the JAX package's decisions, float for float.
C_TILE_NS = 254.0 / 4 + 39.0
C_EDGE_NS = (2.0 + 2.9) * 1.24
TPU_V5E = KernelCosts("tpu_v5e", tile_ns=C_TILE_NS, edge_ns=C_EDGE_NS,
                      row_ns=2.0)
# Fitted by tools/fit_kernel_costs.py on the warm times of chip_smoke.py's
# phase 23 (the fused kernel on 14 synthetic halves of 0-4 tiles and 0-20,000
# remainder edges a row block, 40 to 300 row blocks, F in {32, 64, 96, 256,
# 768}, bf16 and f32 tiles; x just written, no L2 flush; the gathers at
# 11,264 to 38,400 rows) on an NVIDIA H100 80GB HBM3 at 700.00 W, for the
# kernel whose remainder stages all consumer threads share; in the run they
# were fitted on, median relative error 3.4% over those 140 points, 9.0%
# over six held-out operators of phases 15, 21 and 22, 5.9% over 30
# gathers.  132 SMs; HBM3 at 3.35 TB/s.
H100 = KernelCosts(
    "h100", sms=132, bytes_per_ns=3350.0,
    bf16=(6029.0, 323.0, 17.14, 118.9, 5.496, 453.6, 0.03834),
    f32=(5911.0, 1302.0, 13.4, 280.9, 23.36, 553.4, 0.0),
    gather=(4859.0, 0.5351, 6370.0),
)
# what every build prices by unless given ``costs=`` (looked up at call
# time, so a test may patch it)
DEFAULT_COSTS = H100
# at most this many candidate thresholds a makespan sweep
MAX_THETA_CANDIDATES = 256
# the widest f32 feature tile hybrid_spmm.cu is built with (PGTT_F32_MAX_FT)
F32_MAX_FT = 96
# the remainder edges a remainder-only task of the fused kernel holds at
# most (a longer row is a task of its own): eight to sixteen remainder
# stages, few enough items that a task's two barriers stay small
REM_TASK_EDGES = 1024
# An f32 tile of at most this many nonzeros (22% full) is walked: the fused
# kernel multiplies its nonzeros one by one against the staged x rows
# instead of the dense 128 x 128 block (:func:`_walk_lists`).  Measured on
# an NVIDIA H100 80GB HBM3 at 700 W (tools/walk_cut_sweep.py: 88 row blocks
# of one tile, cold L2): the dense path takes 21 us at F=96 and 33 us at
# F=256 whatever the fill; the walked one, fitted over 128 to 7,680
# nonzeros a tile placed uniformly, 13.0 and 17.4 us plus 2.1 and 4.1 us
# for each 1,024, crossing the dense one at 4,016 and 3,950 nonzeros (in
# a band near the diagonal: 4,759 and 4,582).  The cut sits under each.
F32_WALK_MAX_NNZ = 3584
# A walked tile's K chunk (32 columns of f32) travels through the stage's
# 16 KB tile slot: its 129 row pointers (u16, padded to WALK_HEAD bytes),
# then (column in the chunk, f32 value) pairs of 8 bytes, so a chunk holds
# at most WALK_CHUNK_NNZ nonzeros; a tile with a fuller chunk stays dense.
WALK_KC = 32
WALK_HEAD = 272
WALK_CHUNK_NNZ = (BLOCK * 128 - WALK_HEAD) // 8


def _costs(costs) -> KernelCosts:
    return DEFAULT_COSTS if costs is None else costs


def _fused_shape(f: int, bf16: bool):
    """(FT, feature tiles, K chunks a tile, RE) of ``hybrid_spmm.cu`` at
    width ``f``: its ``pgtt_hybrid_spmm`` (feature tiles of at most 128
    bf16 or ``F32_MAX_FT`` f32 features, the n-tile count from its
    instantiations) and ``Cfg`` (128-byte K chunks; RE, the remainder
    edges a stage, the largest power of two, at most 128, whose x rows fit
    in a stage's tile and x boxes)."""
    f = max(int(f), 1)
    nft = -(-f // (128 if bf16 else F32_MAX_FT))
    width = -(-f // nft)
    ft = 8 * next((t for t in (1, 2, 4, 5, 6, 8, 12, 16) if 8 * t >= width),
                  16)
    s = 2 if bf16 else 4
    kc = 128 // s
    a_bytes = BLOCK * 128
    b_bytes = -(-ft * s // 128) * kc * 128
    row = -(-ft * s // 16) * 16
    fit = min((a_bytes + b_bytes) // row, 128)
    return ft, nft, BLOCK // kc, 1 << (fit.bit_length() - 1)


def cta_loads(tiles, rems, f: int, bf16: bool, sms: int):
    """What each CTA of one fused-kernel launch walks: ``tiles`` and
    ``rems`` are (C, row blocks) arrays of kept tiles and remainder edges a
    row block, one row a candidate layout.  The kernel's item list, for
    each feature tile in turn: the row blocks walked whole (those that keep
    tiles or hold nothing), then the remainder-only tasks, priced as
    :func:`_task_count` tasks of equal edges for a row block of r edges and
    no tile (:func:`_kernel_items` cuts them at rows).  CTA c takes items
    c, c + G, ... (G = min(items, sms)); an item of e remainder edges runs
    ⌈e / RE⌉ remainder stages.  Returns (items, tile K chunks, remainder
    stages), each (C, sms) summed over a CTA's items (0 past G), and the
    kernel's FT and RE at width ``f``."""
    ft, nft, chunks, re = _fused_shape(f, bf16)
    tiles = np.atleast_2d(np.asarray(tiles, np.float64))
    rems = np.atleast_2d(np.asarray(rems, np.float64))
    whole = (tiles > 0) | (rems == 0)
    k = np.where(whole, 0, _task_count(rems))
    n_whole = whole.sum(1)
    n_items = n_whole + k.sum(1)
    g = np.minimum(n_items * nft, sms)
    # one entry an item of one feature tile: its candidate, its position in
    # the list and its (tile chunks, remainder stages)
    c_w, rb_w = np.nonzero(whole)
    pos_w = (np.cumsum(whole, 1) - 1)[c_w, rb_w]
    c_f, rb_f = np.nonzero(k)
    kk = k[c_f, rb_f]
    first = np.repeat(np.cumsum(kk) - kk, kk)
    pos_t = (np.repeat(n_whole[c_f] + (np.cumsum(k, 1) - k)[c_f, rb_f], kk)
             + np.arange(kk.sum()) - first)
    cand = np.concatenate([c_w, np.repeat(c_f, kk)])
    pos = np.concatenate([pos_w, pos_t])
    weights = (None,
               np.concatenate([tiles[c_w, rb_w] * chunks,
                               np.zeros(len(pos_t))]),
               np.ceil(np.concatenate([rems[c_w, rb_w],
                                       np.repeat(rems[c_f, rb_f] / kk, kk)])
                       / re))
    out = [np.zeros(tiles.shape[0] * sms) for _ in weights]
    for q in range(nft):
        key = cand * sms + (pos + q * n_items[cand]) % g[cand]
        for o, w in zip(out, weights):
            o += np.bincount(key, weights=w, minlength=len(o))
    return (*(o.reshape(-1, sms) for o in out), ft, re)


def fused_kernel_ns(costs: KernelCosts, tiles, rems, f: int, bf16: bool):
    """The makespan model's ns of one fused-kernel launch on the layouts of
    :func:`cta_loads`: launch plus the most loaded CTA's items; (C,) ns,
    not yet floored by bytes (:func:`_half_ns` does that)."""
    launch, a0, a1, b0, b1, r0, r1 = costs.bf16 if bf16 else costs.f32
    n, chunks, stages, ft, re = cta_loads(tiles, rems, f, bf16, costs.sms)
    work = (n * (a0 + a1 * ft) + chunks * (b0 + b1 * ft)
            + stages * (r0 + r1 * re * ft))
    return launch + work.max(1)


def half_bytes(tiles, rems, f: int, bf16: bool):
    """(C,) bytes one half must move on the layouts of :func:`cta_loads`:
    its kept tiles, 8 B a remainder edge, x once in the tiles' type and the
    f32 output once."""
    s = 2 if bf16 else 4
    tiles = np.atleast_2d(tiles)
    rems = np.atleast_2d(rems)
    return (tiles.sum(1) * BLOCK * BLOCK * s + rems.sum(1) * 8
            + tiles.shape[1] * BLOCK * f * (s + 4))


def _half_ns(costs, tiles, rems, f, bf16):
    """:func:`fused_kernel_ns` floored by :func:`half_bytes` at
    ``costs.bytes_per_ns``."""
    return np.maximum(fused_kernel_ns(costs, tiles, rems, f, bf16),
                      half_bytes(tiles, rems, f, bf16) / costs.bytes_per_ns)


def gather_ns(gather, rows: int, f: int, size: int) -> float:
    """One permutation gather of ``rows`` rows of ``f`` elements of
    ``size`` bytes: g0 + rows·row_ns + (read + write bytes)/bw."""
    g0, row_ns, bw = gather
    return g0 + rows * row_ns + 2 * rows * f * size / bw


def _theta_candidates(order, fixed, subsample):
    """The thresholds a sweep prices: ``fixed`` alone, or each distinct
    count of the sorted ``order`` and one past the largest (spill all),
    ``subsample``d to ``MAX_THETA_CANDIDATES`` evenly by rank."""
    if fixed is not None:
        return np.asarray([fixed])
    cands = np.unique(np.concatenate([order, [order[-1] + 1]]))
    if subsample and len(cands) > MAX_THETA_CANDIDATES:
        pick = np.linspace(0, len(cands) - 1, MAX_THETA_CANDIDATES)
        cands = cands[np.unique(np.round(pick).astype(np.int64))]
    return cands


def _makespan_costs(costs, cnt, block_rows, block_cols, nb, bf16, f, cands):
    """(C,) ns of both halves at each candidate threshold: per row block,
    the kept tiles and spilled edges at θ by cumulative sums over the
    (row block, occupancy) histogram; the backward half's row blocks are
    the forward half's column blocks."""
    first_spill = np.searchsorted(cands, cnt, side="right")
    total = np.zeros(len(cands))
    for rb in (block_rows, block_cols):
        key = first_spill * nb + rb
        size = (len(cands) + 1) * nb
        spilled = np.cumsum(np.bincount(key, minlength=size).reshape(
            -1, nb), axis=0)[:-1]
        spilled_edges = np.cumsum(np.bincount(
            key, weights=cnt, minlength=size).reshape(-1, nb), axis=0)[:-1]
        tiles = np.bincount(rb, minlength=nb)[None, :] - spilled
        total += _half_ns(costs, tiles, spilled_edges, f, bf16)
    return total


def tune_min_block_edges(rows, cols, n, block=BLOCK, dtype=None,
                         expected_f: int = 64,
                         tile_ns: Optional[float] = None,
                         edge_ns: Optional[float] = None,
                         max_tile_bytes: int = 1 << 30,
                         _return_cost: bool = False,
                         _fixed_theta=None,
                         costs: Optional[KernelCosts] = None):
    """Pick the tile/COO spill threshold θ (edges of a 128×128 block below
    which they spill to the remainder) from the block-occupancy histogram.

    Candidates are the distinct occupancy counts and one past the largest
    (spill everything); kept tiles are capped at ``max_tile_bytes``.  Under
    ``costs`` (default :data:`DEFAULT_COSTS`):

    - the linear model (:data:`TPU_V5E`): kept_tiles(θ)·tile_ns +
      spilled_edges(θ)·edge_ns over the half ``rows`` receive, θ and cost
      exactly the JAX package's; ``tile_ns`` / ``edge_ns`` override the
      model's own;
    - the makespan model (:data:`H100`): both halves' fused-kernel ns at
      width ``expected_f`` (:func:`fused_kernel_ns`, floored by bytes).
      With more than ``MAX_THETA_CANDIDATES`` distinct counts, that many
      are taken evenly by rank among them, the smallest and the spill-all
      candidate always among them.

    Returns θ, or (θ, cost in ns) with ``_return_cost``;
    ``_fixed_theta`` prices that θ alone.
    """
    from ..native import bcsr_structure

    costs = _costs(costs)
    if costs.makespan and (tile_ns is not None or edge_ns is not None):
        raise ValueError("tile_ns / edge_ns belong to the linear (TPU v5e) "
                         f"cost model, not to {costs.name!r}")
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    n_pad = _round_up(max(n, 1), block)
    nnzb, block_of_edge, block_rows, block_cols = bcsr_structure(
        cols, rows, block, n_pad // block)
    e = len(rows)
    if nnzb == 0 or e == 0:
        return (0, 0.0) if _return_cost else 0
    cnt = np.bincount(block_of_edge, minlength=nnzb)
    s_tile = 2 if _is_bf16(dtype) else 4
    order = np.sort(cnt)
    cands = _theta_candidates(order, _fixed_theta, costs.makespan)
    csum = np.cumsum(order)
    total = csum[-1]
    if costs.makespan:
        cost_of = _makespan_costs(costs, cnt, block_rows, block_cols,
                                  n_pad // block, _is_bf16(dtype),
                                  expected_f, cands)
    else:
        tile_ns = costs.tile_ns if tile_ns is None else tile_ns
        edge_ns = costs.edge_ns if edge_ns is None else edge_ns
        f_eff = (expected_f if expected_f <= 128
                 else _round_up(expected_f, 128))
        dma_scale = (block * block * s_tile + block * f_eff * s_tile) / 49152.0
        t_tile = (tile_ns - 39.0) + 39.0 * dma_scale
    best_theta, best_cost = int(cands[-1]), np.inf
    for j, theta in enumerate(cands):
        k = np.searchsorted(order, theta, side="left")
        kept_tiles = len(order) - k
        kept_edges = total - (csum[k - 1] if k > 0 else 0)
        if kept_tiles * block * block * s_tile > max_tile_bytes:
            continue
        if costs.makespan:
            cost = float(cost_of[j])
        else:
            cost = kept_tiles * t_tile + (e - kept_edges) * edge_ns
        if cost < best_cost:
            best_cost, best_theta = cost, int(theta)
    if _return_cost:
        return best_theta, best_cost
    return best_theta


def _gather_ns(costs, n_pad, dtype, expected_f):
    """The charge for a reordered operator's permutation gathers, ns a
    call: the linear model's input gather and output un-gather at
    ``row_ns`` a row; the makespan model's four of a training hop
    (``_Permute`` in and out, forward and backward), each g0, a charge a
    row (the gather kernel is bound by its row rate at narrow widths) and
    n_pad rows of ``expected_f`` features read and written once, x and its
    gradient in the tiles' dtype, the output and its gradient in f32."""
    if not costs.makespan:
        return 2 * n_pad * costs.row_ns
    s_x = 2 if _is_bf16(dtype) else 4
    return sum(gather_ns(costs.gather, n_pad, expected_f, s)
               for s in (s_x, s_x, 4, 4))


def _reorder_costs(r0, s0, r1, s1, n, block, dtype, expected_f,
                   min_block_edges="auto", costs=None):
    """The cost model's (cost0, cost1, gather_ns) in ns: the caller's
    ordering, the relabeled one, and the charge for the gathers
    (:func:`_gather_ns`), at the threshold the operator will be built with
    (the fixed one, or each ordering's own tuned θ)."""
    costs = _costs(costs)
    fixed = None if min_block_edges == "auto" else int(min_block_edges)
    _, cost0 = tune_min_block_edges(r0, s0, n, block, dtype, expected_f,
                                    _return_cost=True, _fixed_theta=fixed,
                                    costs=costs)
    _, cost1 = tune_min_block_edges(r1, s1, n, block, dtype, expected_f,
                                    _return_cost=True, _fixed_theta=fixed,
                                    costs=costs)
    return cost0, cost1, _gather_ns(costs, _round_up(n, block), dtype,
                                    expected_f)


def _reorder_pays_off(r0, s0, r1, s1, n, block, dtype, expected_f,
                      min_block_edges="auto", costs=None) -> bool:
    """``reorder='auto'``: keep the relabeled ordering only when its cost,
    plus the gathers, beats the caller's (:func:`_reorder_costs`)."""
    cost0, cost1, gather_ns = _reorder_costs(r0, s0, r1, s1, n, block, dtype,
                                             expected_f, min_block_edges,
                                             costs)
    return cost1 + gather_ns < cost0


def bcsr_structure_counts(cols, rows, block, grid_cols):
    """The structure pass alone, no tile filled: ``(nnzb, block_of_edge,
    tile_rows, tile_cols)`` from the native helper."""
    from ..native import bcsr_structure

    return bcsr_structure(cols, rows, block, grid_cols)


def _build_remainder(rows, cols, vals, block):
    """Group remainder edges by row block, sorted by (row block, col): what
    K2 walks, (rbs, ptr, cols, vals, lrows) — the row blocks that own
    edges, their edge pointers, and the edges."""
    order = np.lexsort((cols, rows // block))
    rows, cols, vals = rows[order], cols[order], vals[order]
    rb_of_edge = rows // block
    lrows = (rows - rb_of_edge * block).astype(np.int32)
    rbs, counts = np.unique(rb_of_edge, return_counts=True)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    return (rbs.astype(np.int32), ptr, cols.astype(np.int32),
            vals.astype(np.float32), lrows)


def _task_count(edges):
    """Remainder-only tasks a tile-free row block of ``edges`` edges is cut
    into: shares of at most 7/8 of ``REM_TASK_EDGES``, so that cutting at
    the row nearest a share leaves room under the cap."""
    return -(-np.asarray(edges, np.int64) * 8 // (7 * REM_TASK_EDGES))


def _kernel_items(tile_cnt, rem_row_ptr, block=BLOCK):
    """The fused kernel's item list over one half: (block_rbs, rem_tasks).

    ``block_rbs`` (int32, ascending) are the row blocks it walks whole:
    those that keep tiles (their tiles, then their remainder) and those
    with neither tiles nor remainder edges (written as zeros).  Every other
    row block is cut into remainder-only tasks, ``rem_tasks`` (int32, (K,
    2), [first row, end row)), of about equal edges: a row block of r edges
    into tasks cut in turn, each at the row end nearest to an equal share of
    the edges still left (:func:`_task_count` shares), never past
    ``REM_TASK_EDGES`` edges.  A row is never split, so a row longer than
    that is a task of its own."""
    cap = REM_TASK_EDGES
    ptr = np.asarray(rem_row_ptr, np.int64)
    rems = ptr[block::block] - ptr[:-1:block]
    whole = (np.asarray(tile_cnt) > 0) | (rems == 0)
    tasks = []
    for rb in np.flatnonzero(~whole):
        start, hi = rb * block, (rb + 1) * block
        while start < hi:
            e0, rest = ptr[start], ptr[hi] - ptr[start]
            left = int(_task_count(rest))  # tasks for what is left
            end = hi
            if left > 1:
                want = e0 + rest / left
                end = int(np.searchsorted(ptr, want, "right")) - 1
                end = min(max(end, start), hi - 1)
                # the nearer row end, if it stays under the cap
                if end == start or (ptr[end + 1] - want < want - ptr[end]
                                    and ptr[end + 1] - e0 <= cap):
                    end += 1
            tasks.append((start, end))
            start = end
    return (np.flatnonzero(whole).astype(np.int32),
            np.asarray(tasks, np.int32).reshape(-1, 2))


def _walk_lists(tiles, block_of_edge, rows, cols, block=BLOCK):
    """The nonzeros of the f32 tiles that the fused kernel walks:
    ``(walk_ptr, walk_data, walked)``.

    A tile is walked when it holds at most :data:`F32_WALK_MAX_NNZ`
    nonzeros and each of its K chunks (``WALK_KC`` columns) at most
    :data:`WALK_CHUNK_NNZ`; ``walked`` (nnzb,) bool marks them.  The
    nonzeros are read from the filled ``tiles`` at the edges' positions
    (``tiles[t][row % block, col % block]``), so they are the tile's values
    to the bit.  Each (tile t, chunk kc) of a walked tile has a list
    ``walk_data[walk_ptr[4t + kc]:walk_ptr[4t + kc + 1]]`` (16-byte units;
    ``walk_data`` is int32, four words a unit): 129 u16 pointers, a row's
    nonzeros at [p[row], p[row + 1]), padded to ``WALK_HEAD`` bytes, then
    the nonzeros in (row, column) order as (column in the chunk, f32 bits)
    int32 pairs, padded to a whole unit.  A dense tile's lists are empty."""
    nnzb, cells = len(tiles), block * block
    chunks = block // WALK_KC
    flat = np.unique(np.asarray(block_of_edge, np.int64) * cells
                     + (np.asarray(rows, np.int64) % block) * block
                     + np.asarray(cols, np.int64) % block)
    vals = tiles.reshape(-1)[flat]
    flat, vals = flat[vals != 0], vals[vals != 0]
    tile, row, col = flat // cells, flat // block % block, flat % block
    seg = tile * chunks + col // WALK_KC
    per_seg = np.bincount(seg, minlength=nnzb * chunks).reshape(nnzb, chunks)
    walked = ((per_seg.sum(1) <= F32_WALK_MAX_NNZ)
              & (per_seg.max(1, initial=0) <= WALK_CHUNK_NNZ))
    head = WALK_HEAD // 16
    units = np.where(np.repeat(walked, chunks),
                     head + (per_seg.reshape(-1) + 1) // 2, 0)
    walk_ptr = np.concatenate([[0], np.cumsum(units)]).astype(np.int32)
    data = np.zeros(int(walk_ptr[-1]) * 4, np.int32)
    segs = np.flatnonzero(units)
    # row pointers: a walked segment's nonzeros a row, summed
    on = walked[tile]
    tile, row, col, seg, vals = (a[on] for a in (tile, row, col, seg, vals))
    per_row = np.bincount(seg * block + row,
                          minlength=nnzb * chunks * block)
    ptr = np.zeros((len(segs), block + 1), np.int64)
    ptr[:, 1:] = np.cumsum(per_row.reshape(-1, block)[segs], 1)
    data16 = data.view(np.uint16)
    data16[walk_ptr[segs][:, None] * 8 + np.arange(block + 1)] = ptr
    # the nonzeros by (segment, row, column)
    order = np.lexsort((col, row, seg))
    seg, col, vals = seg[order], col[order], vals[order]
    first = np.concatenate([[0], np.cumsum(np.bincount(
        seg, minlength=nnzb * chunks))])[seg]
    word = walk_ptr[seg] * 4 + head * 4 + 2 * (np.arange(len(seg)) - first)
    data[word] = col % WALK_KC
    data[word + 1] = vals.astype(np.float32).view(np.int32)
    return walk_ptr, data, walked


def _build_half(rows, cols, vals, n, block, dtype=None,
                min_block_edges: int = 0, *, device="cpu") -> _BCSRHalf:
    from ..native import bcsr_fill, bcsr_structure

    n_pad = _round_up(max(n, 1), block)
    nb = n_pad // block
    grid_cols = nb
    # sender=cols (within-block col index), receiver=rows (row index)
    nnzb, block_of_edge, block_rows, block_cols = bcsr_structure(
        cols, rows, block, grid_cols)

    compact = (np.zeros((0,), np.int32), np.zeros((1,), np.int64),
               np.zeros((0,), np.int32), np.zeros((0,), np.float32),
               np.zeros((0,), np.int32))
    num_rem = 0
    if min_block_edges > 1 and nnzb > 0:
        cnt = np.bincount(block_of_edge, minlength=nnzb)
        edge_is_sparse = (cnt < min_block_edges)[block_of_edge]
        num_rem = int(edge_is_sparse.sum())
        if num_rem:
            compact = _build_remainder(
                rows[edge_is_sparse].astype(np.int32),
                cols[edge_is_sparse].astype(np.int32),
                vals[edge_is_sparse].astype(np.float32),
                block,
            )
            keep = ~edge_is_sparse
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
            nnzb, block_of_edge, block_rows, block_cols = bcsr_structure(
                cols, rows, block, grid_cols)

    if nnzb == 0:
        block_rows = np.zeros((0,), np.int32)
        block_cols = np.zeros((0,), np.int32)
    tiles = bcsr_fill(cols, rows, vals, block_of_edge, block, max(nnzb, 1))
    if nnzb == 0:
        tiles = tiles[:0]
    if dtype in (None, torch.float32):
        walk_ptr, walk_data, walked = _walk_lists(tiles, block_of_edge, rows,
                                                  cols, block)
    else:  # bf16 tiles multiply on the tensor cores, every one dense
        walk_ptr = np.zeros(nnzb * (block // WALK_KC) + 1, np.int32)
        walk_data, walked = np.zeros(0, np.int32), np.zeros(0, bool)
    # one trailing all-zero tile: the fused kernel's TMA map over the tiles
    # needs at least one, and a half whose edges all spilled has none
    blocks = np.concatenate(
        [tiles, np.zeros((1, block, block), tiles.dtype)], axis=0)
    tile_cnt = (np.bincount(block_rows, minlength=nb) if nnzb
                else np.zeros(nb, np.int64))
    rem_rbs, rem_ptr, rem_cols, rem_vals, rem_lrows = compact
    # the remainder by (row, col): a stable re-sort of the (row block, col)
    # order, for the fused kernel's per-row walk
    rem_rows = np.repeat(rem_rbs.astype(np.int64) * block,
                         np.diff(rem_ptr)) + rem_lrows
    by_row = np.argsort(rem_rows, kind="stable")
    rem_row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rem_rows, minlength=n_pad))])
    block_rbs, rem_tasks = _kernel_items(tile_cnt, rem_row_ptr, block)
    tile_ptr = np.concatenate([[0], np.cumsum(tile_cnt)])
    first = np.concatenate([block_rbs * block, rem_tasks[:, 0]])
    end = np.concatenate([block_rbs * block + block, rem_tasks[:, 1]])
    no_tiles = np.zeros(len(rem_tasks), np.int64)
    items = np.stack([
        first, end - first,
        np.concatenate([tile_ptr[block_rbs], no_tiles]),
        np.concatenate([tile_ptr[block_rbs + 1], no_tiles]),
        rem_row_ptr[first], rem_row_ptr[end],
        np.zeros_like(first), np.zeros_like(first)], 1)

    def put(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return _BCSRHalf(
        blocks=put(blocks, dtype or torch.float32),
        block_rows=put(block_rows),
        block_cols=put(block_cols),
        tile_ptr=put(tile_ptr),
        rem_cols=put(rem_cols),
        rem_vals=put(rem_vals, torch.float32),
        rem_lrows=put(rem_lrows),
        rem_rbs=put(rem_rbs),
        rem_ptr=put(rem_ptr),
        rem_row_cols=put(rem_cols[by_row]),
        rem_row_vals=put(rem_vals[by_row], torch.float32),
        rem_row_ptr=put(rem_row_ptr),
        items=put(items),
        walk_ptr=put(walk_ptr),
        walk_data=put(walk_data),
        num_block_items=len(block_rbs),
        num_rows=n_pad,
        num_cols=n_pad,
        nnzb=int(nnzb),
        num_rem=num_rem,
        num_walked=int(walked.sum()),
    )


# ---------------------------------------------------------------------------
# Kernels: the fused hybrid SpMM (csrc/hybrid_spmm.cu, the main path) and
# its baseline pair K1 tile SpMM, K2 remainder scatter (csrc/bcsr_kernels.cu)
# ---------------------------------------------------------------------------


def _check_x(half: _BCSRHalf, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != half.num_cols:
        raise ValueError(f"x must be ({half.num_cols}, F), got "
                         f"{tuple(x.shape)}")
    if x.dtype != half.blocks.dtype:
        raise TypeError(f"x must be {half.blocks.dtype} like the tiles, "
                        f"got {x.dtype}")
    if x.device != half.blocks.device:
        raise ValueError(f"x is on {x.device}, the operator on "
                         f"{half.blocks.device}")


def _require_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


def launch(wrapper, kernel: str, x: torch.Tensor, *args) -> None:
    """Call ``kernel`` of the CUDA library with ``args`` and x's current
    stream, on x's device; raise if the launch failed, else count it on
    ``wrapper``."""
    from .. import csrc

    fn = getattr(csrc.load(), kernel)
    with torch.cuda.device(x.device):
        rc = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed, CUDA "
                           f"error {rc}")
    wrapper.launches += 1


def tile_spmm_plain(half: _BCSRHalf, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: (num_rows, F) f32 = Σ tiles @ x column blocks,
    products of the tile-dtype values summed in f32."""
    f = x.shape[1]
    out = torch.zeros((half.num_rows // BLOCK, BLOCK, f),
                      dtype=torch.float32, device=x.device)
    if half.nnzb:
        xb = x.reshape(half.num_cols // BLOCK, BLOCK, f)
        xb = xb[half.block_cols.long()].float()
        prod = torch.bmm(half.blocks[:half.nnzb].float(), xb)
        out.index_add_(0, half.block_rows.long(), prod)
    return out.reshape(half.num_rows, f)


def tile_spmm(half: _BCSRHalf, x: torch.Tensor) -> torch.Tensor:
    """K1: out (num_rows, F) f32 = Σ_t blocks[t] @ x[block_cols[t]].

    ``x`` is (num_cols, F) in the tiles' dtype.  A CPU tensor takes
    :func:`tile_spmm_plain`; a CUDA tensor launches the kernel."""
    _check_x(half, x)
    if x.device.type == "cpu":
        return tile_spmm_plain(half, x)
    _require_cuda(x, "tile_spmm")
    f = x.shape[1]
    out = torch.empty((half.num_rows, f), dtype=torch.float32,
                      device=x.device)
    if f:
        launch(tile_spmm, "pgtt_tile_spmm", x, half.blocks.data_ptr(),
                int(_is_bf16(half.blocks.dtype)), half.tile_ptr.data_ptr(),
                half.block_cols.data_ptr(), x.data_ptr(), out.data_ptr(),
                half.num_rows // BLOCK, f)
    return out


tile_spmm.launches = 0


def rem_scatter_plain(half: _BCSRHalf, x: torch.Tensor,
                      out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: ``out[rem_rows] += vals · x[rem_cols]`` in place,
    values rounded to the tile dtype, sums in f32."""
    if half.num_rem == 0:
        return out
    vals = half.rem_vals.to(half.blocks.dtype).float()
    msgs = x[half.rem_cols.long()].float() * vals[:, None]
    return out.index_add_(0, half.rem_rows, msgs)


def rem_scatter_(half: _BCSRHalf, x: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """K2: add the COO remainder into ``out`` (num_rows, F) f32, in place.

    ``out`` is K1's output: the JAX kernel aliases it as its output, and
    here the same buffer is updated.  A CPU tensor takes
    :func:`rem_scatter_plain`; a CUDA tensor launches the kernel."""
    _check_x(half, x)
    if out.shape != (half.num_rows, x.shape[1]) or out.dtype != torch.float32:
        raise ValueError(f"out must be ({half.num_rows}, {x.shape[1]}) f32")
    if x.device.type == "cpu":
        return rem_scatter_plain(half, x, out)
    _require_cuda(x, "rem_scatter_")
    if half.num_rem == 0 or x.shape[1] == 0:
        return out
    if not out.is_contiguous():
        raise ValueError("rem_scatter_: out must be contiguous")
    launch(rem_scatter_, "pgtt_rem_scatter", x, half.rem_rbs.data_ptr(),
            half.rem_ptr.data_ptr(), half.rem_cols.data_ptr(),
            half.rem_vals.data_ptr(), half.rem_lrows.data_ptr(),
            x.data_ptr(), int(_is_bf16(x.dtype)), out.data_ptr(),
            int(half.rem_rbs.shape[0]), x.shape[1])
    return out


rem_scatter_.launches = 0


def hybrid_spmm_plain(half: _BCSRHalf, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch fused kernel: :func:`tile_spmm_plain`, then
    :func:`rem_scatter_plain` on its output."""
    return rem_scatter_plain(half, x, tile_spmm_plain(half, x))


def hybrid_args(half: _BCSRHalf, x: torch.Tensor, out: torch.Tensor) -> tuple:
    """``pgtt_hybrid_spmm``'s arguments for ``out = half @ x``, in its
    order, less the stream (``csrc.SIGNATURES`` gives their types): the
    tiles and their count, whether they are bf16, the tile columns, the
    walk lists, the item list with its row blocks and length, the
    remainder by row, x with its rows, out and the width."""
    return (half.blocks.data_ptr(), half.blocks.shape[0],
            int(_is_bf16(half.blocks.dtype)), half.block_cols.data_ptr(),
            half.walk_ptr.data_ptr(), half.walk_data.data_ptr(),
            half.items.data_ptr(), half.num_block_items, half.items.shape[0],
            half.rem_row_ptr.data_ptr(), half.rem_row_cols.data_ptr(),
            half.rem_row_vals.data_ptr(), x.data_ptr(), half.num_cols,
            out.data_ptr(), x.shape[1])


def hybrid_spmm(half: _BCSRHalf, x: torch.Tensor) -> torch.Tensor:
    """Fused kernel: out (num_rows, F) f32 = tiles @ x + remainder.

    ``x`` is (num_cols, F) in the tiles' dtype.  A CPU tensor takes
    :func:`hybrid_spmm_plain`; a CUDA tensor launches the kernel."""
    _check_x(half, x)
    if x.device.type == "cpu":
        return hybrid_spmm_plain(half, x)
    _require_cuda(x, "hybrid_spmm")
    f = x.shape[1]
    out = torch.empty((half.num_rows, f), dtype=torch.float32,
                      device=x.device)
    if f:
        launch(hybrid_spmm, "pgtt_hybrid_spmm", x,
               *hybrid_args(half, x, out))
        nft = _fused_shape(f, _is_bf16(half.blocks.dtype))[1]
        hybrid_spmm.walked_tiles += half.num_walked * nft
        hybrid_spmm.dense_tiles += (half.nnzb - half.num_walked) * nft
    return out


hybrid_spmm.launches = 0
# the fused kernel's (tile, feature tile) products, walked and dense
hybrid_spmm.walked_tiles = 0
hybrid_spmm.dense_tiles = 0


def reset_launch_counts() -> None:
    hybrid_spmm.launches = 0
    tile_spmm.launches = 0
    rem_scatter_.launches = 0
    hybrid_spmm.walked_tiles = hybrid_spmm.dense_tiles = 0


def launch_counts() -> tuple:
    """The launch counts of the fused kernel, K1 and K2, in that order."""
    return hybrid_spmm.launches, tile_spmm.launches, rem_scatter_.launches


def add_launch_counts(delta) -> None:
    """Add ``delta`` (a :func:`launch_counts` tuple) to the counts.  A
    CUDA graph's capture calls the wrappers, which count launches that do
    not run; the captured steps take those back out and add them again at
    every replay, where the captured kernels do run (``_counters``)."""
    for wrapper, d in zip((hybrid_spmm, tile_spmm, rem_scatter_), delta):
        wrapper.launches += d


_counters.register("bcsr_launches", launch_counts, add_launch_counts)


def tile_counts() -> tuple:
    """The fused kernel's (walked, dense) tile × feature-tile products over
    its launches: each launch adds its half's walked and dense tiles times
    its feature tiles."""
    return hybrid_spmm.walked_tiles, hybrid_spmm.dense_tiles


def add_tile_counts(delta) -> None:
    """Add ``delta`` (a :func:`tile_counts` tuple), as
    :func:`add_launch_counts` does for a capture and its replays."""
    hybrid_spmm.walked_tiles += delta[0]
    hybrid_spmm.dense_tiles += delta[1]


_counters.register("bcsr_tiles", tile_counts, add_tile_counts)


def bcsr_matmul(half: _BCSRHalf, x: torch.Tensor) -> torch.Tensor:
    """out (num_rows, F) f32 = tiles @ x + remainder, one fused kernel
    launch; x (num_cols, F) is cast to the tiles' dtype first (bf16 tiles
    take bf16 x)."""
    return hybrid_spmm(half, x.to(half.blocks.dtype).contiguous())


class _BCSRSpmm(torch.autograd.Function):
    """``bcsr_matmul(mat.fwd, x)`` with the gradient ``bcsr_matmul(mat.bwd,
    ḡ)`` in x's dtype; the operator gets none (takes the place of the JAX
    custom VJP ``_bcsr_spmm_padded``)."""

    @staticmethod
    def forward(ctx, x_pad, mat):
        ctx.mat = mat
        ctx.x_dtype = x_pad.dtype
        return bcsr_matmul(mat.fwd, x_pad)

    @staticmethod
    def backward(ctx, g):
        return bcsr_matmul(ctx.mat.bwd, g).to(ctx.x_dtype), None


class _Permute(torch.autograd.Function):
    """``x[index]`` for a permutation ``index`` of x's rows, with the
    gradient ``g[inverse]``: a permutation's adjoint is its inverse, so
    each row of the gradient is its one cotangent row, bit for bit what
    indexing's backward (``index_put_`` with accumulation: a sort of the
    indices and an accumulating scatter) computes, in one gather."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.inverse = inverse
        return x[index]

    @staticmethod
    def backward(ctx, g):
        return g[ctx.inverse], None, None


def bcsr_spmm(mat: BCSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Aggregate (..., N, F) features through the block-sparse operator.

    Leading dims fold into the feature axis (one kernel launch per call);
    nodes are padded to the tile multiple and permuted when the operator
    was reordered (:class:`_Permute`, in and out).  Returns f32, like the
    kernels."""
    n = mat.num_nodes
    f = x.shape[-1]
    lead = x.shape[:-2]
    xb = x.reshape(-1, n, f)
    b = xb.shape[0]
    x2 = xb.permute(1, 0, 2).reshape(n, b * f)
    pad = mat.fwd.num_cols - n
    if pad:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, pad))
    if mat.perm is not None:
        x2 = _Permute.apply(x2, mat.perm, mat.iperm)
    out = _BCSRSpmm.apply(x2, mat)
    if mat.perm is not None:
        out = _Permute.apply(out, mat.iperm, mat.perm)
    out = out[:n].reshape(n, b, f).permute(1, 0, 2)
    return out.reshape(lead + (n, f))


class StackedBCSR:
    """Per-step operators of a dynamic-edge sequence (see
    :func:`stack_bcsr`): a sequence of length T whose item ``t`` is step
    t's :class:`BCSRMatrix`."""

    def __init__(self, mats):
        self.mats = tuple(mats)
        self.num_nodes = self.mats[0].num_nodes

    def __len__(self) -> int:
        return len(self.mats)

    def __getitem__(self, t):
        return self.mats[t]

    def __iter__(self):
        return iter(self.mats)


def stack_bcsr(mats) -> StackedBCSR:
    """Per-snapshot BCSR operators as one sequence over time — the tiled
    path for **dynamic-edge sequences**::

        mats = [BCSRMatrix.from_graph(g_t, dtype=torch.bfloat16)
                for g_t in graphs]           # same N, same dtype
        h = h0
        for mat_t in stack_bcsr(mats):       # one fused launch per step
            h = f(bcsr_spmm(mat_t, h))

    The JAX package pads every step's tiles, steps and remainder chunks
    to common shapes and stacks them for ``lax.scan``; here the time loop
    runs in Python, so the steps stay as they were built, without padding
    or copies, and the kernel reads each step's own arrays.  All must
    share ``num_nodes``, the tile dtype and the ``reorder=`` setting.  The
    JAX package also refuses steps whose TPU layouts differ (tiles a grid
    step, remainder edges a chunk); the port keeps no such layout.
    """
    mats = list(mats)
    if not mats:
        raise ValueError("stack_bcsr needs at least one operator")
    m0 = mats[0]
    for m in mats:
        if m.num_nodes != m0.num_nodes:
            raise ValueError("stack_bcsr: operators must share num_nodes")
        if m.fwd.blocks.dtype != m0.fwd.blocks.dtype:
            raise ValueError(
                "stack_bcsr: operators must share tile dtype (a sequence "
                "that mixes them would run some steps off the bf16 kernel "
                "path) — pass the same dtype= to every "
                "BCSRMatrix.from_graph")
    with_perm = [m.perm is not None for m in mats]
    if any(with_perm) and not all(with_perm):
        raise ValueError(
            "stack_bcsr: operators mix reordered and plain layouts — "
            "build every snapshot with the same reorder= setting")
    return StackedBCSR(mats)
