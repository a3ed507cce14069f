"""The fused kernel's remainder schedule (``ops/bcsr.py``: ``_kernel_items``,
``_task_count``, the ``block_rbs`` / ``rem_tasks`` fields of a half) and a
numpy walk of ``csrc/hybrid_spmm.cu``'s item list and remainder epilogue.

- The remainder-only tasks cover every row of every row block that keeps no
  tile and owns remainder edges exactly once, never split a row, hold at
  most max(``REM_TASK_EDGES``, the longest row) edges, vanish when there is
  no remainder, put a hub row in a task of its own, come out the same from
  two builds and ride on ``stack_bcsr`` / ``stack_bcsr_gcn`` halves.
- The walk transcribes the kernel's loops statement by statement (items
  c, c + G, ... over the ``items`` descriptors, the row blocks' for each
  feature tile, then the tasks'; remainder stages of RE edges; the consumer
  thread map u = t % nu, rows t / nu + k · (256 / nu), each thread's cursor
  row carried across stages, or each row whole where an item's edges fit
  one stage).  Every remainder edge must be added exactly
  once a feature unit, into its own row, in ascending column order after
  the tile products, every output written exactly once; the outputs agree
  with ``hybrid_spmm_plain`` (the same f32 products in another order of
  the tile sums: 1e-5 of the output's scale).
- The tensors the kernels read equal the JAX package's builder arrays
  (``test_torch_bcsr.py`` holds them equal).

Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu_torch.ops import Graph as TGraph
from pytorch_geometric_temporal_tpu_torch.ops import bcsr as tb
from pytorch_geometric_temporal_tpu_torch.ops import operators as tops

CT = 256  # hybrid_spmm.cu's consumer threads


def banded_edges(seed, n, e, band=40, frac_local=0.9):
    rng = np.random.default_rng(seed)
    e_loc = int(e * frac_local)
    s = rng.integers(0, n, size=e_loc)
    r = np.clip(s + rng.integers(-band, band + 1, size=e_loc), 0, n - 1)
    s = np.concatenate([s, rng.integers(0, n, size=e - e_loc)])
    r = np.concatenate([r, rng.integers(0, n, size=e - e_loc)])
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    return s.astype(np.int32), r.astype(np.int32), w


def hub_edges(seed=3, n=1500, hub=700, hub_edges=20_000):
    """A banded graph of ``n`` nodes with one row that receives
    ``hub_edges`` edges from random senders."""
    s, r, w = banded_edges(seed, n, 12_000)
    rng = np.random.default_rng(seed + 1)
    s = np.concatenate([s, rng.integers(0, n, hub_edges).astype(np.int32)])
    r = np.concatenate([r, np.full(hub_edges, hub, np.int32)])
    w = np.concatenate([w, rng.uniform(0.1, 1.0, hub_edges).astype(
        np.float32)])
    return s, r, w


# (seed, n, e, band, frac_local, min_block_edges)
DRAWS = [(1, 2000, 30000, 40, 0.9, 32), (5, 1200, 15000, 40, 0.9, 40),
         (2, 900, 40000, 60, 0.5, 10**6), (8, 3000, 60000, 300, 0.3, 48)]


def build(draw, bf16=False):
    seed, n, e, band, frac, mbe = draw
    s, r, w = banded_edges(seed, n, e, band, frac)
    dtype = torch.bfloat16 if bf16 else None
    return tb._build_half(r, s, w, n, 128, dtype, mbe)


def rows_of_tasks(half):
    """(K, 2) tasks as numpy and the remainder row pointers."""
    return half.rem_tasks.numpy(), half.rem_row_ptr.numpy().astype(np.int64)


def remainder_only_blocks(half):
    tiles, rems = half.row_block_layout()
    return np.flatnonzero((tiles == 0) & (rems > 0))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("draw", DRAWS)
def test_tasks_cover_remainder_only_rows_once(draw, bf16):
    half = build(draw, bf16)
    tasks, _ = rows_of_tasks(half)
    assert tasks.dtype == np.int32 and half.block_rbs.dtype == torch.int32
    assert (tasks[:, 1] > tasks[:, 0]).all()
    # row ranges in order, each inside one row block
    assert (tasks[1:, 0] >= tasks[:-1, 1]).all()
    assert (tasks[:, 0] // 128 == (tasks[:, 1] - 1) // 128).all()
    covered = np.concatenate([np.arange(a, b) for a, b in tasks]) \
        if len(tasks) else np.zeros(0, np.int64)
    want = np.concatenate([np.arange(rb * 128, rb * 128 + 128)
                           for rb in remainder_only_blocks(half)]) \
        if len(remainder_only_blocks(half)) else np.zeros(0, np.int64)
    np.testing.assert_array_equal(covered, want)
    # every row block is an item exactly once: walked whole or in tasks
    tiles, rems = half.row_block_layout()
    whole = np.flatnonzero((tiles > 0) | (rems == 0))
    np.testing.assert_array_equal(half.block_rbs.numpy(), whole)


@pytest.mark.parametrize("draw", DRAWS + [None])
def test_task_edges_within_the_cap_or_one_row(draw):
    if draw is None:
        s, r, w = hub_edges()
        half = tb._build_half(r, s, w, 1500, 128, None, 10**6)
    else:
        half = build(draw)
    tasks, ptr = rows_of_tasks(half)
    edges = ptr[tasks[:, 1]] - ptr[tasks[:, 0]]
    longest = int(np.diff(ptr).max()) if half.num_rem else 0
    assert edges.max(initial=0) <= max(tb.REM_TASK_EDGES, longest)
    # tasks over the cap are single rows
    over = edges > tb.REM_TASK_EDGES
    assert (tasks[over, 1] - tasks[over, 0] == 1).all()


@pytest.mark.parametrize("mbe", [0, 1, 2])
def test_no_remainder_no_tasks(mbe):
    s, r, w = banded_edges(4, 1000, 20000)
    half = tb._build_half(r, s, w, 1000, 128, None, mbe)
    assert half.num_rem == 0
    assert tuple(half.rem_tasks.shape) == (0, 2)
    np.testing.assert_array_equal(half.block_rbs.numpy(), np.arange(8))


def test_hub_row_is_a_task_of_its_own():
    s, r, w = hub_edges()
    half = tb._build_half(r, s, w, 1500, 128, torch.bfloat16, 10**6)
    tasks, ptr = rows_of_tasks(half)
    mine = tasks[(tasks[:, 0] <= 700) & (tasks[:, 1] > 700)]
    np.testing.assert_array_equal(mine, [[700, 701]])
    assert ptr[701] - ptr[700] >= 20_000
    # the rest of its row block is cut into tasks under the cap
    rest = tasks[(tasks[:, 0] // 128 == 700 // 128)
                 & ~((tasks[:, 0] == 700) & (tasks[:, 1] == 701))]
    assert len(rest) >= 2
    assert (ptr[rest[:, 1]] - ptr[rest[:, 0]] <= tb.REM_TASK_EDGES).all()


@pytest.mark.parametrize("draw", DRAWS[:2])
def test_items_identical_across_builds(draw):
    a, b = build(draw), build(draw)
    assert torch.equal(a.block_rbs, b.block_rbs)
    assert torch.equal(a.rem_tasks, b.rem_tasks)


def test_stacked_halves_carry_the_item_list():
    rng = np.random.default_rng(9)
    n = 900
    graphs = []
    for _ in range(3):
        s = rng.integers(0, n, 8000)
        r = np.where(rng.random(8000) < 0.7,
                     np.clip(s + rng.integers(-20, 21, 8000), 0, n - 1),
                     rng.integers(0, n, 8000))
        graphs.append(TGraph.from_edge_index(
            np.stack([s, r]), rng.uniform(0.1, 1.0, 8000).astype(np.float32),
            num_nodes=n, device="cpu"))
    plain = tb.stack_bcsr([tb.BCSRMatrix.from_graph(g, min_block_edges=40)
                           for g in graphs])
    gcn = tops.stack_bcsr_gcn(graphs, device="cpu")
    seen_tasks = 0
    for mats in (plain, gcn):
        for mat in mats:
            for half in (mat.fwd, mat.bwd):
                tiles, rems = half.row_block_layout()
                whole = np.flatnonzero((tiles > 0) | (rems == 0))
                np.testing.assert_array_equal(half.block_rbs.numpy(), whole)
                tasks, _ = rows_of_tasks(half)
                rows = sum(int(b - a) for a, b in tasks)
                assert rows == 128 * len(remainder_only_blocks(half))
                seen_tasks += len(tasks)
    assert seen_tasks > 0


@pytest.mark.parametrize("draw", DRAWS)
def test_model_prices_the_built_task_counts(draw):
    """The cost model's ``_task_count`` tasks a remainder-only row block
    against the tasks the builder cuts there: equal, or one more where the
    row ends leave an edge count over the cap."""
    half = build(draw)
    tasks, _ = rows_of_tasks(half)
    _, rems = half.row_block_layout()
    built = np.bincount(tasks[:, 0] // 128, minlength=len(rems))
    free = remainder_only_blocks(half)
    want = tb._task_count(rems[free])
    assert (built[free] >= want).all() and (built[free] <= want + 1).all()
    assert built[free].sum() <= want.sum() + max(1, len(free) // 10)


# ---------------------------------------------------------------------------
# a numpy walk of the kernel
# ---------------------------------------------------------------------------


def walk_kernel(half, x, ctas=132):
    """``hybrid_spmm.cu`` on (half, x), transcribed: returns the output
    (sums in float64 from the tile products, then the remainder edges in the
    order the kernel adds them) and the events, (row, first feature,
    features, edge) in the order each owner adds them."""
    bf16 = half.blocks.dtype == torch.bfloat16
    f = x.shape[1]
    ft_w, nft, _, re = tb._fused_shape(f, bf16)
    vec = 8 if bf16 else 4
    tiles_out = tb.tile_spmm_plain(half, x).double().numpy()
    ptr = half.rem_row_ptr.numpy().astype(np.int64)
    cols = half.rem_row_cols.numpy()
    vals = half.rem_row_vals.to(half.blocks.dtype).double().numpy()
    xs = x.double().numpy()
    items = half.items.numpy()
    n_block, n_base = half.num_block_items, len(items)
    n_items = n_base * nft
    grid = min(n_items, ctas)
    out = np.full((half.num_rows, f), np.nan)
    events = []
    for b in range(grid):
        for item in range(b, n_items, grid):
            if item < n_block * nft:  # item_base
                ft, base = divmod(item, n_block)
            else:
                ft, k = divmod(item - n_block * nft, n_base - n_block)
                base = n_block + k
            row0, nrows, t0, t1, p0, p1 = items[base, :6]
            f0 = ft * ft_w
            nf = min(ft_w, f - f0)
            tiles = t1 > t0
            blk = np.zeros((nrows, ft_w))  # the epilogue block
            if tiles:
                blk[:, :nf] = tiles_out[row0:row0 + nrows, f0:f0 + nf]
            if p0 == p1:  # no remainder: the block (or zeros) straight out
                assert np.isnan(out[row0:row0 + nrows, f0:f0 + nf]).all()
                out[row0:row0 + nrows, f0:f0 + nf] = blk[:, :nf]
                continue
            rp = ptr[row0:row0 + nrows + 1]
            fpt = vec  # a thread's 16-byte feature unit
            nu = -(-nf // fpt)
            rstep = CT // nu
            if p1 - p0 <= re:  # one stage: each owned row whole
                for t in range(CT):
                    fc = (t % nu) * fpt
                    hi = min(fc + fpt, nf)
                    for lr in range(t // nu, nrows if t // nu < rstep else 0,
                                    rstep):
                        a = blk[lr, fc:fc + fpt].copy()
                        es = np.arange(rp[lr], rp[lr + 1])
                        for e in es:
                            a[:hi - fc] += vals[e] * xs[cols[e], f0 + fc:f0 + hi]
                        events.append(np.stack([
                            np.full_like(es, row0 + lr),
                            np.full_like(es, f0 + fc),
                            np.full_like(es, hi - fc), es], 1))
                        flush(out, a, row0 + lr, f0 + fc, hi - fc)
                continue
            # each consumer thread's cursor row and running sum
            lrs = [t // nu if t // nu < rstep else nrows for t in range(CT)]
            sums = [None] * CT
            for e0 in range(p0, p1, re):  # remainder stages
                e1 = min(e0 + re, p1)
                for t in range(CT):
                    fc = (t % nu) * fpt
                    while lrs[t] < nrows:
                        lr = lrs[t]
                        if rp[lr] >= e1:
                            break  # the row starts in a later stage
                        if sums[t] is None:
                            sums[t] = blk[lr, fc:fc + fpt].copy()
                        hi = min(fc + fpt, nf)
                        es = np.arange(max(rp[lr], e0), min(rp[lr + 1], e1))
                        for e in es:  # one at a time, in edge order
                            sums[t][:hi - fc] += (vals[e] * xs[cols[e],
                                                  f0 + fc:f0 + hi])
                        events.append(np.stack([
                            np.full_like(es, row0 + lr),
                            np.full_like(es, f0 + fc),
                            np.full_like(es, hi - fc), es], 1))
                        if rp[lr + 1] > e1:
                            break  # the row goes on in the next stage
                        flush(out, sums[t], row0 + lr, f0 + fc, hi - fc)
                        sums[t], lrs[t] = None, lr + rstep
            for t in range(CT):  # the rows after the item's last edge
                fc = (t % nu) * fpt
                while lrs[t] < nrows:
                    flush(out, blk[lrs[t], fc:fc + fpt], row0 + lrs[t],
                          f0 + fc, min(fc + fpt, nf) - fc)
                    lrs[t] += rstep
    return out, events


def flush(out, a, row, col, n):
    assert np.isnan(out[row, col:col + n]).all(), "an output written twice"
    out[row, col:col + n] = a[:n]


CASES = [  # (draw or a hub graph's min_block_edges, bf16, F)
    (DRAWS[0], False, 20), (DRAWS[0], True, 16), (DRAWS[1], False, 100),
    (DRAWS[1], True, 14), (DRAWS[2], True, 40), (DRAWS[2], False, 3),
    (DRAWS[3], True, 136), (48, False, 8), (10**6, True, 13),
]


@pytest.mark.parametrize("case", CASES)
def test_kernel_walk_adds_every_edge_once_in_column_order(case):
    draw, bf16, f = case
    if isinstance(draw, int):
        s, r, w = hub_edges()
        half = tb._build_half(r, s, w, 1500, 128,
                              torch.bfloat16 if bf16 else None, draw)
    else:
        half = build(draw, bf16)
    rng = np.random.default_rng(f)
    x = torch.from_numpy(rng.normal(size=(half.num_cols, f)).astype(
        np.float32)).to(half.blocks.dtype)
    out, events = walk_kernel(half, x)
    assert not np.isnan(out).any(), "an output was never written"
    want = tb.hybrid_spmm_plain(half, x).double().numpy()
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    ev = np.concatenate(events + [np.zeros((0, 4), np.int64)])
    ptr = half.rem_row_ptr.numpy().astype(np.int64)
    cols = half.rem_row_cols.numpy()
    # each edge once a feature, into its own row
    assert (np.bincount(ev[:, 3], weights=ev[:, 2],
                        minlength=half.num_rem) == f).all()
    assert len(np.unique(ev[:, 3] * f + ev[:, 1])) == len(ev)
    row_of_edge = np.repeat(np.arange(half.num_rows), np.diff(ptr))
    np.testing.assert_array_equal(ev[:, 0], row_of_edge[ev[:, 3]])
    # per owner (row, first feature), the row's edges in edge order, hence
    # ascending columns: grouped by owner in the order added, each group is
    # ptr[row] .. ptr[row + 1] - 1
    order = np.lexsort((np.arange(len(ev)), ev[:, 1], ev[:, 0]))
    g = ev[order]
    new_owner = np.r_[True, (g[1:, 0] != g[:-1, 0]) | (g[1:, 1] != g[:-1, 1])]
    starts = np.flatnonzero(new_owner)
    lens = np.diff(np.r_[starts, len(g)])
    np.testing.assert_array_equal(g[starts, 3], ptr[g[starts, 0]])
    np.testing.assert_array_equal(lens, np.diff(ptr)[g[starts, 0]])
    step = np.diff(g[:, 3])
    assert (step[~new_owner[1:]] == 1).all()
    assert (np.diff(cols[g[:, 3]])[~new_owner[1:]] >= 0).all()


@pytest.mark.parametrize("nu", [1, 2, 3, 5, 6, 8, 12, 16, 24, 32])
def test_thread_map_owns_every_output_once(nu):
    """u = t % nu, rows t / nu + k · (256 / nu) over 128 rows: each (row,
    unit) pair has exactly one consumer thread."""
    owner = np.zeros((128, nu), np.int64)
    rstep = CT // nu
    for t in range(CT):
        u, lr = t % nu, t // nu
        if lr >= rstep:
            continue
        owner[lr::rstep, u] += 1
    assert (owner == 1).all()
