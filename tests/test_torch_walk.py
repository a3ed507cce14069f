"""The walked f32 tiles' nonzero lists (``ops/bcsr.py`` ``_walk_lists``),
which the fused kernel multiplies in place of sparse dense tiles, and the
``bcsr_tiles`` counter.

The lists are decoded here as the kernel reads them: per (tile, K chunk) a
run of 16-byte units of ``walk_data`` between ``walk_ptr`` bounds, 129 u16
row pointers in ``WALK_HEAD`` bytes, then (column in the chunk, f32 bits)
pairs.  Whether a tile is walked changes nothing the layout decisions make:
the PeMS stand-in's operators are built as before, tile for tile.
"""

import hashlib

import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu_torch import _counters
from pytorch_geometric_temporal_tpu_torch.ops import Graph
from pytorch_geometric_temporal_tpu_torch.ops import bcsr as tb

CHUNKS = tb.BLOCK // tb.WALK_KC


def decode(half, t):
    """Tile t's walked lists as a dense (128, 128) f32 tile, with the order
    of its nonzeros checked; None for a dense tile."""
    ptr = half.walk_ptr.numpy()
    data = half.walk_data.numpy()
    bounds = ptr[CHUNKS * t:CHUNKS * t + CHUNKS + 1]
    if bounds[-1] == bounds[0]:
        return None
    tile = np.zeros((tb.BLOCK, tb.BLOCK), np.float32)
    for kc in range(CHUNKS):
        a, b = bounds[kc], bounds[kc + 1]
        assert b > a                            # every chunk has its head
        seg = data[4 * a:4 * b]
        rows = seg.view(np.uint16)[:tb.BLOCK + 1].astype(np.int64)
        pairs = seg[tb.WALK_HEAD // 4:].reshape(-1, 2)
        assert rows[0] == 0 and np.all(np.diff(rows) >= 0)
        assert len(pairs) == 2 * ((rows[-1] + 1) // 2)  # whole units
        for r in range(tb.BLOCK):
            cols = pairs[rows[r]:rows[r + 1], 0]
            assert np.all(np.diff(cols) > 0)     # columns ascending
            assert np.all((cols >= 0) & (cols < tb.WALK_KC))
            vals = pairs[rows[r]:rows[r + 1], 1].view(np.float32)
            assert np.all(vals != 0)
            tile[r, kc * tb.WALK_KC + cols] = vals
    return tile


def banded(n, e, band, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = np.clip(s + rng.integers(-band, band + 1, e), 0, n - 1)
    return np.stack([s, r]), rng.uniform(0.1, 1.0, e).astype(np.float32)


def one_tile(cells, seed=0):
    """A 128-node graph whose one tile holds ``cells`` (flat row·128 + col
    positions) with values U(0.1, 1)."""
    cells = np.asarray(cells)
    w = np.random.default_rng(seed).uniform(0.1, 1.0, cells.size)
    return Graph.from_edge_index(np.stack([cells % 128, cells // 128]),
                                 w.astype(np.float32), num_nodes=128,
                                 device="cpu")


def graph_case(name):
    if name == "banded":
        ei, w = banded(1500, 30000, 40, 1)
    elif name == "pems-band":
        rng = np.random.default_rng(2)
        s = np.repeat(np.arange(2000), 6)
        r = np.clip(s + rng.integers(-8, 9, s.size), 0, 1999)
        ei, w = np.stack([s, r]), rng.uniform(0.3, 1, s.size)
    elif name == "empty-rows":
        ei, w = banded(1000, 20000, 40, 4)
        keep = ~((ei[1] >= 384) & (ei[1] < 640))
        ei, w = ei[:, keep], w[keep]
    else:  # "mixed": a band and a first tile 40% full
        rng = np.random.default_rng(3)
        s = np.repeat(np.arange(1500), 6)
        r = np.clip(s + rng.integers(-8, 9, s.size), 0, 1499)
        full = np.flatnonzero(rng.random(128 * 128) < 0.4)
        s = np.concatenate([s, full % 128])
        r = np.concatenate([r, full // 128])
        ei, w = np.stack([s, r]), rng.uniform(0.1, 1, s.size)
    n = int(ei.max()) + 1
    return Graph.from_edge_index(ei, np.asarray(w, np.float32), num_nodes=n,
                                 device="cpu")


@pytest.mark.parametrize("name", ["banded", "pems-band", "empty-rows",
                                  "mixed"])
def test_walk_lists_are_each_tiles_nonzeros_in_row_column_order(name):
    mat = tb.BCSRMatrix.from_graph(graph_case(name))
    for half in (mat.fwd, mat.bwd):
        assert half.walk_ptr.dtype == torch.int32
        assert half.walk_ptr.shape == (CHUNKS * half.nnzb + 1,)
        assert int(half.walk_ptr[-1]) * 4 == half.walk_data.numel()
        walked = 0
        for t in range(half.nnzb):
            tile = decode(half, t)
            want = half.blocks[t].numpy()
            nnz = int(np.count_nonzero(want))
            if tile is None:
                assert nnz > tb.F32_WALK_MAX_NNZ or max(
                    np.count_nonzero(want[:, k:k + tb.WALK_KC])
                    for k in range(0, 128, tb.WALK_KC)) > tb.WALK_CHUNK_NNZ
                continue
            walked += 1
            assert nnz <= tb.F32_WALK_MAX_NNZ
            np.testing.assert_array_equal(tile.view(np.int32),
                                          want.view(np.int32))
        assert walked == half.num_walked
    if name == "mixed":
        assert mat.fwd.num_walked == mat.fwd.nnzb - 1
    else:
        assert mat.fwd.num_walked == mat.fwd.nnzb


@pytest.mark.parametrize("over", [0, 1])
def test_the_cut_is_at_most_its_nonzeros(monkeypatch, over):
    """A tile of exactly the cut's nonzeros is walked, one of one more is
    dense."""
    cells = np.random.default_rng(5).choice(128 * 128, 700, replace=False)
    monkeypatch.setattr(tb, "F32_WALK_MAX_NNZ", 700 - over)
    half = tb.BCSRMatrix.from_graph(one_tile(cells)).fwd
    assert half.nnzb == 1
    assert half.num_walked == 1 - over
    assert (decode(half, 0) is None) == bool(over)
    if not over:
        np.testing.assert_array_equal(decode(half, 0), half.blocks[0].numpy())


def test_an_empty_tile_row_and_a_full_tile(monkeypatch):
    """Rows 64-127 of a tile hold nothing: their pointers stand still.  A
    full tile stays dense under any cut: its chunks overflow the slot."""
    rng = np.random.default_rng(6)
    cells = rng.choice(64 * 128, 900, replace=False)
    half = tb.BCSRMatrix.from_graph(one_tile(cells)).fwd
    tile = decode(half, 0)
    np.testing.assert_array_equal(tile, half.blocks[0].numpy())
    assert not tile[64:].any()
    seg = half.walk_data.numpy()[:4 * int(half.walk_ptr[1])]
    rows = seg.view(np.uint16)[:129]
    assert np.all(rows[64:] == rows[64])
    monkeypatch.setattr(tb, "F32_WALK_MAX_NNZ", 128 * 128)
    full = tb.BCSRMatrix.from_graph(one_tile(np.arange(128 * 128))).fwd
    assert (full.nnzb, full.num_walked) == (1, 0)
    assert decode(full, 0) is None and full.walk_data.numel() == 0


def test_bf16_tiles_keep_no_lists():
    mat = tb.BCSRMatrix.from_graph(graph_case("banded"),
                                   dtype=torch.bfloat16)
    for half in (mat.fwd, mat.bwd):
        assert half.num_walked == 0 and half.walk_data.numel() == 0
        assert half.walk_ptr.shape == (CHUNKS * half.nnzb + 1,)
        assert not half.walk_ptr.any()


def pems_stand_in(seed, scramble):
    """The benchmark's PeMS stand-in graph (perfbench/traffic.py): 11,160
    sensors, 6 edges a sensor within ±8, weights U(0.3, 1); ids permuted by
    a seeded σ when ``scramble``."""
    n = 11160
    rng = np.random.default_rng(seed)
    s = np.repeat(np.arange(n), 6)
    r = np.clip(s + rng.integers(-8, 9, s.size), 0, n - 1)
    w = rng.uniform(0.3, 1.0, s.size).astype(np.float32)
    if scramble:
        sigma = np.random.default_rng(seed + 1).permutation(n)
        s, r = sigma[s], sigma[r]
    return Graph.from_edge_index(np.stack([s, r]), w, num_nodes=n,
                                 device="cpu")


LAYOUT = ("blocks", "block_rows", "block_cols", "tile_ptr", "items",
          "rem_row_ptr", "rem_row_cols", "rem_row_vals")


def layout_digest(mat):
    h = hashlib.sha256()
    for half in (mat.fwd, mat.bwd):
        for key in LAYOUT:
            h.update(getattr(half, key).numpy().tobytes())
    if mat.perm is not None:
        h.update(mat.perm.numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("scramble,want", [
    # (nnzb, remainder edges, reordered, digest) as the builder before the
    # walked tiles made them, spmm's auto route at F = 256
    (False, (88, 2214, False, "65ce5b533cc14590")),
    (True, (87, 62258, False, "98890d22875aaa13")),
])
def test_pems_operators_are_laid_out_as_before(monkeypatch, scramble, want):
    g = pems_stand_in(2026, scramble)
    mat = tb.BCSRMatrix.from_graph(g, reorder="auto", expected_f=256)
    assert (mat.fwd.nnzb, mat.fwd.num_rem, mat.perm is not None,
            layout_digest(mat)) == want
    assert mat.fwd.num_walked == mat.fwd.nnzb
    monkeypatch.setattr(tb, "F32_WALK_MAX_NNZ", -1)
    dense = tb.BCSRMatrix.from_graph(g, reorder="auto", expected_f=256)
    assert dense.fwd.num_walked == 0
    assert layout_digest(dense) == want[3]


def test_tile_counts_are_taken_back_at_capture_and_added_at_replay():
    """``bcsr_tiles`` rides the counters' one mechanism: a capture's
    delta taken back out, added again at each replay."""
    tb.reset_launch_counts()
    before = _counters.read()
    assert before["bcsr_tiles"] == (0, 0)
    tb.add_tile_counts((88 * 3, 0))                    # as a capture would
    counted = _counters.counted_since(before)
    assert counted["bcsr_tiles"] == (264, 0)
    _counters.add(counted, -1)
    assert tb.tile_counts() == (0, 0)
    for replay in range(1, 3):
        _counters.add(counted)
        assert tb.tile_counts() == (264 * replay, 0)
    tb.reset_launch_counts()
    assert tb.tile_counts() == (0, 0)


def test_the_cpu_path_counts_no_tiles():
    mat = tb.BCSRMatrix.from_graph(graph_case("banded"))
    tb.reset_launch_counts()
    tb.hybrid_spmm(mat.fwd, torch.randn(mat.fwd.num_cols, 8))
    assert tb.tile_counts() == (0, 0) and tb.launch_counts() == (0, 0, 0)
