"""Port parity: the BCSR construction, the plain versions of the kernels
(the fused hybrid SpMM and its baseline pair K1/K2) and the autograd
wrapper against the JAX package (``ops/bcsr.py``).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: constructed arrays must be EQUAL; the kernels' plain versions sum
the same f32 products (bf16 values are exact in f32) in another order than
the Pallas kernels, so they agree to 1e-5 of the output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu.ops import Graph as JGraph
from pytorch_geometric_temporal_tpu.ops import spmm_segment as j_segment
from pytorch_geometric_temporal_tpu.ops import bcsr as jb
from pytorch_geometric_temporal_tpu_torch.ops import Graph as TGraph
from pytorch_geometric_temporal_tpu_torch.ops import bcsr as tb
from _torch_jax_native import jax_native  # noqa: F401

# the JAX package's native library, loaded race-free: its RCM order is
# what the port's native layer is compared with (see the module)
pytestmark = pytest.mark.usefixtures("jax_native")


# the JAX host arrays that the port's tile coordinates equal as they are
HOST_KEYS = ("block_rows", "block_cols")


def banded(seed, n, e, band=40, frac_local=0.9, scramble=False):
    rng = np.random.default_rng(seed)
    e_loc = int(e * frac_local)
    s = rng.integers(0, n, size=e_loc)
    r = np.clip(s + rng.integers(-band, band + 1, size=e_loc), 0, n - 1)
    s = np.concatenate([s, rng.integers(0, n, size=e - e_loc)])
    r = np.concatenate([r, rng.integers(0, n, size=e - e_loc)])
    if scramble:
        p = rng.permutation(n)
        s, r = p[s], p[r]
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    return np.stack([s, r]), w


def both_graphs(ei, w, n):
    return (JGraph.from_edge_index(ei, w, num_nodes=n),
            TGraph.from_edge_index(ei, w, num_nodes=n, device="cpu"))


def t_dtype(bf16):
    return torch.bfloat16 if bf16 else None


def j_dtype(bf16):
    return jnp.bfloat16 if bf16 else None


def assert_half_equal(jh, th, bf16):
    """The tensors the port's kernels read against the JAX package's host
    arrays: tile coordinates as they are, the tiles without the JAX
    trailing tile, the remainder without its chunk padding."""
    jhost = jh._host
    assert (th.nnzb, th.num_rem, th.num_rows) == (
        jh.nnzb, jh.num_rem, jh.num_rows)
    for k in HOST_KEYS:
        np.testing.assert_array_equal(getattr(th, k).numpy(), jhost[k],
                                      err_msg=k)
    want = np.asarray(jhost["blocks"][:jh.nnzb]).astype(np.float32)
    assert th.blocks.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(th.blocks[:th.nnzb].float().numpy(), want)
    # the fused kernel's own trailing tile: its TMA map needs one tile even
    # where every edge spilled
    assert th.blocks.shape == (th.nnzb + 1, 128, 128)
    assert not th.blocks[th.nnzb:].any()
    nb = th.num_rows // 128
    cnt = np.bincount(jhost["block_rows"], minlength=nb)
    np.testing.assert_array_equal(th.tile_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(cnt)]))
    # padding slots hold val 0; every test graph's weights are >= 0.1
    vals = jhost["rem_vals"].reshape(-1)
    real = vals != 0
    assert int(real.sum()) == th.num_rem
    lrows = jhost["rem_lrows"].reshape(-1)[real]
    np.testing.assert_array_equal(th.rem_cols.numpy(), jhost["rem_cols"][real])
    np.testing.assert_array_equal(th.rem_vals.numpy(), vals[real])
    np.testing.assert_array_equal(th.rem_lrows.numpy(), lrows)
    chunk = jhost["rem_vals"].shape[-1]
    rows = np.repeat(jhost["rem_step_rb"], chunk)[real] * 128 + lrows
    np.testing.assert_array_equal(th.rem_rows.numpy(), rows)
    rbs, per = np.unique(rows // 128, return_counts=True)
    np.testing.assert_array_equal(th.rem_rbs.numpy(), rbs)
    np.testing.assert_array_equal(th.rem_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(per)]))
    assert_row_sorted_remainder(th, rows, jhost["rem_cols"][real],
                                vals[real])


def assert_row_sorted_remainder(th, rows, cols, vals):
    """The fused kernel's (row, col)-sorted remainder with its row pointer
    holds exactly the edges (rows, cols, vals) of the JAX package's padded
    remainder with the padding removed, each row in the same edge order."""
    ptr = th.rem_row_ptr.numpy()
    assert ptr.shape == (th.num_rows + 1,) and ptr[0] == 0
    assert ptr[-1] == th.num_rem and np.all(np.diff(ptr) >= 0)
    got_rows = np.repeat(np.arange(th.num_rows), np.diff(ptr))
    got_cols, got_vals = th.rem_row_cols.numpy(), th.rem_row_vals.numpy()
    order = np.argsort(rows, kind="stable")
    np.testing.assert_array_equal(got_rows, rows[order])
    np.testing.assert_array_equal(got_cols, cols[order])
    np.testing.assert_array_equal(got_vals, vals[order])
    # ascending columns within each row (a repeated edge keeps its place)
    same_row = got_rows[1:] == got_rows[:-1]
    assert np.all(got_cols[1:][same_row] >= got_cols[:-1][same_row])
    # the same edges as the compact arrays K2 walks, with the same rows
    want_rows = th.rem_rows.numpy()
    key = np.lexsort((vals, cols, rows))
    got = np.lexsort((got_vals, got_cols, got_rows))
    compact = np.lexsort((th.rem_vals.numpy(), th.rem_cols.numpy(),
                          want_rows))
    for a, b, c in ((rows, got_rows, want_rows),
                    (cols, got_cols, th.rem_cols.numpy()),
                    (vals, got_vals, th.rem_vals.numpy())):
        np.testing.assert_array_equal(b[got], a[key])
        np.testing.assert_array_equal(c[compact], a[key])


@pytest.mark.parametrize("n,e,mbe,pack,bf16", [
    (300, 3000, 0, 1, False),
    (700, 9000, 8, 4, True),
    (1000, 12000, 32, "auto", False),
    (2000, 30000, 32, 2, True),
    (1500, 4000, 10**6, 1, False),
])
def test_build_half_matches_jax_host(n, e, mbe, pack, bf16):
    """``pack`` shapes the JAX package's TPU step list only; whatever it
    is, the port's half holds the same tiles and remainder."""
    ei, w = banded(n, n, e)
    s, r = ei[0].astype(np.int32), ei[1].astype(np.int32)
    jh = jb._build_half(r, s, w, n, 128, j_dtype(bf16), mbe, pack)
    th = tb._build_half(r, s, w, n, 128, t_dtype(bf16), mbe, device="cpu")
    assert_half_equal(jh, th, bf16)


@pytest.mark.parametrize("reorder,mbe", [(None, "auto"), ("rcm", 32),
                                         ("auto", "auto")])
def test_from_graph_matches_jax(reorder, mbe):
    n = 1200
    ei, w = banded(5, n, 15000, scramble=reorder is not None)
    jg, tg = both_graphs(ei, w, n)
    jm = jb.BCSRMatrix.from_graph(jg, min_block_edges=mbe, reorder=reorder)
    tm = tb.BCSRMatrix.from_graph(tg, min_block_edges=mbe, reorder=reorder,
                                  costs=tb.TPU_V5E)
    assert (jm.perm is None) == (tm.perm is None)
    if jm.perm is not None:
        np.testing.assert_array_equal(tm.perm.numpy(), np.asarray(jm.perm))
        np.testing.assert_array_equal(tm.iperm.numpy(), np.asarray(jm.iperm))
    assert_half_equal(jm.fwd, tm.fwd, False)
    assert_half_equal(jm.bwd, tm.bwd, False)


@pytest.mark.parametrize("case", ["hybrid", "all-remainder", "reordered"])
def test_row_sorted_remainder_matches_jax(case):
    n = 1100
    ei, w = banded(12, n, 14000, scramble=case == "reordered")
    jg, tg = both_graphs(ei, w, n)
    kw = {"hybrid": dict(min_block_edges=32),
          "all-remainder": dict(min_block_edges=10**6),
          "reordered": dict(min_block_edges=32, reorder="rcm")}[case]
    jm = jb.BCSRMatrix.from_graph(jg, **kw)
    tm = tb.BCSRMatrix.from_graph(tg, **kw)
    assert (tm.perm is not None) == (case == "reordered")
    for jh, th in ((jm.fwd, tm.fwd), (jm.bwd, tm.bwd)):
        assert th.num_rem > 0 and (th.nnzb == 0) == (case == "all-remainder")
        assert_half_equal(jh, th, False)


def test_tuners_match_jax():
    n = 2000
    ei, _ = banded(1, n, 30000)
    for bf16 in (False, True):
        assert tb.tune_min_block_edges(ei[1], ei[0], n, dtype=t_dtype(bf16),
                                       costs=tb.TPU_V5E) \
            == jb.tune_min_block_edges(ei[1], ei[0], n, dtype=j_dtype(bf16))


# ---------------------------------------------------------------------------
# K1/K2 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _pallas_vs_plain(ei, w, n, f, bf16, mbe, side="fwd", seed=0):
    jg, tg = both_graphs(ei, w, n)
    jm = jb.BCSRMatrix.from_graph(jg, dtype=j_dtype(bf16),
                                  min_block_edges=mbe)
    tm = tb.BCSRMatrix.from_graph(tg, dtype=t_dtype(bf16),
                                  min_block_edges=mbe)
    jh, th = getattr(jm, side), getattr(tm, side)
    x = np.random.default_rng(seed).normal(
        size=(th.num_cols, f)).astype(np.float32)
    want = np.asarray(jb._bcsr_matmul_pallas(jh, jnp.asarray(x),
                                             interpret=True))
    got = tb.bcsr_matmul(th, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * max(1.0, np.abs(want).max()),
                               rtol=0)
    return th


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("side", ["fwd", "bwd"])
def test_plain_kernels_match_pallas_hybrid(bf16, side):
    """Tiles plus a non-empty remainder (the slice's shape of operator)."""
    n = 900
    ei, w = banded(2, n, 12000, frac_local=0.9)
    th = _pallas_vs_plain(ei, w, n, 24, bf16, 32, side)
    assert th.nnzb > 0 and th.num_rem > 0


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_kernels_match_pallas_all_spill(bf16):
    """Zero tiles: K1 writes zeros everywhere, K2 adds every edge."""
    n = 500
    ei, w = banded(3, n, 900, frac_local=0.0)
    th = _pallas_vs_plain(ei, w, n, 8, bf16, 10**6)
    assert th.nnzb == 0 and th.num_rem > 0


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_kernels_match_pallas_wide_f(bf16):
    """F > 128 (the Pallas kernel tiles F; the port masks a ragged edge)."""
    n = 300
    ei, w = banded(4, n, 2500)
    _pallas_vs_plain(ei, w, n, 200, bf16, 32)


def test_plain_tile_kernel_matches_pallas_all_tiles():
    """min_block_edges=0: every edge in a tile, K1 alone."""
    n = 400
    ei, w = banded(6, n, 3000)
    th = _pallas_vs_plain(ei, w, n, 16, True, 0)
    assert th.num_rem == 0


def test_plain_tile_kernel_uncovered_rows_zero():
    n = 900
    ei = np.array([[700], [700]])
    w = np.array([2.0], np.float32)
    _pallas_vs_plain(ei, w, n, 8, False, 0)


def test_remainder_values_round_to_bf16():
    """bf16 tiles: remainder values are rounded to bf16 like the Pallas
    one-hot, not kept f32 like the XLA fallback."""
    n = 300
    ei = np.array([[5], [200]])
    w = np.array([0.1234567], np.float32)
    tg = TGraph.from_edge_index(ei, w, num_nodes=n, device="cpu")
    tm = tb.BCSRMatrix.from_graph(tg, dtype=torch.bfloat16,
                                  min_block_edges=10**6)
    x = torch.zeros(tm.fwd.num_cols, 1)
    x[5] = 1.0
    out = tb.bcsr_matmul(tm.fwd, x)
    assert float(out[200, 0]) == float(torch.tensor(0.1234567).to(
        torch.bfloat16).float())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("side", ["fwd", "bwd"])
def test_hybrid_plain_matches_pallas_ragged_f(bf16, side):
    """The fused kernel's plain version against the Pallas pair at a ragged
    F (36: not a multiple of 8), both halves, both tile dtypes."""
    n = 800
    ei, w = banded(13, n, 10000, frac_local=0.9)
    jg, tg = both_graphs(ei, w, n)
    jm = jb.BCSRMatrix.from_graph(jg, dtype=j_dtype(bf16), min_block_edges=32)
    tm = tb.BCSRMatrix.from_graph(tg, dtype=t_dtype(bf16), min_block_edges=32)
    jh, th = getattr(jm, side), getattr(tm, side)
    assert th.nnzb > 0 and th.num_rem > 0
    x = np.random.default_rng(14).normal(
        size=(th.num_cols, 36)).astype(np.float32)
    want = np.asarray(jb._bcsr_matmul_pallas(jh, jnp.asarray(x),
                                             interpret=True))
    got = tb.hybrid_spmm_plain(th, torch.from_numpy(x).to(th.blocks.dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * max(1.0, np.abs(want).max()),
                               rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("f", [8, 36])
def test_hybrid_cpu_wrapper_takes_plain_and_counts_nothing(bf16, f):
    n = 600
    ei, w = banded(15, n, 6000)
    tg = TGraph.from_edge_index(ei, w, num_nodes=n, device="cpu")
    tm = tb.BCSRMatrix.from_graph(tg, dtype=t_dtype(bf16))
    assert tm.fwd.num_rem > 0
    tb.reset_launch_counts()
    x = torch.randn(tm.fwd.num_cols, f).to(tm.fwd.blocks.dtype)
    out = tb.hybrid_spmm(tm.fwd, x)
    torch.testing.assert_close(out, tb.hybrid_spmm_plain(tm.fwd, x),
                               rtol=0, atol=0)
    torch.testing.assert_close(out, tb.bcsr_matmul(tm.fwd, x), rtol=0,
                               atol=0)
    torch.testing.assert_close(
        out, tb.rem_scatter_plain(tm.fwd, x, tb.tile_spmm_plain(tm.fwd, x)),
        rtol=0, atol=0)
    assert (tb.hybrid_spmm.launches, tb.tile_spmm.launches,
            tb.rem_scatter_.launches) == (0, 0, 0)
    with pytest.raises(TypeError):
        tb.hybrid_spmm(tm.fwd, x.double())


def test_cpu_wrapper_takes_plain_and_counts_nothing():
    n = 600
    ei, w = banded(7, n, 6000)
    tg = TGraph.from_edge_index(ei, w, num_nodes=n, device="cpu")
    tm = tb.BCSRMatrix.from_graph(tg)
    tb.reset_launch_counts()
    x = torch.randn(tm.fwd.num_cols, 5)
    out = tb.tile_spmm(tm.fwd, x)
    torch.testing.assert_close(out, tb.tile_spmm_plain(tm.fwd, x))
    base = out.clone()
    tb.rem_scatter_(tm.fwd, x, out)
    torch.testing.assert_close(out, tb.rem_scatter_plain(tm.fwd, x, base))
    assert tb.tile_spmm.launches == 0 and tb.rem_scatter_.launches == 0
    with pytest.raises(TypeError):
        tb.tile_spmm(tm.fwd, x.double())


# ---------------------------------------------------------------------------
# autograd: bcsr_spmm forward and x-gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched,reorder", [(False, None), (True, None),
                                              (True, "rcm"), (True, "auto")])
def test_bcsr_spmm_autograd_matches_jax(batched, reorder):
    # 'auto' on a sparse narrow band (two edges a node within ±8): its
    # scrambled blocks fall under min_block_edges, so both packages' TPU
    # v5e cost models keep the RCM order and the gradient runs through the
    # permutations
    f = 6
    if reorder == "auto":
        n = 1024
        ei, w = banded(8, n, 2 * n, band=8, frac_local=1.0, scramble=True)
    else:
        n = 700
        ei, w = banded(8, n, 8000, scramble=reorder is not None)
    jg, tg = both_graphs(ei, w, n)
    jm = jb.BCSRMatrix.from_graph(jg, reorder=reorder)
    tm = tb.BCSRMatrix.from_graph(tg, reorder=reorder, costs=tb.TPU_V5E)
    assert tm.fwd.num_rem > 0
    assert (tm.perm is None) == (jm.perm is None) == (reorder is None)
    if reorder is not None:
        np.testing.assert_array_equal(tm.perm.numpy(), np.asarray(jm.perm))
    rng = np.random.default_rng(9)
    shape = (3, n, f) if batched else (n, f)
    x = rng.normal(size=shape).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)

    def jloss(fn):
        return lambda x_: jnp.sum(fn(x_) * cot)

    def jbcsr(x_):
        return jb.bcsr_spmm(jm, x_, use_pallas=False)

    def jseg(x_):
        return j_segment(jg, x_)

    xt = torch.from_numpy(x).requires_grad_()
    out = tb.bcsr_spmm(tm, xt)
    (gx,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    for fn in (jbcsr, jseg):
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(fn(jnp.asarray(x))),
                                   atol=1e-5)
        np.testing.assert_allclose(
            gx.numpy(), np.asarray(jax.grad(jloss(fn))(jnp.asarray(x))),
            atol=1e-5)


def test_bf16_gradient_matches_pallas_vjp():
    """bf16 tiles: the x-gradient is the transposed half applied to the
    cotangent with the same bf16 casts — what the JAX custom VJP runs."""
    n, f = 600, 5
    ei, w = banded(10, n, 7000)
    jg, tg = both_graphs(ei, w, n)
    jm = jb.BCSRMatrix.from_graph(jg, dtype=jnp.bfloat16)
    tm = tb.BCSRMatrix.from_graph(tg, dtype=torch.bfloat16)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, f)).astype(np.float32)
    cot = rng.normal(size=(n, f)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = tb.bcsr_spmm(tm, xt)
    (gx,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    assert gx.dtype == torch.float32
    g_pad = np.zeros((tm.bwd.num_rows, f), np.float32)
    g_pad[:n] = cot
    want = np.asarray(jb._bcsr_matmul_pallas(jm.bwd, jnp.asarray(g_pad),
                                             interpret=True))[:n]
    np.testing.assert_allclose(gx.numpy(), want,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("case", ["hybrid", "all-remainder", "reordered",
                                  "one-block"])
def test_density_and_the_earlier_name_match_jax(case):
    """``BCSRMatrix.density`` (kept tiles over the forward grid) equals the
    JAX package's on the same build, and ``BCSRGraph`` names the class in
    both packages."""
    n = {"one-block": 100}.get(case, 1300)
    ei, w = banded(31, n, 16000, scramble=case == "reordered")
    jg, tg = both_graphs(ei, w, n)
    kw = {"hybrid": dict(min_block_edges=32),
          "all-remainder": dict(min_block_edges=10**6),
          "reordered": dict(min_block_edges=32, reorder="rcm"),
          "one-block": dict(min_block_edges=8)}[case]
    jm = jb.BCSRMatrix.from_graph(jg, **kw)
    tm = tb.BCSRGraph.from_graph(tg, **kw)
    assert isinstance(tm, tb.BCSRMatrix) and tb.BCSRGraph is tb.BCSRMatrix
    assert jb.BCSRGraph is jb.BCSRMatrix
    assert tm.density == jm.density
    assert (tm.density == 0.0) == (case == "all-remainder")


@pytest.mark.parametrize("seed,n,e,scramble", [(1, 700, 9000, False),
                                               (2, 1500, 30000, True),
                                               (3, 128, 500, False),
                                               (4, 900, 0, False)])
def test_bcsr_structure_counts_match_jax(seed, n, e, scramble):
    """The structure pass alone: tile count, each edge's tile and the
    tiles' (row block, col block) in sorted order, the port's native layer
    against the JAX package's."""
    ei, _ = banded(seed, n, e, scramble=scramble)
    s, r = ei[0].astype(np.int32), ei[1].astype(np.int32)
    grid = -(-n // 128)
    want = jb.bcsr_structure_counts(s, r, 128, grid)
    got = tb.bcsr_structure_counts(s, r, 128, grid)
    assert got[0] == want[0] and (got[0] > 0) == (e > 0)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
