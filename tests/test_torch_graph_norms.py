"""Port parity: the GCN / Chebyshev normalizations, their host mirrors, the
prenormalized operators and the Chebyshev basis against the JAX package
(``ops/graph.py``, ``ops/operators.py``, ``models/conv.py:cheb_basis``).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: edge lists must be EQUAL; normalized weights are f32 results of
the same formulas (1e-6); the host mirrors compute in float64 and round
once (2e-6 against the f32 transforms); aggregations are f32 sums in
another order (1e-5 of the output's scale); bf16 operators round the same
values on both sides and are held to the Pallas kernel in interpret mode
(1e-5 of the scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu.models import conv as jconv
from pytorch_geometric_temporal_tpu.ops import Graph as JGraph
from pytorch_geometric_temporal_tpu.ops import bcsr as jb
from pytorch_geometric_temporal_tpu.ops import graph as jgraph
from pytorch_geometric_temporal_tpu.ops import operators as jops
from pytorch_geometric_temporal_tpu_torch import config_override
from pytorch_geometric_temporal_tpu_torch.models import cheb_basis
from pytorch_geometric_temporal_tpu_torch.ops import Graph as TGraph
from pytorch_geometric_temporal_tpu_torch.ops import bcsr as tb
from pytorch_geometric_temporal_tpu_torch.ops import graph as tgraph
from pytorch_geometric_temporal_tpu_torch.ops import operators as tops


def random_graph(seed, n, e, pad=0, loops=0, isolated=()):
    """Random weighted graph with ``loops`` self-loop edges; nodes in
    ``isolated`` get no edge; ``pad`` padding edges trail."""
    rng = np.random.default_rng(seed)
    ei = np.unique(rng.integers(0, n, size=(2, e)), axis=1)
    ei = ei[:, ei[0] != ei[1]]
    loop = rng.choice(n, size=loops, replace=False)
    ei = np.concatenate([ei, np.stack([loop, loop])], axis=1)
    ei = ei[:, ~np.isin(ei, list(isolated)).any(axis=0)]
    w = rng.uniform(0.1, 2.0, ei.shape[1]).astype(np.float32)
    pad_to = ei.shape[1] + pad
    return (JGraph.from_edge_index(ei, w, num_nodes=n, pad_to=pad_to),
            TGraph.from_edge_index(ei, w, num_nodes=n, pad_to=pad_to,
                                   device="cpu"))


def symmetric_graph(seed, n, e):
    """Undirected (both directions, equal weights), no self-loops."""
    rng = np.random.default_rng(seed)
    ei = np.unique(rng.integers(0, n, size=(2, e)), axis=1)
    ei = ei[:, ei[0] < ei[1]]
    w = rng.uniform(0.1, 2.0, ei.shape[1]).astype(np.float32)
    ei = np.concatenate([ei, ei[::-1]], axis=1)
    w = np.concatenate([w, w])
    return (JGraph.from_edge_index(ei, w, num_nodes=n),
            TGraph.from_edge_index(ei, w, num_nodes=n, device="cpu"))


def assert_graph_close(t, j, atol=1e-6):
    """Same full (padded) edge tensors and metadata."""
    assert (t.num_nodes, t.num_edges, t.edge_pad) == (
        j.num_nodes, j.num_edges, j.edge_pad)
    np.testing.assert_array_equal(t.senders.numpy(), np.asarray(j.senders))
    np.testing.assert_array_equal(t.receivers.numpy(),
                                  np.asarray(j.receivers))
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               atol=atol, rtol=1e-6)


@pytest.mark.parametrize("pad", [0, 5])
def test_self_loop_transforms_match_jax(pad):
    jg, tg = random_graph(0, 30, 120, pad=pad, loops=4)
    assert_graph_close(tg.remove_self_loops(), jg.remove_self_loops())
    assert_graph_close(tg.add_self_loops(2.0), jg.add_self_loops(2.0))


@pytest.mark.parametrize("improved", [False, True])
@pytest.mark.parametrize("add_self_loops", [False, True])
def test_gcn_norm_matches_jax_and_host(improved, add_self_loops):
    jg, tg = random_graph(1, 40, 200, pad=3, loops=3, isolated=(7,))
    want = jgraph.gcn_norm(jg, improved, add_self_loops)
    assert_graph_close(tgraph.gcn_norm(tg, improved, add_self_loops), want)
    host = tops.host_gcn_norm(tg, improved, add_self_loops)
    assert_graph_close(host, jops.host_gcn_norm(jg, improved,
                                                add_self_loops))
    # the host mirror against the tensor transform, as dense matrices
    # (the mirror drops the padding, so the edge lists differ in length)
    np.testing.assert_allclose(host.to_adj_t().numpy(),
                               np.asarray(want.to_adj_t()), atol=2e-6)


@pytest.mark.parametrize("normalization", ["sym", "rw", None])
def test_laplacian_matches_jax(normalization):
    jg, tg = random_graph(2, 35, 150, pad=4, isolated=(0, 9))
    assert_graph_close(tgraph.laplacian(tg, normalization),
                       jgraph.laplacian(jg, normalization))


def test_laplacian_rejects_unknown_normalization():
    _, tg = random_graph(2, 10, 30)
    with pytest.raises(ValueError, match="unknown normalization"):
        tgraph.laplacian(tg, "col")
    with pytest.raises(ValueError, match="unknown normalization"):
        tops.host_cheb_norm(tg, "col")


@pytest.mark.parametrize("normalization", ["sym", "rw", None])
@pytest.mark.parametrize("lam", [None, 1.7])
def test_cheb_norm_matches_jax_and_host(normalization, lam):
    jg, tg = random_graph(3, 40, 220, pad=2, loops=5, isolated=(11,))
    want = jgraph.cheb_norm(jg, normalization, lam)
    got = tgraph.cheb_norm(tg, normalization, lam)
    assert_graph_close(got, want)
    # a 0-dim tensor λ_max takes the unmemoized branch, same numbers
    if lam is not None:
        assert_graph_close(
            tgraph.cheb_norm(tg, normalization, torch.tensor(lam)), want)
    host = tops.host_cheb_norm(tg, normalization, lam)
    assert_graph_close(host, jops.host_cheb_norm(jg, normalization, lam))
    np.testing.assert_allclose(host.to_adj_t().numpy(),
                               np.asarray(want.to_adj_t()), atol=2e-6)


def test_cheb_norm_is_memoized_per_graph():
    _, tg = random_graph(3, 20, 80)
    assert tgraph.cheb_norm(tg) is tgraph.cheb_norm(tg, "sym", 2.0)
    assert tgraph.cheb_norm(tg, "rw") is not tgraph.cheb_norm(tg)
    assert tgraph.gcn_norm(tg) is tgraph.gcn_norm(tg)


@pytest.mark.parametrize("normalization", ["sym", "rw", None])
def test_lambda_max_matches_jax_and_eigvals(normalization):
    jg, tg = symmetric_graph(4, 24, 90)
    want = float(jgraph.lambda_max(jg, normalization))
    got = tgraph.lambda_max(tg, normalization)
    assert got.shape == ()
    # 64 power iterations in f32 on both sides
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    lap = tgraph.laplacian(tg, normalization).to_adj_t().double().numpy()
    top = np.abs(np.linalg.eigvals(lap)).max()
    np.testing.assert_allclose(float(got), top, rtol=2e-2)


def test_pad_and_stack_graphs_match_jax():
    pairs = [random_graph(10 + i, 25, 60 + 20 * i) for i in range(3)]
    jgs, tgs = [p[0] for p in pairs], [p[1] for p in pairs]
    for t, j in zip(tgraph.pad_graphs(tgs), jgraph.pad_graphs(jgs)):
        assert_graph_close(t, j)
    for t, j in zip(tgraph.pad_graphs(tgs, 200), jgraph.pad_graphs(jgs, 200)):
        assert_graph_close(t, j)
    with pytest.raises(ValueError, match="pad_to smaller"):
        tgraph.pad_graphs(tgs, 3)
    assert_graph_close(tgraph.stack_graphs(tgs), jgraph.stack_graphs(jgs))
    _, other = random_graph(20, 26, 60)
    with pytest.raises(ValueError, match="share num_nodes"):
        tgraph.stack_graphs(tgs + [other])


def test_prepared_graph_returns_prebuilt_operators():
    jg, tg = random_graph(5, 30, 140, loops=2)
    prep = tops.prepare_graph(tg, bcsr=False, device="cpu")
    jprep = jops.prepare_graph(jg, bcsr=False)
    assert set(prep.ops) == set(jprep.ops)
    assert (prep.num_nodes, prep.num_edges, prep.num_src) == (
        tg.num_nodes, tg.num_edges, None)
    gcn = tgraph.gcn_norm(prep)
    assert gcn is prep.ops[("gcn_norm", False, True)]
    assert_graph_close(gcn, jgraph.gcn_norm(jprep))
    cheb = tgraph.cheb_norm(prep)
    assert cheb is prep.ops[("cheb_norm", "sym", 2.0)]
    assert_graph_close(cheb, jgraph.cheb_norm(jprep))
    fwd, bwd = tgraph.diffusion_norms(prep)
    assert (fwd, bwd) == prep.ops[("diffusion_norms",)]
    jf, jb_ = jgraph.diffusion_norms(jprep)
    assert_graph_close(fwd, jf)
    assert_graph_close(bwd, jb_)
    # a key that was not prebuilt is recomputed from the raw graph
    assert_graph_close(tgraph.cheb_norm(prep, "rw"),
                       jgraph.cheb_norm(jg, "rw"))
    assert_graph_close(tgraph.gcn_norm(prep, improved=True),
                       jgraph.gcn_norm(jg, improved=True))
    only = tops.prepare_graph(tg, kinds=("cheb",), cheb_lambda_max=1.5,
                              bcsr=True, device="cpu")
    assert list(only.ops) == [("cheb_norm", "sym", 1.5)]
    assert isinstance(only.ops[("cheb_norm", "sym", 1.5)], tb.BCSRMatrix)


def test_prenormalize_gcn_matches_jax():
    jg, tg = random_graph(6, 300, 3000, loops=10)
    x = np.random.default_rng(7).normal(size=(300, 6)).astype(np.float32)
    op = tops.prenormalize_gcn(tg, device="cpu")
    assert_graph_close(op, jops.prenormalize_gcn(jg))
    mat = tops.prenormalize_gcn(tg, bcsr=True, min_block_edges=4,
                                device="cpu")
    jmat = jops.prenormalize_gcn(jg, bcsr=True, min_block_edges=4)
    assert (mat.fwd.nnzb, mat.fwd.num_rem) == (jmat.fwd.nnzb,
                                               jmat.fwd.num_rem)
    want = np.asarray(jb.bcsr_spmm(jmat, jnp.asarray(x)))
    got = tb.bcsr_spmm(mat, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def banded_graph(seed, n, e, band=30):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, size=e)
    r = np.clip(s + rng.integers(-band, band + 1, size=e), 0, n - 1)
    cross = rng.random(e) < 0.1
    r[cross] = rng.integers(0, n, size=cross.sum())
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    ei = np.stack([s, r])
    return (JGraph.from_edge_index(ei, w, num_nodes=n),
            TGraph.from_edge_index(ei, w, num_nodes=n, device="cpu"))


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("bf16", [False, True])
def test_cheb_basis_over_bcsr_operator_matches_jax(K, bf16):
    """``prenormalize_cheb(bcsr=True)`` + ``cheb_basis`` on both sides.  On
    the CPU the JAX ``bcsr_spmm`` takes its XLA path, which keeps bf16
    remainder values in f32 where the Pallas kernel and the port round
    them to bf16: up to 2^-9 relative per remainder edge, so the bf16
    case is held to 1e-2 of the scale and to the kernel below."""
    n, f = 700, 14
    jg, tg = banded_graph(8, n, 8000)
    jop = jops.prenormalize_cheb(jg, "sym", bcsr=True, min_block_edges=32,
                                 dtype=jnp.bfloat16 if bf16 else None)
    top = tops.prenormalize_cheb(tg, "sym", bcsr=True, min_block_edges=32,
                                 dtype=torch.bfloat16 if bf16 else None,
                                 device="cpu")
    assert isinstance(top.op, tb.BCSRMatrix) and top.num_nodes == n
    assert top.op.fwd.nnzb == jop.op.fwd.nnzb > 0
    assert top.op.fwd.num_rem == jop.op.fwd.num_rem > 0
    x = np.random.default_rng(9).normal(size=(2, n, f)).astype(np.float32)
    want = np.asarray(jconv.cheb_basis(jop, jnp.asarray(x), K))
    got = cheb_basis(top, torch.from_numpy(x), K).numpy()
    assert got.shape == (2, n, K * f)
    tol = (1e-2 if bf16 else 1e-5) * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol)
    # the same basis from the raw graph: the f32 segment path
    with config_override(spmm_backend="segment"):
        seg = cheb_basis(tg, torch.from_numpy(x), K).numpy()
    np.testing.assert_allclose(got, seg, atol=(2e-2 if bf16 else 1e-5)
                               * np.abs(seg).max())


@pytest.mark.parametrize("f", [14, 1])
def test_cheb_operator_aggregation_matches_pallas_interpret(f):
    """One aggregation through the bf16 Chebyshev operator (cancelling
    +1/−1 self-loops, negative off-diagonal weights) at the ragged widths
    of the snapshot pipeline, against the Pallas kernels in interpret
    mode."""
    n = 700
    jg, tg = banded_graph(8, n, 8000)
    jop = jops.prenormalize_cheb(jg, "sym", bcsr=True, min_block_edges=32,
                                 dtype=jnp.bfloat16).op
    top = tops.prenormalize_cheb(tg, "sym", bcsr=True, min_block_edges=32,
                                 dtype=torch.bfloat16, device="cpu").op
    x = np.random.default_rng(10).normal(
        size=(top.fwd.num_cols, f)).astype(np.float32)
    for jh, th in ((jop.fwd, top.fwd), (jop.bwd, top.bwd)):
        want = np.asarray(jb._bcsr_matmul_pallas(jh, jnp.asarray(x),
                                                 interpret=True))
        got = tb.bcsr_matmul(th, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
    # λ_max = 2: every node's two self-loop entries cancel, so the
    # operator's diagonal is zero and a constant vector maps to the
    # (negative) normalized row sums
    dense = tgraph.cheb_norm(tg).to_adj_t().numpy()
    np.testing.assert_allclose(np.diag(dense), 0.0, atol=1e-6)
