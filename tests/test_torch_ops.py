"""Port parity: Graph, diffusion norms, spmm backends, config and the native
construction helpers against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: norms are f32 results of the same float64/f32 formulas (1e-6);
aggregations are f32 sums in another order (1e-5).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu import native as jnative
from pytorch_geometric_temporal_tpu.ops import Graph as JGraph
from pytorch_geometric_temporal_tpu.ops import graph as jgraph
from pytorch_geometric_temporal_tpu.ops import operators as jops
from pytorch_geometric_temporal_tpu_torch import config_override, get_config
from pytorch_geometric_temporal_tpu_torch import native as tnative
from pytorch_geometric_temporal_tpu_torch.ops import Graph as TGraph
from pytorch_geometric_temporal_tpu_torch.ops import graph as tgraph
from pytorch_geometric_temporal_tpu_torch.ops import operators as tops
from pytorch_geometric_temporal_tpu_torch.ops.bcsr import BCSRMatrix
from _torch_jax_native import jax_native  # noqa: F401

# the JAX package's native library, loaded race-free: its RCM order is
# what the port's native layer is compared with (see the module)
pytestmark = pytest.mark.usefixtures("jax_native")


# the ops packages re-export the spmm function under the module's name
jspmm = importlib.import_module("pytorch_geometric_temporal_tpu.ops.spmm")
tspmm = importlib.import_module(
    "pytorch_geometric_temporal_tpu_torch.ops.spmm")


def random_graph(seed, n, e, pad=0, isolated=()):
    """Random weighted graph; nodes in ``isolated`` get no edges at all
    (zero in- and out-degree), ``pad`` padding edges trail."""
    rng = np.random.default_rng(seed)
    ei = np.unique(rng.integers(0, n, size=(2, e)), axis=1)
    keep = ~np.isin(ei, list(isolated)).any(axis=0)
    ei = ei[:, keep]
    w = rng.uniform(0.1, 2.0, ei.shape[1]).astype(np.float32)
    pad_to = ei.shape[1] + pad
    return (JGraph.from_edge_index(ei, w, num_nodes=n, pad_to=pad_to),
            TGraph.from_edge_index(ei, w, num_nodes=n, pad_to=pad_to,
                                   device="cpu"))


def edges(g):
    e = g.num_edges
    return (np.asarray(g.senders)[:e], np.asarray(g.receivers)[:e],
            np.asarray(g.weights)[:e])


def assert_graph_close(t, j, atol=1e-6):
    assert (t.num_nodes, t.num_edges) == (j.num_nodes, j.num_edges)
    ts, tr, tw = edges(t)
    js, jr, jw = edges(j)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tw, jw, atol=atol, rtol=1e-6)


def test_graph_basics_match_jax():
    jg, tg = random_graph(0, 60, 300, pad=7)
    assert tg.edge_pad == jg.edge_pad and tg.num_edges == jg.num_edges
    np.testing.assert_array_equal(tg.edge_mask().numpy(),
                                  np.asarray(jg.edge_mask()))
    np.testing.assert_array_equal(tg.masked_weights().numpy(),
                                  np.asarray(jg.masked_weights()))
    for a, b in ((tg.in_degree(), jg.in_degree()),
                 (tg.out_degree(), jg.out_degree()),
                 (tg.in_degree(weighted=False), jg.in_degree(weighted=False)),
                 (tg.to_adj_t(), jg.to_adj_t())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    rt, rj = tg.reverse(), jg.reverse()
    np.testing.assert_array_equal(rt.senders.numpy(), np.asarray(rj.senders))
    s, r, w = tg.host_edges()
    assert not s.flags.writeable and s.dtype == np.int32
    # without the cache the host edges come back from the device
    s2, r2, w2 = tg.with_weights(tg.weights * 2).host_edges()
    np.testing.assert_array_equal(s2, s)
    np.testing.assert_allclose(w2, 2 * w)


@pytest.mark.parametrize("pad", [0, 5])
def test_diffusion_norms_match_jax(pad):
    jg, tg = random_graph(1, 80, 400, pad=pad, isolated=(3, 17, 40))
    for t, j in zip(tgraph.diffusion_norms(tg), jgraph.diffusion_norms(jg)):
        assert_graph_close(t, j)
        assert np.isfinite(np.asarray(t.weights)).all()
    # memoized per Graph instance
    assert tgraph.diffusion_norms(tg)[0] is tgraph.diffusion_norms(tg)[0]


def test_host_diffusion_norms_match_jax():
    jg, tg = random_graph(2, 90, 500, pad=3, isolated=(0, 89))
    for t, j in zip(tops.host_diffusion_norms(tg),
                    jops.host_diffusion_norms(jg)):
        assert_graph_close(t, j)
    # host (float64) and device (f32) norms agree with each other too
    for t, d in zip(tops.host_diffusion_norms(tg),
                    tgraph.diffusion_norms(tg)):
        w_d = d.masked_weights().numpy()
        dense_h = np.zeros((90, 90))
        dense_d = np.zeros((90, 90))
        np.add.at(dense_h, (edges(t)[1], edges(t)[0]), edges(t)[2])
        np.add.at(dense_d, (d.receivers.numpy(), d.senders.numpy()), w_d)
        np.testing.assert_allclose(dense_h, dense_d, atol=1e-6)


@pytest.mark.parametrize("backend", ["dense", "segment"])
@pytest.mark.parametrize("batched", [False, True])
def test_spmm_matches_jax(backend, batched):
    jg, tg = random_graph(3, 70, 350, pad=4)
    shape = (2, 70, 5) if batched else (70, 5)
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    w_over = np.random.default_rng(5).uniform(
        size=tg.edge_pad).astype(np.float32)
    want = jspmm.spmm(jg, jnp.asarray(x), backend=backend)
    got = tspmm.spmm(tg, torch.from_numpy(x), backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = jspmm.spmm(jg, jnp.asarray(x), jnp.asarray(w_over),
                      backend=backend)
    got = tspmm.spmm(tg, torch.from_numpy(x), torch.from_numpy(w_over),
                     backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_spmm_dispatch():
    _, small = random_graph(6, 50, 200)
    x = torch.randn(50, 3)
    assert tspmm._resolve_backend(small, x, None) == "dense"
    with config_override(dense_threshold=10):
        # large graph on the CPU: segment; a forced bcsr builds the operator
        assert tspmm._resolve_backend(small, x, None) == "segment"
    with config_override(spmm_backend="bcsr", spmm_reorder="off"):
        out = tspmm.spmm(small, x)
    torch.testing.assert_close(out, tspmm.spmm_segment(small, x),
                               atol=1e-5, rtol=0)
    assert any(k[0] == "bcsr" for k in small._op_cache)
    mat = BCSRMatrix.from_graph(small)
    torch.testing.assert_close(tspmm.spmm(mat, x),
                               tspmm.spmm_segment(small, x),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        tspmm.spmm(mat, x, weights=small.weights)


def test_config_rejects_unknown_values():
    assert get_config().spmm_backend == "auto"
    for kw in ({"spmm_backend": "pallas"}, {"spmm_reorder": "rcm"},
               {"no_such_field": 1}):
        with pytest.raises(ValueError):
            with config_override(**kw):
                pass
    assert get_config().spmm_backend == "auto"
    with config_override(spmm_backend="segment") as cfg:
        assert cfg.spmm_backend == "segment"
    assert get_config().spmm_backend == "auto"


def test_native_helpers_match_jax_and_numpy(monkeypatch):
    rng = np.random.default_rng(7)
    n = 700
    s = rng.integers(0, n, size=5000).astype(np.int32)
    r = np.clip(s + rng.integers(-30, 31, size=5000), 0, n - 1).astype(
        np.int32)
    w = rng.uniform(size=5000).astype(np.float32)
    t_struct = tnative.bcsr_structure(s, r, 128, 6)
    j_struct = jnative.bcsr_structure(s, r, 128, 6)
    for a, b in zip(t_struct, j_struct):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tnative.bcsr_fill(s, r, w, t_struct[1], 128, t_struct[0]),
        jnative.bcsr_fill(s, r, w, j_struct[1], 128, j_struct[0]))
    for name in ("rcm_order", "edge_triangle_support",
                 "bandwidth_reduction_order"):
        np.testing.assert_array_equal(getattr(tnative, name)(s, r, n),
                                      getattr(jnative, name)(s, r, n))
    assert tnative.get_lib() is not None
    # the numpy paths give the same structure and tiles
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    np_struct = tnative.bcsr_structure(s, r, 128, 6)
    for a, b in zip(np_struct, t_struct):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        tnative.bcsr_fill(s, r, w, np_struct[1], 128, np_struct[0]),
        jnative.bcsr_fill(s, r, w, j_struct[1], 128, j_struct[0]),
        atol=1e-6)
    perm = tnative.rcm_order(s, r, n)
    np.testing.assert_array_equal(np.sort(perm), np.arange(n))


def test_sddmm_matches_jax():
    jg, tg = random_graph(21, 40, 200, pad=6)
    rng = np.random.default_rng(22)
    a = rng.normal(size=(40, 5)).astype(np.float32)
    b = rng.normal(size=(40, 5)).astype(np.float32)
    want = np.asarray(jspmm.sddmm(jg, jnp.asarray(a), jnp.asarray(b)))
    got = tspmm.sddmm(tg, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert got.shape == (tg.edge_pad,) and not got[tg.num_edges:].any()
    prepared = tops.prepare_graph(tg, kinds=("gcn",), device="cpu")
    np.testing.assert_array_equal(
        tspmm.sddmm(prepared, torch.from_numpy(a),
                    torch.from_numpy(b)).numpy(), got.numpy())


def test_to_adj_matches_jax():
    jg, tg = random_graph(23, 17, 60, pad=4)
    np.testing.assert_array_equal(tg.to_adj().numpy(),
                                  np.asarray(jg.to_adj()))
    np.testing.assert_array_equal(tg.to_adj().numpy(),
                                  tg.to_adj_t().numpy().T)
    assert tg.to_adj(torch.float64).dtype == torch.float64


@pytest.mark.parametrize("pad", [0, 9])
def test_reorder_graph_matches_jax(pad):
    # a banded graph with its node ids shuffled: the ordering has work to do
    n = 300
    rng = np.random.default_rng(24)
    s = rng.integers(0, n, size=2400)
    r = np.clip(s + rng.integers(-6, 7, size=2400), 0, n - 1)
    shuffle = rng.permutation(n)
    ei = np.unique(np.stack([shuffle[s], shuffle[r]]), axis=1)
    w = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    pad_to = ei.shape[1] + pad
    jg = JGraph.from_edge_index(ei, w, num_nodes=n, pad_to=pad_to)
    tg = TGraph.from_edge_index(ei, w, num_nodes=n, pad_to=pad_to,
                                device="cpu")
    jg2, jperm, jiperm = jgraph.reorder_graph(jg)
    tg2, tperm, tiperm = tgraph.reorder_graph(tg)
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(tiperm, jiperm)
    assert sorted(tperm) == list(range(n)) and not (tperm == np.arange(n)
                                                    ).all()
    np.testing.assert_array_equal(tg2.senders.numpy(), jg2.senders)
    np.testing.assert_array_equal(tg2.receivers.numpy(), jg2.receivers)
    np.testing.assert_array_equal(tg2.weights.numpy(), jg2.weights)
    assert (tg2.num_nodes, tg2.num_edges, tg2.edge_pad) == (n, ei.shape[1],
                                                            pad_to)
    # aggregation in permuted space, un-permuted, is the original one
    x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    out = tspmm.spmm_segment(tg2, x[tperm])[tiperm]
    np.testing.assert_allclose(out.numpy(),
                               tspmm.spmm_segment(tg, x).numpy(), atol=1e-5)


def test_reorder_graph_rejects_bipartite_graphs():
    g = TGraph.from_edge_index(np.array([[0, 1], [1, 0]]), num_nodes=2,
                               num_src=3, device="cpu")
    with pytest.raises(ValueError, match="square"):
        tgraph.reorder_graph(g)


@pytest.mark.parametrize("name", ["rmse", "mape"])
def test_rmse_and_mape_match_jax(name):
    from pytorch_geometric_temporal_tpu.train import losses as jlosses
    from pytorch_geometric_temporal_tpu_torch import train as ttrain

    rng = np.random.default_rng(25)
    pred = rng.normal(size=(4, 9)).astype(np.float32)
    target = rng.normal(size=(4, 9)).astype(np.float32)
    target[0, :3] = 0.0         # mape's eps floor
    want = float(getattr(jlosses, name)(jnp.asarray(pred),
                                        jnp.asarray(target)))
    got = float(getattr(ttrain, name)(torch.from_numpy(pred),
                                      torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("ratio", [0.1, 0.34, 1.0])
def test_topk_pool_breaks_ties_like_jax(ratio):
    """One-hot rows repeat, so many nodes share a score: the selected
    indices are the JAX package's (the lowest index among equals)."""
    from pytorch_geometric_temporal_tpu.models import conv as jconv
    from pytorch_geometric_temporal_tpu_torch.models import conv as tconv

    rng = np.random.default_rng(26)
    x = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=50)]
    p = rng.normal(size=4).astype(np.float32)
    jout, jidx = jconv.topk_pool(jnp.asarray(x), jnp.asarray(p), ratio)
    tout, tidx = tconv.topk_pool(torch.from_numpy(x), torch.from_numpy(p),
                                 ratio)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6)
    assert tout.shape == (max(1, int(np.ceil(50 * ratio))), 4)
