"""Port parity: the reordered BCSR operator (``spmm_reorder="auto"``) under
DCRNNSeq on a graph whose node ids come scrambled, and AVWGCN's sparse
top-k support just above the dense guard.

Inputs are made with numpy from a seed and handed to both packages; the
flax parameters of the JAX model are loaded into the torch module with
``params_from_flax``.  The graph is PeMS-like (each sensor sends ``deg``
edges to others within ±``offset``) at N=2048 with two edges a sensor, its
ids scrambled by a seeded permutation σ: the scrambled blocks hold about 16
edges, under ``min_block_edges=32``, so the operator as the ids come is all
remainder and both packages' cost models keep the RCM order.

Tolerances: both sides sum the same f32 products in another order —
outputs within 1e-5 of the largest output, each parameter's gradient within
1e-5 of its largest entry.  A permutation moves values without arithmetic,
so its gradient is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu import config as jconfig
from pytorch_geometric_temporal_tpu.models import DCRNNSeq as JDCRNNSeq
from pytorch_geometric_temporal_tpu.models import conv as jconv
from pytorch_geometric_temporal_tpu.ops import Graph as JGraph
from pytorch_geometric_temporal_tpu.ops.graph import (
    diffusion_norms as j_diffusion_norms)
from pytorch_geometric_temporal_tpu_torch import config_override
from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq, _cells
from pytorch_geometric_temporal_tpu_torch.models import conv as tconv
from pytorch_geometric_temporal_tpu_torch.ops import Graph as TGraph
from pytorch_geometric_temporal_tpu_torch.ops import bcsr as tb
from pytorch_geometric_temporal_tpu_torch.ops import reorder_graph
from pytorch_geometric_temporal_tpu_torch.ops.graph import diffusion_norms
from _torch_jax_native import jax_native  # noqa: F401

# the JAX package's native library, loaded race-free: its RCM order is
# what the port's native layer is compared with (see the module)
pytestmark = pytest.mark.usefixtures("jax_native")


N, DEG, OFFSET = 2048, 2, 8
F, C, K, B, T = 2, 4, 2, 2, 3
TOL = 1e-5


def pems_like(seed=0):
    """(edge_index, weights, σ): the banded graph in its own ids and σ,
    a permutation of the ids (sensor i is called σ[i])."""
    rng = np.random.default_rng(seed)
    s = np.repeat(np.arange(N), DEG)
    r = np.clip(s + rng.integers(-OFFSET, OFFSET + 1, size=s.shape[0]),
                0, N - 1)
    w = rng.uniform(0.3, 1.0, s.shape[0]).astype(np.float32)
    return np.stack([s, r]), w, rng.permutation(N)


def scramble(ei, x, sigma):
    """The same graph and series under the ids σ: edges (σ[s], σ[r]),
    ``x_s[..., σ[i], :] = x[..., i, :]``."""
    x_s = np.empty_like(x)
    x_s[..., sigma, :] = x
    return sigma[ei], x_s


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, N, F)).astype(np.float32)
    cot = rng.normal(size=(B, T, N, C)).astype(np.float32)
    return x, cot


def operators(norms):
    """The BCSR operators cached on the diffusion-normalized graphs."""
    return [m for p in norms for m in p._op_cache.values()
            if hasattr(m, "fwd") and hasattr(m, "perm")]


def port_run(model, graph, x, cot):
    """Outputs and {name: parameter gradient} of sum(out · cot)."""
    model.zero_grad()
    out = model(torch.from_numpy(x), graph)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), {k: p.grad.clone()
                          for k, p in model.named_parameters()}


def assert_close_by_scale(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got).reshape(want.shape), want,
                               rtol=0, atol=TOL * np.abs(want).max(),
                               err_msg=msg)


def test_dcrnnseq_reordered_bcsr_matches_jax(monkeypatch):
    """Both packages build the reordered operator through their spmm auto
    route (the port's ``bcsr`` backend, the JAX package's ``pallas``
    backend and its CPU fallback), keep the same permutation, and give the
    same outputs and parameter gradients; the port's decisions priced by
    the JAX package's TPU v5e cost model."""
    monkeypatch.setattr(tb, "DEFAULT_COSTS", tb.TPU_V5E)
    ei, w, sigma = pems_like()
    ei_s, _ = scramble(ei, np.zeros((N, 1), np.float32), sigma)
    x, cot = inputs()
    jg = JGraph.from_edge_index(ei_s, w, num_nodes=N)
    tg = TGraph.from_edge_index(ei_s, w, num_nodes=N, device="cpu")

    jm = JDCRNNSeq(out_channels=C, K=K)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    with jconfig.config_override(spmm_backend="pallas", spmm_reorder="auto"):
        out_j = jm.apply(params, jnp.asarray(x), jg)
        grads_j = jax.grad(lambda p: jnp.sum(
            jm.apply(p, jnp.asarray(x), jg) * cot))(params)
    tm = DCRNNSeq(F, C, K, device="cpu").params_from_flax(
        jax.tree_util.tree_map(np.asarray, params))
    with config_override(spmm_backend="bcsr", spmm_reorder="auto"):
        out_t, grads_t = port_run(tm, tg, x, cot)

    jmats, tmats = (operators(j_diffusion_norms(jg)),
                    operators(diffusion_norms(tg)))
    assert len(jmats) == len(tmats) == 2
    for jmat, tmat in zip(jmats, tmats):
        assert jmat.perm is not None and tmat.perm is not None
        np.testing.assert_array_equal(tmat.perm.numpy(), np.asarray(jmat.perm))
        np.testing.assert_array_equal(tmat.iperm.numpy(),
                                      np.asarray(jmat.iperm))
        # the operator as the ids come would be all remainder
        assert tmat.fwd.nnzb > 0
    assert_close_by_scale(out_t.numpy(), out_j, "outputs")
    flat = _cells._flatten(jax.tree_util.tree_map(np.asarray,
                                                  grads_j)["params"])
    assert set(flat) == set(grads_t)
    for name, g in grads_t.items():
        assert_close_by_scale(g.numpy(), flat[name], name)


def _recipe_run(model, tg_s, x_s, cot_s):
    """The model-level recipe: ``reorder_graph`` once, the series permuted
    once at the boundary, the model run in the new ids on the operator as
    those ids come, the outputs permuted back."""
    g2, perm, iperm = reorder_graph(tg_s)
    with config_override(spmm_reorder="off"):
        out2, grads = port_run(model, g2, x_s[..., perm, :],
                               cot_s[..., perm, :])
    mats = operators(diffusion_norms(g2))
    assert mats and all(m.perm is None for m in mats)
    return out2[..., torch.from_numpy(iperm).long(), :], grads


@pytest.mark.parametrize("route", ["auto", "off", "reorder_graph"])
def test_scrambled_run_is_equivariant(route, monkeypatch):
    """The port's run on the scrambled graph and series, un-permuted by σ,
    equals its run on the graph in its own ids: with the operator
    reordered (auto, priced by the TPU v5e cost model, which keeps the
    RCM order here), as the ids come (off), and through the recipe."""
    monkeypatch.setattr(tb, "DEFAULT_COSTS", tb.TPU_V5E)
    ei, w, sigma = pems_like()
    x, cot = inputs()
    ei_s, x_s = scramble(ei, x, sigma)
    _, cot_s = scramble(ei, cot, sigma)
    tg = TGraph.from_edge_index(ei, w, num_nodes=N, device="cpu")
    tg_s = TGraph.from_edge_index(ei_s, w, num_nodes=N, device="cpu")
    model = DCRNNSeq(F, C, K, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    with config_override(spmm_backend="bcsr", spmm_reorder="off"):
        want, want_grads = port_run(model, tg, x, cot)
        if route == "reorder_graph":
            got_s, grads = _recipe_run(model, tg_s, x_s, cot_s)
        else:
            with config_override(spmm_reorder=route):
                got_s, grads = port_run(model, tg_s, x_s, cot_s)
            mats = operators(diffusion_norms(tg_s))
            assert len(mats) == 2
            assert all((m.perm is not None) == (route == "auto")
                       for m in mats)
    got = got_s[..., torch.from_numpy(sigma).long(), :]
    assert_close_by_scale(got.numpy(), want.numpy(), "outputs")
    for name, g in grads.items():
        assert_close_by_scale(g.numpy(), want_grads[name].numpy(), name)


def test_avwgcn_topk_above_the_dense_guard_matches_jax():
    """AVWGCN(topk=8) at N=9000 (past the 8192-node guard of the dense
    form): the same kept columns, forward and gradients."""
    n, d, f = 9000, 4, 3
    rng = np.random.default_rng(26)
    e = rng.normal(size=(n, d)).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    jm = jconv.AVWGCN(out_channels=4, K=2, embedding_dimensions=d, topk=8)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(e))

    def jloss(p, ee):
        return (jm.apply(p, jnp.asarray(x), ee) ** 2).mean()

    out_j = jm.apply(params, jnp.asarray(x), jnp.asarray(e))
    gp_j, ge_j = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(e))
    tm = tconv.AVWGCN(f, 4, 2, d, topk=8, device="cpu").params_from_flax(
        jax.tree_util.tree_map(np.asarray, params))
    te = torch.from_numpy(e).requires_grad_()
    out_t = tm(torch.from_numpy(x), te)
    (out_t ** 2).mean().backward()

    jcols, _ = jconv._topk_support(jnp.asarray(e), 8)
    tcols, _ = tconv._topk_support(torch.from_numpy(e), 8)
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))
    assert_close_by_scale(out_t.detach().numpy(), out_j, "outputs")
    assert_close_by_scale(te.grad.numpy(), ge_j, "E")
    flat = _cells._flatten(jax.tree_util.tree_map(np.asarray, gp_j)["params"])
    for name, p in tm.named_parameters():
        assert_close_by_scale(p.grad.numpy(), flat[name], name)


@pytest.mark.parametrize("shape,k", [((7, 30), 7), ((3, 5, 40), 8),
                                     ((2, 7), 3), ((4, 100), 100),
                                     ((6, 9), 1), ((64, 2000), 8)])
def test_top_k_is_a_stable_descending_sort(shape, k):
    """The linear-time ``_top_k`` keeps exactly what a stable descending
    sort keeps, values and indices, on scores full of ties."""
    gen = torch.Generator().manual_seed(k)
    for levels in (2, 5, 1000):
        scores = torch.randint(-levels, levels + 1, shape,
                               generator=gen).float() / levels
        vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        got_vals, got_idx = tconv._top_k(scores, k)
        assert torch.equal(got_idx, idx[..., :k])
        assert torch.equal(got_vals, vals[..., :k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_ranks_special_values_as_jax(dtype):
    """NaNs, infinities and signed zeros: ``_top_k`` keeps jax.lax.top_k's
    values and indices (the float total order, +NaN above +inf, 0.0 above
    -0.0, -NaN below -inf; ties by lowest index)."""
    neg_nan = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    row = np.array([1.0, np.inf, np.nan, 2.0, np.inf, np.nan, neg_nan,
                    -0.0, 0.0, -np.inf, 0.0, -0.0, neg_nan, 2.0],
                   np.float32)
    rng = np.random.default_rng(4)
    scores = np.stack([row, rng.permutation(row), rng.permutation(row)])
    # the same bits on both sides (the packages' f32 -> bf16 casts give
    # NaNs of different signs); bf16 by truncation, exact for these values
    bits = scores.view(np.int32)
    if dtype == "bfloat16":
        bits = (bits >> 16).astype(np.int16)
    jx = jax.lax.bitcast_convert_type(jnp.asarray(bits), getattr(jnp, dtype))
    tx = torch.from_numpy(bits).view(getattr(torch, dtype))
    for k in (1, 3, 7, scores.shape[1]):
        j_vals, j_idx = jax.lax.top_k(jx, k)
        t_vals, t_idx = tconv._top_k(tx, k)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        # values by float equality (NaN equals NaN: torch's bf16 copies
        # may change a NaN's sign bit); signed zeros are told apart above
        np.testing.assert_array_equal(
            t_vals.float().numpy(), np.asarray(j_vals.astype(jnp.float32)))


def test_permutation_gradient_equals_indexing_bit_for_bit():
    """``bcsr_spmm``'s permutations (``_Permute``: a gather forward, the
    inverse gather backward) give indexing's values and gradients bit for
    bit, alone and around the reordered operator."""
    ei, w, sigma = pems_like()
    tg = TGraph.from_edge_index(sigma[ei], w, num_nodes=N, device="cpu")
    # the TPU v5e cost model keeps the RCM order here
    mat = tb.BCSRMatrix.from_graph(tg, reorder="auto", costs=tb.TPU_V5E)
    assert mat.perm is not None
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(N, 5)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(N, 5)).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 0, mat.fwd.num_cols - N))
    g = torch.from_numpy(rng.normal(size=tuple(xp.shape)).astype(np.float32))

    def value_and_grad(fn):
        a = xp.clone().requires_grad_()
        out = fn(a)
        return out.detach(), torch.autograd.grad(out, a, g)[0]

    for index, inverse in ((mat.perm, mat.iperm), (mat.iperm, mat.perm)):
        want = value_and_grad(lambda a: a[index])
        got = value_and_grad(lambda a: tb._Permute.apply(a, index, inverse))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def by_indexing(a):
        a = torch.nn.functional.pad(a, (0, 0, 0, mat.fwd.num_cols - N))
        return tb._BCSRSpmm.apply(a[mat.perm], mat)[mat.iperm][:N]

    xs = x.clone().requires_grad_()
    want = by_indexing(xs)
    (want_g,) = torch.autograd.grad(want, xs, cot)
    xs = x.clone().requires_grad_()
    got = tb.bcsr_spmm(mat, xs)
    (got_g,) = torch.autograd.grad(got, xs, cot)
    assert torch.equal(got, want) and torch.equal(got_g, want_g)
