"""Port parity of the attention family against the JAX package: the flax
layers under it (``Conv``, ``LayerNorm``, ``Embed``, ``BatchNorm``,
``Dropout``, the initializers), STConv, MSTGCN, ASTGCN (dense, edge mode,
per-step graphs), GMAN, MTGNN, AAGCN and DNNTSP, every exported class from
transplanted flax parameters.

Inputs are made with numpy from a seed and handed to both packages; the
flax module is initialized, its variables (every leaf moved by 0.05, so
zero biases and unit statistics show a missed transplant) go through
``params_from_flax``.  Tolerances (f32 on the CPU, JAX at "highest" matmul
precision): single layers 1e-5 absolute, whole models 1e-4 absolute,
running statistics 1e-5, parameter gradients of a scalar loss 1e-4
relative to each gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn

from pytorch_geometric_temporal_tpu import ops as jops
from pytorch_geometric_temporal_tpu.models import attention as jatt
from pytorch_geometric_temporal_tpu.models.attention import (
    astgcn as jastgcn, gman as jgman, mtgnn as jmtgnn)
from pytorch_geometric_temporal_tpu_torch import config_override
from pytorch_geometric_temporal_tpu_torch import ops as tops
from pytorch_geometric_temporal_tpu_torch.models import _cells
from pytorch_geometric_temporal_tpu_torch.models import attention as tatt
from pytorch_geometric_temporal_tpu_torch.models.attention import (
    astgcn as tastgcn, gman as tgman, mtgnn as tmtgnn)
from pytorch_geometric_temporal_tpu_torch.ops import bcsr as tbcsr

torch.set_num_threads(1)    # thousands of tiny ops: a thread pool only spins

N = 20
CPU = dict(device="cpu")
KEY = jax.random.PRNGKey(0)


def edges(seed=0, n=N, e=90, pad=0, loops=False):
    rng = np.random.default_rng(seed)
    ei = np.unique(rng.integers(0, n, size=(2, e)), axis=1)
    if not loops:
        ei = ei[:, ei[0] != ei[1]]
    w = rng.uniform(0.2, 1.5, ei.shape[1]).astype(np.float32)
    return ei, w, ei.shape[1] + pad


def graphs(seed=0, n=N, e=90, pad=0, loops=False):
    ei, w, pad_to = edges(seed, n, e, pad, loops)
    return (jops.Graph.from_edge_index(ei, w, num_nodes=n, pad_to=pad_to),
            tops.Graph.from_edge_index(ei, w, num_nodes=n, pad_to=pad_to,
                                       **CPU))


def arr(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a)


def shifted(variables):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05, variables)


def close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol, err_msg=msg)


def stats_close(tmodule, updates, tol=1e-5):
    """The module's buffers against flax's updated ``batch_stats``."""
    want = _cells._flatten(jax.tree_util.tree_map(
        np.asarray, updates["batch_stats"]))
    got = dict(tmodule.named_buffers())
    assert set(got) == set(want)
    for name, value in got.items():
        close(value, want[name], tol, name)


def grads_close(tmodule, tloss, jgrads, floor=1e-3):
    """Every parameter's gradient against flax's at the same path, within
    1e-4 of the flax gradient's largest entry (of ``floor`` for a smaller
    gradient)."""
    tloss.backward()
    flat = _cells._flatten(jax.tree_util.tree_map(np.asarray,
                                                  jgrads)["params"])
    got = dict(tmodule.named_parameters())
    assert set(got) == set(flat)
    for name, p in got.items():
        want = flat[name]
        got_grad = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(
            got_grad, want, rtol=0,
            atol=1e-4 * max(np.abs(want).max(), floor), err_msg=name)


def sq(out):
    return (out ** 2).sum()


def weighted(out):
    """A loss that a normalized output does not hold constant: Σ c·out with
    fixed seeded coefficients (Σ out² after a batch norm is nearly
    independent of the parameters, its gradient mere rounding)."""
    c = np.random.default_rng(99).normal(size=tuple(out.shape)).astype(
        np.float32)
    return (out * (t(c) if torch.is_tensor(out) else j(c))).sum()


def train_apply(jm, p, *args, **kw):
    return jm.apply(p, *args, train=True, mutable=["batch_stats"], **kw)


# -- the flax layers ----------------------------------------------------------

CONV_CASES = {
    "stride_pairs": dict(kernel_size=(1, 3), strides=(1, 2),
                         padding=((0, 0), (1, 1))),
    "valid": dict(kernel_size=(1, 3), padding="VALID"),
    "dilated": dict(kernel_size=(1, 3), kernel_dilation=(1, 2),
                    padding="VALID"),
    "same_1x1_stride": dict(kernel_size=(1, 1), strides=(1, 2)),
    "same_uneven": dict(kernel_size=(2, 4), strides=(1, 2)),
    "time_first": dict(kernel_size=(3, 1), strides=(2, 1),
                       padding=((1, 1), (0, 0))),
    "no_bias": dict(kernel_size=(1, 2), padding="VALID", use_bias=False),
    "one_d": dict(kernel_size=(5,), padding=((2, 2),)),
    "one_d_valid_stride": dict(kernel_size=(3,), strides=(2,),
                               padding="VALID"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_flax(case):
    kw = CONV_CASES[case]
    rng = np.random.default_rng(0)
    shape = (2, 5, 9, 3) if len(kw["kernel_size"]) == 2 else (2, 9, 3)
    x = arr(rng, *shape)
    jm = fnn.Conv(4, **kw)
    p = shifted(jm.init(KEY, j(x)))
    tm = _cells.Conv(3, 4, **kw, **CPU).params_from_flax(p)
    want = jm.apply(p, j(x))
    out = tm(t(x))
    assert out.shape == want.shape
    close(out, want)


def test_conv_rejects_wrong_rank():
    with pytest.raises(ValueError, match="expects"):
        _cells.Conv(3, 4, (1, 3), **CPU)(torch.zeros(2, 9, 3))
    with pytest.raises(ValueError, match="1 or 2 spatial"):
        _cells.Conv(3, 4, (1, 1, 1), **CPU)


def test_layer_norm_matches_flax():
    x = arr(np.random.default_rng(1), 3, 4, 6) * 1e-2   # eps must matter
    jm = fnn.LayerNorm()
    p = shifted(jm.init(KEY, j(x)))
    tm = _cells.LayerNorm(6, **CPU).params_from_flax(p)
    close(tm(t(x)), jm.apply(p, j(x)))
    assert tm.epsilon == 1e-6


def test_embed_matches_flax():
    idx = np.array([[0, 3], [2, 2]])
    jm = fnn.Embed(5, 4)
    p = shifted(jm.init(KEY, j(idx)))
    tm = _cells.Embed(5, 4, **CPU).params_from_flax(p)
    close(tm(t(idx)), jm.apply(p, j(idx)))


@pytest.mark.parametrize("axis,momentum", [(-1, 0.99), (2, 0.99), (2, 0.7),
                                           (1, 0.9)])
def test_batch_norm_matches_flax(axis, momentum):
    rng = np.random.default_rng(2)
    x1, x2 = arr(rng, 3, 4, 5, 6), arr(rng, 3, 4, 5, 6) * 2 + 1
    jm = fnn.BatchNorm(use_running_average=False, axis=axis,
                       momentum=momentum)
    p = shifted(jm.init(KEY, j(x1)))
    features = x1.shape[axis]
    tm = _cells.BatchNorm(features, axis=axis, momentum=momentum,
                          **CPU).params_from_flax(p)
    # eval from the transplanted running statistics
    je = fnn.BatchNorm(use_running_average=True, axis=axis,
                       momentum=momentum)
    close(tm(t(x1)), je.apply(p, j(x1)))
    # two training steps: outputs and running statistics
    for x in (x1, x2):
        want, upd = jm.apply(p, j(x), mutable=["batch_stats"])
        close(tm(t(x), train=True), want)
        p = {"params": p["params"], "batch_stats": upd["batch_stats"]}
        stats_close(tm, upd)
    close(tm(t(x1)), je.apply(p, j(x1)))


def test_batch_norm_scale_init():
    x = arr(np.random.default_rng(3), 4, 5)
    jm = fnn.BatchNorm(use_running_average=True,
                       scale_init=fnn.initializers.constant(1e-6))
    p = jax.tree_util.tree_map(np.asarray, jm.init(KEY, j(x)))
    tm = _cells.BatchNorm(5, scale_init=1e-6, **CPU)
    close(tm.scale, p["params"]["scale"], 0)
    close(tm(t(x)), jm.apply(p, j(x)))


def test_dropout():
    x = torch.ones(200, 50)
    drop = _cells.Dropout(0.25)
    assert drop(x) is x and drop(x, train=False) is x
    assert _cells.Dropout(0.0)(x, train=True) is x
    a = drop(x, True, torch.Generator().manual_seed(5))
    b = drop(x, True, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    close(a[kept], np.full(int(kept.sum()), 1 / 0.75, np.float32))
    assert float(_cells.Dropout(1.0)(x, True).abs().max()) == 0.0


@pytest.mark.parametrize("name,shape,lo,hi,mean,std", [
    ("uniform", (400, 50), 0.0, 1.0, 0.5, 12 ** -0.5),
    ("kaiming_normal", (3, 1, 40, 100), None, None, 0.0, (2 / 120) ** 0.5),
    ("xavier_normal", (5, 30, 60), None, None, 0.0, (2 / 450) ** 0.5),
    ("lecun_normal", (1, 3, 50, 80), None, None, 0.0, (1 / 150) ** 0.5),
    ("glorot", (1, 3, 50, 80), -(6 / 390) ** 0.5, (6 / 390) ** 0.5, 0.0,
     (2 / 390) ** 0.5),
    ("embed_normal", (300, 40), None, None, 0.0, 40 ** -0.5),
])
def test_initializer_distributions(name, shape, lo, hi, mean, std):
    """Each initializer's moments against flax's distribution (a conv
    kernel's receptive field counts into the fans)."""
    flax_init = {
        "uniform": fnn.initializers.uniform(scale=1.0),
        "kaiming_normal": fnn.initializers.kaiming_normal(),
        "xavier_normal": fnn.initializers.xavier_normal(),
        "lecun_normal": fnn.initializers.lecun_normal(),
        "glorot": fnn.initializers.glorot_uniform(),
        "embed_normal": fnn.linear.default_embed_init,
    }[name]
    want = np.asarray(flax_init(KEY, shape))
    got = getattr(_cells, name)(shape, torch.Generator().manual_seed(0),
                                "cpu").numpy()
    assert got.shape == want.shape
    for a in (got, want):
        assert abs(a.mean() - mean) < 0.05 * std + 1e-3
        assert abs(a.std() - std) < 0.05 * std
        if lo is not None:
            assert lo <= a.min() and a.max() < hi + 1e-7


# -- STGCN --------------------------------------------------------------------

def test_temporal_conv_matches_jax():
    x = arr(np.random.default_rng(0), 2, 7, N, 3)
    jm = jatt.TemporalConv(5, 3)
    p = shifted(jm.init(KEY, j(x)))
    tm = tatt.TemporalConv(3, 5, 3, **CPU).params_from_flax(p)
    out = tm(t(x))
    assert out.shape == (2, 5, N, 5)
    close(out, jm.apply(p, j(x)))


def stconv_pair(K=3, lam=None, seed=1):
    jg, tg = graphs(seed=seed, pad=4, loops=True)
    x = arr(np.random.default_rng(seed), 2, 8, N, 3)
    jm = jatt.STConv(num_nodes=N, hidden_channels=6, out_channels=5,
                     kernel_size=3, K=K)
    p = shifted(jm.init(KEY, j(x), jg, lam))
    tm = tatt.STConv(N, 3, 6, 5, 3, K, **CPU).params_from_flax(p)
    return jm, tm, p, x, jg, tg


@pytest.mark.parametrize("K,lam", [(3, None), (2, 1.6), (1, None)])
def test_stconv_eval_matches_jax(K, lam):
    jm, tm, p, x, jg, tg = stconv_pair(K, lam)
    out = tm(t(x), tg, lam)
    assert out.shape == (2, 4, N, 5)
    close(out, jm.apply(p, j(x), jg, lam), 1e-4)


def test_stconv_train_matches_jax_with_batch_stats():
    jm, tm, p, x, jg, tg = stconv_pair()
    want, upd = train_apply(jm, p, j(x), jg)
    close(tm(t(x), tg, train=True), want, 1e-4)
    stats_close(tm, upd)
    assert tm.batch_norm.mean.shape == (N,)      # statistics per node


def test_stconv_gradients_match_jax():
    jm, tm, p, x, jg, tg = stconv_pair()
    grads_close(tm, weighted(tm(t(x), tg, train=True)), jax.grad(
        lambda q: weighted(train_apply(jm, q, j(x), jg)[0]))(p))


def test_stconv_takes_prepared_and_prenormalized_graphs():
    _, tm, _, x, _, tg = stconv_pair()
    want = tm(t(x), tg)
    prepared = tops.prepare_graph(tg, kinds=("cheb",), bcsr=False, **CPU)
    close(tm(t(x), prepared), want.detach(), 1e-5)
    pre = tops.prenormalize_cheb(tg, "sym", **CPU)
    close(tm(t(x), pre), want.detach(), 1e-5)


def test_stconv_errors():
    _, tm, _, x, _, tg = stconv_pair()
    with pytest.raises(ValueError, match=r"STConv expects input \(B, T, N, C"):
        tm(t(x)[0], tg)
    with pytest.raises(ValueError, match="STConv expects input laid out"):
        tm(t(x).transpose(1, 2), tg)


# -- MSTGCN -------------------------------------------------------------------

MST = dict(nb_block=2, in_channels=3, K=3, nb_chev_filter=6, nb_time_filter=5,
           time_strides=2, num_for_predict=4, len_input=8)


def test_mstgcn_block_matches_jax():
    jg, tg = graphs(seed=2, pad=3)
    x = arr(np.random.default_rng(2), 2, N, 3, 8)
    jm = jatt.MSTGCNBlock(3, 3, 6, 5, 2)
    p = shifted(jm.init(KEY, j(x), jg))
    tm = tatt.MSTGCNBlock(3, 3, 6, 5, 2, **CPU).params_from_flax(p)
    out = tm(t(x), tg)
    assert out.shape == (2, N, 5, 4)
    close(out, jm.apply(p, j(x), jg))


@pytest.mark.parametrize("per_step", [False, True])
def test_mstgcn_matches_jax(per_step):
    """Held against the JAX package (same start vector, same 64 power
    iterations for λ_max), with a static graph and a graph per step."""
    x = arr(np.random.default_rng(3), 2, N, 3, 8)
    if per_step:
        pairs = [graphs(seed=10 + s, pad=2) for s in range(8)]
        jg, tg = [a for a, _ in pairs], [b for _, b in pairs]
    else:
        jg, tg = graphs(seed=3)
    cfg = dict(MST, time_strides=1) if per_step else MST
    jm = jatt.MSTGCN(**cfg)
    p = shifted(jm.init(KEY, j(x), jg))
    tm = tatt.MSTGCN(**cfg, **CPU).params_from_flax(p)
    out = tm(t(x), tg)
    assert out.shape == (2, N, 4)
    close(out, jm.apply(p, j(x), jg), 1e-4)


def test_mstgcn_errors():
    _, tg = graphs(seed=3)
    tm = tatt.MSTGCN(**MST, **CPU)
    x = torch.zeros(2, N, 3, 8)
    with pytest.raises(ValueError, match=r"MSTGCN expects input \(B, N"):
        tm(x[0], tg)
    with pytest.raises(ValueError, match="MSTGCN expects input laid out"):
        tm(x.transpose(1, 2), tg)
    with pytest.raises(ValueError, match="MSTGCN expects T_in == len_input"):
        tm(x[..., :7], tg)


# -- ASTGCN -------------------------------------------------------------------

def softmax_s(rng, b=2, n=N):
    s = rng.normal(size=(b, n, n)).astype(np.float32)
    e = np.exp(s - s.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("normalization", ["sym", None, "rw"])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_chebconv_attention_dense_and_edge_match_jax(normalization, K):
    """Dense and edge mode given the same S: equal to each other and to the
    JAX package's."""
    jg, tg = graphs(seed=4, pad=5, loops=True)
    rng = np.random.default_rng(4)
    x, s = arr(rng, 2, 4, N, 3), softmax_s(rng)
    jm = jatt.ChebConvAttention(5, K, normalization, mode="dense")
    p = shifted(jm.init(KEY, j(x), jg, j(s)))
    want = jm.apply(p, j(x), jg, j(s))
    outs = {}
    for mode in ("dense", "edge"):
        tm = tatt.ChebConvAttention(3, 5, K, normalization, mode=mode,
                                    **CPU).params_from_flax(p)
        outs[mode] = tm(t(x), tg, t(s))
        close(outs[mode], want, 2e-5, mode)
    close(outs["edge"], outs["dense"].detach(), 2e-5)
    # a (B, N, F) input is one time step
    close(tm(t(x)[:, 0], tg, t(s)), want[:, 0], 2e-5)


def test_chebconv_attention_edge_scores_and_auto_mode():
    jg, tg = graphs(seed=5, pad=3)
    rng = np.random.default_rng(5)
    x, s_full = arr(rng, 2, 3, N, 3), softmax_s(rng)
    e_scores = s_full[:, np.asarray(jg.senders), np.asarray(jg.receivers)]
    e_scores = e_scores * np.asarray(jg.edge_mask())
    d_scores = np.einsum("bii->bi", s_full)
    jm = jatt.ChebConvAttention(5, 3)
    js = jatt.EdgeScores(edge=j(e_scores), diag=j(d_scores))
    p = shifted(jm.init(KEY, j(x), jg, js))
    tm = tatt.ChebConvAttention(3, 5, 3, **CPU).params_from_flax(p)
    ts = tatt.EdgeScores(edge=t(e_scores), diag=t(d_scores))
    close(tm(t(x), tg, ts), jm.apply(p, j(x), jg, js), 2e-5)
    # auto: dense below the threshold, edge above it
    with config_override(dense_threshold=N - 1):
        edge = tm(t(x), tg, t(s_full))
    close(edge, tm(t(x), tg, t(s_full)).detach(), 2e-5)
    # EdgeScores outside edge mode, as in the JAX package
    for mod, g, sc in ((tm, [tg] * 3, ts), (jm, [jg] * 3, js)):
        with pytest.raises(ValueError, match="EdgeScores attention requires"):
            mod(t(x), g, sc) if mod is tm else mod.apply(p, j(x), g, sc)
    dense = tatt.ChebConvAttention(3, 5, 3, mode="dense", **CPU)
    with pytest.raises(ValueError, match="EdgeScores attention requires"):
        dense(t(x), tg, ts)


def test_chebconv_attention_per_step_graphs_match_jax():
    pairs = [graphs(seed=20 + s, pad=2) for s in range(4)]
    jg, tg = [a for a, _ in pairs], [b for _, b in pairs]
    rng = np.random.default_rng(6)
    x, s = arr(rng, 2, 4, N, 3), softmax_s(rng)
    jm = jatt.ChebConvAttention(5, 3, None)
    p = shifted(jm.init(KEY, j(x), jg, j(s)))
    tm = tatt.ChebConvAttention(3, 5, 3, None, **CPU).params_from_flax(p)
    close(tm(t(x), tg, t(s)), jm.apply(p, j(x), jg, j(s)), 2e-5)


def test_lhat_dense_guard():
    big = tops.Graph.from_edge_index(np.array([[0], [1]]), num_nodes=8193,
                                     **CPU)
    with pytest.raises(ValueError, match="N=8193 is past any sensible dense"):
        tastgcn._lhat_dense(big, "sym")
    jbig = jops.Graph.from_edge_index(np.array([[0], [1]]), num_nodes=8193)
    with pytest.raises(ValueError, match="N=8193 is past any sensible dense"):
        jastgcn._lhat_dense(jbig, "sym")
    conv = tatt.ChebConvAttention(1, 1, 2, mode="dense", **CPU)
    s = torch.zeros(1, 1, 1).expand(1, 8193, 8193)
    with pytest.raises(ValueError, match="attention_mode='edge'"):
        conv(torch.zeros(1, 1, 8193, 1), big, s)


@pytest.mark.parametrize("name", ["SpatialAttention", "TemporalAttention"])
def test_astgcn_attentions_match_jax(name):
    x = arr(np.random.default_rng(7), 2, N, 3, 6)
    jm = getattr(jatt, name)(3, N, 6)
    p = shifted(jm.init(KEY, j(x)))
    tm = getattr(tatt, name)(3, N, 6, **CPU).params_from_flax(p)
    out = tm(t(x))
    assert out.shape == ((2, N, N) if name == "SpatialAttention"
                         else (2, 6, 6))
    close(out, jm.apply(p, j(x)))


def test_spatial_attention_sparse_matches_jax_on_a_padded_graph():
    jg, tg = graphs(seed=8, pad=7, loops=True)
    x = arr(np.random.default_rng(8), 2, N, 3, 6)
    jm = jatt.SpatialAttentionSparse(3, 6)
    p = shifted(jm.init(KEY, j(x), jg))
    tm = tatt.SpatialAttentionSparse(3, 6, **CPU).params_from_flax(p)
    got, want = tm(t(x), tg), jm.apply(p, j(x), jg)
    assert isinstance(got, tatt.EdgeScores)
    close(got.edge, want.edge)
    close(got.diag, want.diag)
    # each column's incident mass (edges into j + the diagonal) sums to 1
    col = got.diag.detach().clone().index_add_(
        1, tg.receivers, got.edge.detach() * tg.edge_mask())
    close(col, np.ones((2, N), np.float32))
    assert float(got.edge.detach()[:, tg.num_edges:].abs().max()) == 0.0
    # a PreparedGraph stands for its graph
    prepared = tops.prepare_graph(tg, kinds=("cheb",), bcsr=False, **CPU)
    close(tm(t(x), prepared).edge, want.edge)


@pytest.mark.parametrize("mode", ["dense", "edge"])
def test_astgcn_block_matches_jax(mode):
    jg, tg = graphs(seed=9, pad=2)
    x = arr(np.random.default_rng(9), 2, N, 3, 6)
    jm = jatt.ASTGCNBlock(3, 3, 6, 5, 2, N, 6, "sym", attention_mode=mode)
    p = shifted(jm.init(KEY, j(x), jg))
    tm = tatt.ASTGCNBlock(3, 3, 6, 5, 2, N, 6, "sym", attention_mode=mode,
                          **CPU).params_from_flax(p)
    out = tm(t(x), tg)
    assert out.shape == (2, N, 5, 3)
    close(out, jm.apply(p, j(x), jg), 2e-5)


@pytest.mark.parametrize("mode", ["dense", "edge"])
def test_astgcn_block_with_the_fused_tail_matches_jax(mode):
    """Stride 1 and 8 time filters: the tail runs fused (``_BlockTail``),
    against flax's Conv and LayerNorm in the JAX block; the stride-2 block
    above keeps the flax modules' formulation."""
    jg, tg = graphs(seed=9, pad=2)
    x = arr(np.random.default_rng(9), 2, N, 3, 6)
    jm = jatt.ASTGCNBlock(3, 3, 6, 8, 1, N, 6, "sym", attention_mode=mode)
    p = shifted(jm.init(KEY, j(x), jg))
    tm = tatt.ASTGCNBlock(3, 3, 6, 8, 1, N, 6, "sym", attention_mode=mode,
                          **CPU).params_from_flax(p)
    assert tm.fused_tail
    assert not tatt.ASTGCNBlock(3, 3, 6, 8, 2, N, 6, "sym",
                                attention_mode=mode, **CPU).fused_tail
    out = tm(t(x), tg)
    assert out.shape == (2, N, 8, 6)
    close(out, jm.apply(p, j(x), jg), 2e-5)


@pytest.mark.parametrize("mode", ["dense", "edge"])
def test_astgcn_with_fused_tails_matches_jax(mode):
    """Both blocks at stride 1 with 8 time filters (fused tails): output
    and every parameter gradient against the JAX model."""
    jm, tm, p, x, jg, tg = astgcn_pair(attention_mode=mode,
                                       normalization="sym", time_strides=1,
                                       nb_time_filter=8)
    assert tm.block_0.fused_tail and tm.block_1.fused_tail
    close(tm(t(x), tg), jm.apply(p, j(x), jg), 1e-4)
    grads_close(tm, sq(tm(t(x), tg)), jax.grad(
        lambda q: sq(jm.apply(q, j(x), jg)))(p))


AST = dict(nb_block=2, in_channels=3, K=3, nb_chev_filter=6, nb_time_filter=5,
           time_strides=2, num_for_predict=4, len_input=8, num_of_vertices=N)


def astgcn_pair(seed=11, per_step=False, **kw):
    cfg = dict(AST, **kw)
    if per_step:
        pairs = [graphs(seed=30 + s, pad=2) for s in range(8)]
        jg, tg = [a for a, _ in pairs], [b for _, b in pairs]
        cfg["time_strides"] = 1
    else:
        jg, tg = graphs(seed=seed, pad=3)
    x = arr(np.random.default_rng(seed), 2, N, 3, 8)
    jm = jatt.ASTGCN(**cfg)
    p = shifted(jm.init(KEY, j(x), jg))
    tm = tatt.ASTGCN(**cfg, **CPU).params_from_flax(p)
    return jm, tm, p, x, jg, tg


@pytest.mark.parametrize("mode,normalization", [
    ("dense", None), ("dense", "sym"), ("edge", "sym"), ("edge", None),
    ("auto", "rw")])
def test_astgcn_matches_jax(mode, normalization):
    jm, tm, p, x, jg, tg = astgcn_pair(attention_mode=mode,
                                       normalization=normalization)
    out = tm(t(x), tg)
    assert out.shape == (2, N, 4)
    close(out, jm.apply(p, j(x), jg), 1e-4)


def test_astgcn_per_step_graphs_match_jax():
    jm, tm, p, x, jg, tg = astgcn_pair(per_step=True)
    close(tm(t(x), tg), jm.apply(p, j(x), jg), 1e-4)


def test_astgcn_auto_mode_follows_the_dense_threshold():
    with config_override(dense_threshold=N - 1):
        tm = tatt.ASTGCN(**AST, **CPU)
    assert isinstance(tm.block_0.spatial_attention,
                      tatt.SpatialAttentionSparse)
    assert isinstance(tatt.ASTGCN(**AST, **CPU).block_0.spatial_attention,
                      tatt.SpatialAttention)


@pytest.mark.parametrize("mode", ["dense", "edge"])
def test_astgcn_gradients_match_jax(mode):
    jm, tm, p, x, jg, tg = astgcn_pair(attention_mode=mode,
                                       normalization="sym")
    grads_close(tm, sq(tm(t(x), tg)), jax.grad(
        lambda q: sq(jm.apply(q, j(x), jg)))(p))


def test_astgcn_errors():
    _, tm, _, x, _, tg = astgcn_pair()
    with pytest.raises(ValueError, match=r"ASTGCN expects input \(B, N"):
        tm(t(x)[0], tg)
    with pytest.raises(ValueError, match="ASTGCN expects input laid out"):
        tm(t(x).transpose(1, 2), tg)
    with pytest.raises(ValueError, match="ASTGCN expects T_in == len_input"):
        tm(t(x)[..., :7], tg)


# -- the build-count rule -------------------------------------------------------

class Counting:
    """Counts calls of ``owner.name`` while active."""

    def __init__(self, monkeypatch, owner, name):
        self.calls = 0
        inner = getattr(owner, name)

        def counted(*a, **kw):
            self.calls += 1
            return inner(*a, **kw)

        if isinstance(owner.__dict__.get(name), staticmethod):
            counted = staticmethod(counted)
        monkeypatch.setattr(owner, name, counted)


def test_forward_builds_an_operator_once_per_graph(monkeypatch):
    """With the BCSR backend forced (plain versions on CPU tensors): two
    forwards of edge-mode ASTGCN("sym", K=3) tile the reversed L̂ once and
    aggregate through ``hybrid_spmm`` once per block per forward;
    ASTGCN(None) and MSTGCN, whose λ_max comes from power iteration, never
    build an operator and never reach ``hybrid_spmm``."""
    builds = Counting(monkeypatch, tbcsr.BCSRMatrix, "from_graph")
    hops = Counting(monkeypatch, tbcsr, "hybrid_spmm")
    _, tg = graphs(seed=12, n=300, e=1500)
    x = torch.randn(2, 300, 3, 8, generator=torch.Generator().manual_seed(0))
    cfg = dict(AST, num_of_vertices=300, attention_mode="edge")
    gen = torch.Generator().manual_seed(1)
    sym = tatt.ASTGCN(**cfg, normalization="sym", **CPU, generator=gen)
    with config_override(spmm_backend="segment"):
        want = sym(x, tg)
    with config_override(spmm_backend="bcsr"):
        first = sym(x, tg)
        assert (builds.calls, hops.calls) == (1, 2)
        sym(x, tg)
        assert (builds.calls, hops.calls) == (1, 4)
        sq(sym(x, tg)).backward()        # one more per block, transposed
        assert (builds.calls, hops.calls) == (1, 8)
        close(first, want.detach(), 1e-4)
        plain = tatt.ASTGCN(**cfg, normalization=None, **CPU, generator=gen)
        plain(x, tg)
        tatt.MSTGCN(**MST, **CPU, generator=gen)(x, tg)
        assert (builds.calls, hops.calls) == (1, 8)
    lhat = tastgcn._lhat_graph(tg, "sym")
    assert tastgcn._lhat_graph(tg, "sym") is lhat
    assert tastgcn._reversed(lhat) is tastgcn._reversed(lhat)
    assert not lhat.transient
    assert tastgcn._lhat_graph(tg, None).transient
    assert tastgcn._reversed(tastgcn._lhat_graph(tg, None)).transient


def test_transient_graphs_take_the_segment_path():
    _, tg = graphs(seed=13)
    lam = tops.lambda_max(tg, None)
    lhat = tops.cheb_norm(tg, None, lam)
    assert lhat.transient and not tops.cheb_norm(tg, None, 2.0).transient
    assert tops.cheb_norm(tg, None, 2.0) is tops.cheb_norm(tg, None, 2.0)
    x = torch.randn(N, 4, generator=torch.Generator().manual_seed(0))
    with config_override(spmm_backend="bcsr"):
        got = tops.spmm(lhat, x)
    assert "_op_cache" not in vars(lhat)
    close(got, tops.spmm_segment(lhat, x).numpy(), 0)


# -- GMAN ---------------------------------------------------------------------

GK, GD, HIS, PRED = 2, 3, 4, 3


def gman_inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    x = arr(rng, b, HIS, N)
    se = arr(rng, N, GK * GD)
    te = np.stack([rng.integers(0, 7, (b, HIS + PRED)),
                   rng.integers(0, 24, (b, HIS + PRED))], -1).astype(np.int32)
    return x, se, te


@pytest.mark.parametrize("train", [False, True])
def test_gman_fully_connected_matches_jax(train):
    x = arr(np.random.default_rng(1), 2, 3, N, 4)
    jm = jatt.FullyConnected([6, 5], [fnn.relu, None], bn_decay=0.3)
    p = shifted(jm.init(KEY, j(x)))
    tm = tatt.FullyConnected(4, [6, 5], [torch.relu, None], 0.3,
                             **CPU).params_from_flax(p)
    if train:
        want, upd = train_apply(jm, p, j(x))
        out = tm(t(x), True)
        close(out, want)
        stats_close(tm, upd)
        # a bias under a batch norm has an exactly zero gradient: both
        # packages compute rounding (~1e-5) for it, held to 1e-4 absolute
        grads_close(tm, weighted(out), jax.grad(
            lambda q: weighted(train_apply(jm, q, j(x))[0]))(p), floor=1.0)
    else:
        close(tm(t(x)), jm.apply(p, j(x)))
    assert tatt.FullyConnected(4, [6], [None], **CPU).bn_0.momentum == 0.9


def test_gman_embedding_matches_jax():
    _, se, te = gman_inputs(2)
    jm = jatt.SpatioTemporalEmbedding(GK * GD, 0.1, 24)
    p = shifted(jm.init(KEY, j(se), j(te)))
    tm = tatt.SpatioTemporalEmbedding(GK * GD, 0.1, 24,
                                      **CPU).params_from_flax(p)
    out = tm(t(se), t(te))
    assert out.shape == (2, HIS + PRED, N, GK * GD)
    close(out, jm.apply(p, j(se), j(te)))
    want, upd = train_apply(jm, p, j(se), j(te))
    close(tm(t(se), t(te), True), want)
    stats_close(tm, upd)


@pytest.mark.parametrize("name,args", [
    ("SpatialAttention", (GK, GD, 0.1)),
    ("TemporalAttention", (GK, GD, 0.1, True)),
    ("TemporalAttention", (GK, GD, 0.1, False)),
    ("SpatioTemporalAttention", (GK, GD, 0.1, True)),
])
def test_gman_attention_blocks_match_jax(name, args):
    rng = np.random.default_rng(3)
    x, ste = arr(rng, 2, HIS, N, GK * GD), arr(rng, 2, HIS, N, GK * GD)
    jm = getattr(jgman, name)(*args)
    p = shifted(jm.init(KEY, j(x), j(ste)))
    tm = getattr(tgman, name)(*args, **CPU).params_from_flax(p)
    close(tm(t(x), t(ste)), jm.apply(p, j(x), j(ste)), 2e-5)
    want, upd = train_apply(jm, p, j(x), j(ste))
    close(tm(t(x), t(ste), True), want, 2e-5)
    stats_close(tm, upd)


def test_gman_head_quirk_and_causal_fill():
    """Chunks of size K (d heads), scale √d; the mask fills −2¹⁵+1."""
    x = torch.arange(12.0).reshape(1, 12)
    assert tgman._heads(x, 3).shape == (1, 4, 3)
    assert torch.equal(tgman._merge(tgman._heads(x, 3)), x)
    rng = np.random.default_rng(4)
    xs, ste = arr(rng, 1, HIS, 2, GK * GD), arr(rng, 1, HIS, 2, GK * GD)
    masked = tgman.TemporalAttention(GK, GD, 0.1, True, **CPU)
    free = tgman.TemporalAttention(GK, GD, 0.1, False, **CPU)
    free.load_state_dict(masked.state_dict())
    later = xs.copy()
    later[:, 1:] += 1.0                  # the future of step 0 changes
    a, b = masked(t(xs), t(ste)), masked(t(later), t(ste))
    close(a[:, 0], b[:, 0].detach().numpy(), 1e-6)
    c, d = free(t(xs), t(ste)), free(t(later), t(ste))
    assert float((c[:, 0] - d[:, 0]).detach().abs().max()) > 1e-4


def test_gman_gated_fusion_and_transform_match_jax():
    rng = np.random.default_rng(5)
    D = GK * GD
    hs, ht = arr(rng, 2, HIS, N, D), arr(rng, 2, HIS, N, D)
    jm = jatt.GatedFusion(D, 0.1)
    p = shifted(jm.init(KEY, j(hs), j(ht)))
    tm = tatt.GatedFusion(D, 0.1, **CPU).params_from_flax(p)
    close(tm(t(hs), t(ht)), jm.apply(p, j(hs), j(ht)))
    assert tm.fc_xs.dense_0.bias is None
    sp = arr(rng, 2, PRED, N, D)
    jm = jatt.TransformAttention(GK, GD, 0.1)
    p = shifted(jm.init(KEY, j(hs), j(ht), j(sp)))
    tm = tatt.TransformAttention(GK, GD, 0.1, **CPU).params_from_flax(p)
    out = tm(t(hs), t(ht), t(sp))
    assert out.shape == (2, PRED, N, D)
    close(out, jm.apply(p, j(hs), j(ht), j(sp)), 2e-5)


def gman_pair(L=2):
    x, se, te = gman_inputs(6)
    jm = jatt.GMAN(L=L, K=GK, d=GD, num_his=HIS, bn_decay=0.1,
                   steps_per_day=24)
    p = shifted(jm.init(KEY, j(x), j(se), j(te)))
    tm = tatt.GMAN(L, GK, GD, HIS, 0.1, 24, **CPU).params_from_flax(p)
    return jm, tm, p, x, se, te


def test_gman_eval_matches_jax():
    jm, tm, p, x, se, te = gman_pair()
    out = tm(t(x), t(se), t(te))
    assert out.shape == (2, PRED, N)
    close(out, jm.apply(p, j(x), j(se), j(te)), 1e-4)


def test_gman_train_matches_jax_with_batch_stats():
    jm, tm, p, x, se, te = gman_pair()
    want, upd = train_apply(jm, p, j(x), j(se), j(te))
    close(tm(t(x), t(se), t(te), True), want, 1e-4)
    stats_close(tm, upd)


def test_gman_gradients_match_jax():
    """In eval mode: under batch statistics ``fc_in``'s first layer (one
    input feature, then a batch norm) has an exactly zero gradient, and
    rounding is all either package computes for it.  The gradient through
    the batch statistics is held in ``test_gman_fully_connected``."""
    jm, tm, p, x, se, te = gman_pair(L=1)
    grads_close(tm, sq(tm(t(x), t(se), t(te))), jax.grad(
        lambda q: sq(jm.apply(q, j(x), j(se), j(te))))(p))


def test_gman_errors():
    jm, tm, p, x, se, te = gman_pair(L=1)
    bad = [
        ((x[:, :3], se, te), "GMAN expects X"),
        ((x[:, :, 0], se, te), "GMAN expects X"),
        ((x, se[:, :5], te), "GMAN expects SE"),
        ((x, se[:5], te), "GMAN expects SE"),
        ((x, se, te[:, :HIS]), "GMAN expects TE"),
        ((x, se, te[..., :1]), "GMAN expects TE"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            tm(*map(t, args))
        with pytest.raises(ValueError, match=match):
            jm.apply(p, *map(j, args))


# -- MTGNN --------------------------------------------------------------------

def test_mixprop_and_dilated_inception_match_jax():
    rng = np.random.default_rng(0)
    x, a = arr(rng, 2, N, 6, 4), np.abs(arr(rng, N, N))
    jm = jatt.MixProp(5, 2, 0.3, 0.05)
    p = shifted(jm.init(KEY, j(x), j(a)))
    tm = tatt.MixProp(4, 5, 2, 0.3, 0.05, **CPU).params_from_flax(p)
    close(tm(t(x), t(a)), jm.apply(p, j(x), j(a)))
    x = arr(rng, 2, N, 19, 4)
    jm = jatt.DilatedInception(8, [2, 3, 6, 7], 2)
    p = shifted(jm.init(KEY, j(x)))
    tm = tatt.DilatedInception(4, 8, [2, 3, 6, 7], 2,
                               **CPU).params_from_flax(p)
    out = tm(t(x))
    assert out.shape == (2, N, 7, 8)
    close(out, jm.apply(p, j(x)))


@pytest.mark.parametrize("xd", [None, 5])
def test_graph_constructor_matches_jax(xd):
    rng = np.random.default_rng(1)
    idx = rng.permutation(N)[:14]
    fe = None if xd is None else arr(rng, N, xd)
    jm = jatt.GraphConstructor(N, 4, 6, 3.0, xd)
    jfe = None if fe is None else j(fe)
    p = shifted(jm.init(KEY, j(idx), jfe))
    tm = tatt.GraphConstructor(N, 4, 6, 3.0, xd, **CPU).params_from_flax(p)
    out = tm(t(idx), None if fe is None else t(fe))
    assert out.shape == (14, 14)
    assert int((out != 0).sum(1).max()) <= 4
    close(out, jm.apply(p, j(idx), jfe))
    assert (xd is None) == hasattr(tm, "embedding1")


def test_graph_constructor_keeps_the_lowest_index_among_tied_scores():
    """relu(tanh(·)) leaves whole rows of exact zeros; both packages keep
    the lowest indices of a tie, so the masks agree entry for entry."""
    jm = jatt.GraphConstructor(N, 3, 2, 1.0)
    idx = np.arange(N)
    p = jax.tree_util.tree_map(np.asarray, jm.init(KEY, j(idx)))
    # equal embeddings: M1 M2ᵀ − M2 M1ᵀ = 0 everywhere, every score ties
    p["params"]["embedding2"] = p["params"]["embedding1"].copy()
    for lin in ("linear1", "linear2"):
        p["params"][lin] = jax.tree_util.tree_map(
            np.copy, p["params"]["linear1"])
    tm = tatt.GraphConstructor(N, 3, 2, 1.0, **CPU).params_from_flax(p)
    want = np.asarray(jm.apply(p, j(idx)))
    assert np.abs(want).max() == 0.0
    close(tm(t(idx)), want, 0)
    # the mask itself: a constant score row keeps columns 0..k-1
    _, top = tmtgnn._top_k(torch.zeros(2, 7), 3)
    assert top.tolist() == [[0, 1, 2]] * 2
    assert np.asarray(jax.lax.top_k(jnp.zeros((2, 7)), 3)[1]).tolist() == \
        top.tolist()


def test_graph_constructor_guard():
    idx = np.arange(8200)
    tm = tatt.GraphConstructor(8200, 2, 2, 1.0, **CPU)
    with pytest.raises(ValueError, match="N=8200 would allocate"):
        tm(t(idx))
    jm = jatt.GraphConstructor(8200, 2, 2, 1.0)
    with pytest.raises(ValueError, match="N=8200 would allocate"):
        jm.init(KEY, j(idx))


def test_node_indexed_layer_norm_uses_the_biased_variance():
    rng = np.random.default_rng(2)
    x, idx = arr(rng, 2, 5, 3, 4), np.array([4, 0, 2, 6, 1])
    jm = jmtgnn.NodeIndexedLayerNorm((7, 3, 4))
    p = shifted(jm.init(KEY, j(x), j(idx)))
    tm = tmtgnn.NodeIndexedLayerNorm((7, 3, 4), **CPU).params_from_flax(p)
    close(tm(t(x), t(idx)), jm.apply(p, j(x), j(idx)))
    plain = tmtgnn.NodeIndexedLayerNorm((7, 3, 4), False, **CPU)
    assert not list(plain.parameters())
    got = plain(t(x), t(idx)).numpy()
    np.testing.assert_allclose(got.reshape(2, -1).var(1), 1.0, atol=1e-3)


MT = dict(gcn_true=True, build_adj=True, gcn_depth=2, num_nodes=N,
          kernel_set=[2, 3, 6, 7], kernel_size=7, dropout=0.0,
          subgraph_size=5, node_dim=6, dilation_exponential=2,
          conv_channels=8, residual_channels=8, skip_channels=6,
          end_channels=10, seq_length=10, in_dim=2, out_dim=3, layers=2,
          propalpha=0.05, tanhalpha=3.0, layer_norm_affline=True)


def test_mtgnn_layer_matches_jax():
    rng = np.random.default_rng(3)
    rf = tmtgnn._rf_size(7, 2, 2)
    assert rf == 19
    x, skip = arr(rng, 2, N, rf, 8), arr(rng, 2, N, 1, 6)
    a, idx = np.abs(arr(rng, N, N)), np.arange(N)
    args = (2, 1, 7, 1, 8, 8, 6, [2, 3, 6, 7], 1, True, True, 10, rf, 0.0, 2,
            N, 0.05)
    jm = jatt.MTGNNLayer(*args)
    p = shifted(jm.init(KEY, j(x), j(skip), j(a), j(idx)))
    tm = tatt.MTGNNLayer(*args, **CPU).params_from_flax(p)
    got = tm(t(x), t(skip), t(a), t(idx))
    want = jm.apply(p, j(x), j(skip), j(a), j(idx))
    assert got[0].shape == (2, N, rf - 6, 8)
    close(got[0], want[0], 2e-5)
    close(got[1], want[1], 2e-5)


@pytest.mark.parametrize("case", ["built", "idx", "fe", "fixed", "no_gcn",
                                  "long_seq", "linear_dilation"])
@pytest.mark.parametrize("train", [False, True])
def test_mtgnn_matches_jax(case, train):
    rng = np.random.default_rng(4)
    cfg, n_in = dict(MT), N
    a = idx = fe = None
    if case == "idx":       # subgraph training: a permuted node subset
        idx, n_in = rng.permutation(N), N
    elif case == "fe":
        cfg["xd"], fe = 4, arr(rng, N, 4)
    elif case == "fixed":
        cfg["build_adj"], a = False, np.abs(arr(rng, N, N))
    elif case == "no_gcn":
        cfg["gcn_true"] = False
    elif case == "long_seq":    # seq_length past the receptive field
        cfg.update(seq_length=24)
    elif case == "linear_dilation":
        cfg.update(dilation_exponential=1, layers=3)
    x = arr(rng, 2, 2, n_in, cfg["seq_length"])
    jm = jatt.MTGNN(**cfg)
    opt = lambda v, f: None if v is None else f(v)
    jargs = (j(x), opt(a, j), opt(idx, j), opt(fe, j))
    p = shifted(jm.init(KEY, *jargs))
    tm = tatt.MTGNN(**cfg, **CPU).params_from_flax(p)
    out = tm(t(x), opt(a, t), opt(idx, t), opt(fe, t), train=train)
    assert out.shape == (2, 3, n_in, 1)
    close(out, jm.apply(p, *jargs, train=train), 1e-4)


def test_mtgnn_dropout_and_errors():
    tm = tatt.MTGNN(**dict(MT, dropout=0.3), **CPU,
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 2, N, 10, generator=torch.Generator().manual_seed(1))
    a = tm(x, train=True, generator=torch.Generator().manual_seed(2))
    b = tm(x, train=True, generator=torch.Generator().manual_seed(2))
    c = tm(x, train=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    with pytest.raises(ValueError, match="Input sequence length not equal"):
        tm(x[..., :9])
    assert tm.receptive_field == jatt.MTGNN(**MT).receptive_field == 19


# -- AAGCN --------------------------------------------------------------------

V = 7
SKELETON = np.array([[0, 1, 2, 3, 1, 5, 0], [1, 2, 3, 4, 5, 6, 6]])


def test_graph_aagcn_matches_jax():
    got = tatt.GraphAAGCN(SKELETON, V, **CPU)
    want = jatt.GraphAAGCN(SKELETON, V)
    assert got.num_nodes == V and got.A.shape == (3, V, V)
    close(got.A, want.A, 0)


def test_unit_tcn_matches_jax():
    x = arr(np.random.default_rng(0), 2, 9, V, 3)
    jm = jatt.UnitTCN(5, kernel_size=5, stride=2)
    p = shifted(jm.init(KEY, j(x)))
    tm = tatt.UnitTCN(3, 5, 5, 2, **CPU).params_from_flax(p)
    assert tm(t(x)).shape == (2, 5, V, 5)
    close(tm(t(x)), jm.apply(p, j(x)))
    want, upd = train_apply(jm, p, j(x))
    close(tm(t(x), True), want)
    stats_close(tm, upd)


@pytest.mark.parametrize("adaptive,attention,c_in", [
    (True, True, 3), (True, False, 8), (False, True, 8), (False, False, 3)])
def test_unit_gcn_matches_jax(adaptive, attention, c_in):
    x = arr(np.random.default_rng(1), 2, 10, V, c_in)
    a = jatt.GraphAAGCN(SKELETON, V).A
    jm = jatt.UnitGCN(8, adaptive=adaptive, attention=attention)
    p = shifted(jm.init(KEY, j(x), a))
    ta = t(np.asarray(a))
    tm = tatt.UnitGCN(c_in, 8, ta, adaptive=adaptive, attention=attention,
                      **CPU)
    if adaptive:
        # PA starts from the adjacency stack, alpha from 0, bn scale at 1e-6
        close(tm.PA, np.asarray(a), 0)
        assert float(tm.alpha.detach()) == 0.0
        assert tm.PA.data_ptr() != ta.data_ptr()
    close(tm.bn.scale, np.full(8, 1e-6, np.float32), 0)
    assert (c_in != 8) == hasattr(tm, "down_conv")
    tm.params_from_flax(p)
    close(tm(t(x), ta), jm.apply(p, j(x), a), 2e-5)
    want, upd = train_apply(jm, p, j(x), a)
    close(tm(t(x), ta, True), want, 2e-5)
    stats_close(tm, upd)


@pytest.mark.parametrize("c_in,stride,residual", [
    (3, 1, True), (8, 1, True), (3, 2, True), (8, 2, True), (3, 1, False)])
def test_aagcn_matches_jax(c_in, stride, residual):
    c_out = 8
    x = arr(np.random.default_rng(2), 2, c_in, 12, V)
    jm = jatt.AAGCN(c_in, c_out, tuple(map(tuple, SKELETON)), V, stride,
                    residual)
    p = shifted(jm.init(KEY, j(x)))
    tm = tatt.AAGCN(c_in, c_out, SKELETON, V, stride, residual,
                    **CPU).params_from_flax(p)
    assert (tm.residual_tcn is None) == (
        not residual or (c_in == c_out and stride == 1))
    out = tm(t(x))
    assert out.shape == (2, c_out, 12 // stride, V)
    close(out, jm.apply(p, j(x)), 1e-4)
    want, upd = train_apply(jm, p, j(x))
    close(tm(t(x), True), want, 1e-4)
    stats_close(tm, upd)
    with pytest.raises(ValueError, match="AAGCN expects X"):
        tm(t(x)[..., :V - 1])
    with pytest.raises(ValueError, match="AAGCN expects X"):
        jm.apply(p, j(x)[..., :V - 1])


# -- DNNTSP -------------------------------------------------------------------

@pytest.mark.parametrize("aggregate", ["mean", "concat"])
def test_masked_self_attention_matches_jax(aggregate):
    x = arr(np.random.default_rng(0), 3, 5, 6)
    jm = jatt.MaskedSelfAttention(6, 8, 2, aggregate)
    p = shifted(jm.init(KEY, j(x)))
    tm = tatt.MaskedSelfAttention(6, 8, 2, aggregate,
                                  **CPU).params_from_flax(p)
    out = tm(t(x))
    assert out.shape == (3, 5, 8)
    close(out, jm.apply(p, j(x)))
    # causal: step 0 does not see later steps
    later = x.copy()
    later[:, 1:] += 1.0
    close(tm(t(later))[:, 0], out[:, 0].detach().numpy(), 1e-6)


def test_masked_self_attention_rejects_an_unknown_aggregate():
    with pytest.raises(ValueError, match="wrong value for aggregate"):
        tatt.MaskedSelfAttention(6, 8, 2, "sum", **CPU)
    with pytest.raises(ValueError, match="wrong value for aggregate"):
        jatt.MaskedSelfAttention(6, 8, 2, "sum").init(
            KEY, jnp.zeros((1, 2, 6)))


def test_global_gated_updater_matches_jax():
    rng = np.random.default_rng(1)
    out, emb = arr(rng, 3 * 5, 4), arr(rng, 5, 4)
    jm = jatt.GlobalGatedUpdater(5)
    p = shifted(jm.init(KEY, j(out), j(emb)))
    tm = tatt.GlobalGatedUpdater(5, **CPU).params_from_flax(p)
    got = tm(t(out), t(emb))
    assert got.shape == (3, 5, 4)
    close(got, jm.apply(p, j(out), j(emb)))


ITEMS, STEPS = 6, 3


def dnntsp_graphs(seed=0):
    return graphs(seed=seed, n=ITEMS * STEPS, e=60, pad=3)


def test_weighted_gcn_block_matches_jax():
    jg, tg = dnntsp_graphs()
    x = arr(np.random.default_rng(2), ITEMS * STEPS, 4)
    jm = jatt.WeightedGCNBlock([5, 6], 4)
    p = shifted(jm.init(KEY, j(x), jg))
    tm = tatt.WeightedGCNBlock(4, [5, 6], 4, **CPU).params_from_flax(p)
    close(tm(t(x), tg), jm.apply(p, j(x), jg))
    want, upd = train_apply(jm, p, j(x), jg)
    close(tm(t(x), tg, True), want, 2e-5)
    stats_close(tm, upd)


@pytest.mark.parametrize("train", [False, True])
def test_dnntsp_matches_jax(train):
    jg, tg = dnntsp_graphs(1)
    x = arr(np.random.default_rng(3), ITEMS * STEPS, 4)
    jm = jatt.DNNTSP(ITEMS, 4, 2)
    p = shifted(jm.init(KEY, j(x), jg))
    tm = tatt.DNNTSP(ITEMS, 4, 2, **CPU).params_from_flax(p)
    if train:
        want, upd = train_apply(jm, p, j(x), jg)
        out = tm(t(x), tg, True)
        stats_close(tm, upd)
    else:
        want, out = jm.apply(p, j(x), jg), tm(t(x), tg)
    assert out.shape == (STEPS, ITEMS, 4)
    close(out, want, 1e-4)


# -- the package ----------------------------------------------------------------

def test_the_same_names_are_exported():
    assert sorted(tatt.__all__) == sorted(jatt.__all__)
    assert len(tatt.__all__) == 30
    from pytorch_geometric_temporal_tpu_torch import models
    for name in tatt.__all__:
        assert getattr(models, name) is getattr(tatt, name)


def test_seeded_construction_is_reproducible():
    make = lambda seed: tatt.ASTGCN(
        **AST, **CPU, generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
    assert any(not torch.equal(p, r) for p, r in zip(a.parameters(),
                                                     c.parameters()))
