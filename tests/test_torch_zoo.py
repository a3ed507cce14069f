"""Port parity of the recurrent zoo against the JAX package: TGCN, A3TGCN,
GConvLSTM, GCLSTM, LRGCN, DyGrEncoder, EvolveGCN-O/H and their ``Seq``
forms, MPNNLSTM, AGCRN, and the convolutions under them.

Inputs are made with numpy from a seed and handed to both packages; the
flax module is initialized, its parameters (biases moved off zero so a
missed transplant shows) go through ``params_from_flax``.  Tolerances (f32
on the CPU, JAX at "highest" matmul precision): outputs and carried state
1e-5 absolute, parameter gradients of a scalar loss 1e-4 relative to each
gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu import models as jmodels
from pytorch_geometric_temporal_tpu import ops as jops
from pytorch_geometric_temporal_tpu_torch import models as tmodels
from pytorch_geometric_temporal_tpu_torch import ops as tops
from pytorch_geometric_temporal_tpu_torch.models import _cells

N = 24
CPU = dict(device="cpu")


def edges(seed=0, n=N, e=120, pad=0):
    rng = np.random.default_rng(seed)
    ei = np.unique(rng.integers(0, n, size=(2, e)), axis=1)
    w = rng.uniform(0.2, 1.5, ei.shape[1]).astype(np.float32)
    return ei, w, ei.shape[1] + pad


def graphs(seed=0, n=N, e=120, pad=0):
    ei, w, pad_to = edges(seed, n, e, pad)
    return (jops.Graph.from_edge_index(ei, w, num_nodes=n, pad_to=pad_to),
            tops.Graph.from_edge_index(ei, w, num_nodes=n, pad_to=pad_to,
                                       **CPU))


def arr(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


def shifted(variables):
    """The flax variables as numpy, every leaf moved by 0.05 (zero biases
    and unit statistics become visible to the transplant)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05, variables)


def close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol, err_msg=msg)


def grads_close(tmodule, tloss, jgrads):
    """Every torch parameter's gradient against the flax gradient at the
    same path, 1e-4 of the flax gradient's largest entry."""
    tloss.backward()
    flat = _cells._flatten(jax.tree_util.tree_map(np.asarray,
                                                  jgrads)["params"])
    got = dict(tmodule.named_parameters())
    assert set(got) == set(flat)
    for name, p in got.items():
        want = flat[name]
        # a parameter the loss does not reach has no gradient here, zeros
        # in JAX
        got_grad = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(
            got_grad, want, rtol=0,
            atol=1e-4 * max(np.abs(want).max(), 1e-3), err_msg=name)


def sq(*outs):
    return sum((o ** 2).sum() for o in outs)


# -- TGCN / A3TGCN ----------------------------------------------------------

@pytest.mark.parametrize("lead,improved,loops,with_h", [
    ((), False, True, False), ((), True, True, True),
    ((3,), False, True, True), ((3,), False, False, False)])
def test_tgcn_matches_jax(lead, improved, loops, with_h):
    jg, tg = graphs(seed=1, pad=5)
    rng = np.random.default_rng(2)
    x = arr(rng, *lead, N, 4)
    h = arr(rng, *lead, N, 6) if with_h else None
    jm = jmodels.TGCN(6, improved, loops)
    p = shifted(jm.init(jax.random.PRNGKey(0), j(x), jg, j(h)))
    tm = tmodels.TGCN(4, 6, improved, loops, **CPU).params_from_flax(p)
    out = tm(t(x), tg, t(h))
    close(out, jm.apply(p, j(x), jg, j(h)))
    grads_close(tm, sq(out), jax.grad(
        lambda q: sq(jm.apply(q, j(x), jg, j(h))))(p))
    assert tmodels.TGCN2 is tmodels.TGCN


@pytest.mark.parametrize("lead,with_h", [((), False), ((), True),
                                         ((2,), False), ((2,), True)])
def test_a3tgcn_matches_jax(lead, with_h):
    jg, tg = graphs(seed=3)
    rng = np.random.default_rng(4)
    x = arr(rng, *lead, N, 3, 5)
    h = arr(rng, *lead, N, 6) if with_h else None
    jm = jmodels.A3TGCN(6, periods=5)
    p = shifted(jm.init(jax.random.PRNGKey(0), j(x), jg, j(h)))
    tm = tmodels.A3TGCN(3, 6, 5, **CPU).params_from_flax(p)
    out = tm(t(x), tg, t(h))
    assert out.shape == lead + (N, 6)
    close(out, jm.apply(p, j(x), jg, j(h)))
    grads_close(tm, sq(out), jax.grad(
        lambda q: sq(jm.apply(q, j(x), jg, j(h))))(p))
    with pytest.raises(ValueError, match="A3TGCN expects input"):
        tm(t(x)[..., :4], tg)
    assert tmodels.A3TGCN2 is tmodels.A3TGCN


def test_a3tgcn_attention_is_drawn_uniform():
    tm = tmodels.A3TGCN(2, 4, periods=2000, **CPU,
                        generator=torch.Generator().manual_seed(0))
    a = tm.attention.detach().numpy()
    assert 0.0 <= a.min() and a.max() < 1.0
    assert abs(a.mean() - 0.5) < 0.03 and abs(a.std() - 12 ** -0.5) < 0.02


# -- Chebyshev LSTMs --------------------------------------------------------

@pytest.mark.parametrize("name", ["GConvLSTM", "GCLSTM"])
@pytest.mark.parametrize("lead,K,bias,lam,state", [
    ((), 1, True, None, False), ((), 3, True, 1.7, True),
    ((2,), 2, False, None, True)])
def test_cheb_lstms_match_jax(name, lead, K, bias, lam, state):
    jg, tg = graphs(seed=5, pad=3)
    rng = np.random.default_rng(6)
    x = arr(rng, *lead, N, 4)
    h, c = ((arr(rng, *lead, N, 5), arr(rng, *lead, N, 5)) if state
            else (None, None))
    jm = getattr(jmodels, name)(5, K, "sym", bias)
    p = shifted(jm.init(jax.random.PRNGKey(0), j(x), jg, j(h), j(c), lam))
    tm = getattr(tmodels, name)(4, 5, K, "sym", bias,
                                **CPU).params_from_flax(p)
    h1, c1 = tm(t(x), tg, t(h), t(c), lam)
    jh, jc = jm.apply(p, j(x), jg, j(h), j(c), lam)
    close(h1, jh)
    close(c1, jc)
    grads_close(tm, sq(h1, c1), jax.grad(
        lambda q: sq(*jm.apply(q, j(x), jg, j(h), j(c), lam)))(p))


# -- RGCNConv / LRGCN -------------------------------------------------------

def relations(seed=7, n=N, r=3):
    rng = np.random.default_rng(seed)
    ei, w, _ = edges(seed, n, 150)
    # relation 2 is rare: the others are padded well past their own edges
    et = rng.choice(r, size=ei.shape[1], p=[0.6, 0.35, 0.05])
    from pytorch_geometric_temporal_tpu.models.recurrent import lrgcn as jl
    return (jl.split_relations(ei, et, r, n, w),
            tmodels.split_relations(ei, et, r, n, w, **CPU))


def test_split_relations_matches_jax():
    jrel, trel = relations()
    assert len(jrel) == len(trel) == 3
    for jg, tg in zip(jrel, trel):
        assert (tg.num_nodes, tg.num_edges, tg.edge_pad) == (
            jg.num_nodes, jg.num_edges, jg.senders.shape[0])
        assert tg.num_edges < tg.edge_pad or tg is trel[0]
        np.testing.assert_array_equal(tg.senders.numpy(), jg.senders)
        np.testing.assert_array_equal(tg.receivers.numpy(), jg.receivers)
        np.testing.assert_array_equal(tg.weights.numpy(), jg.weights)


@pytest.mark.parametrize("num_bases,root,bias", [
    (None, True, True), (2, True, True), (None, False, False)])
def test_rgcn_conv_matches_jax(num_bases, root, bias):
    jrel, trel = relations()
    x = arr(np.random.default_rng(8), 2, N, 4)
    jm = jmodels.RGCNConv(5, 3, num_bases, root, bias)
    p = shifted(jm.init(jax.random.PRNGKey(0), j(x), jrel))
    tm = tmodels.RGCNConv(4, 5, 3, num_bases, root, bias,
                          **CPU).params_from_flax(p)
    out = tm(t(x), trel)
    close(out, jm.apply(p, j(x), jrel))
    grads_close(tm, sq(out), jax.grad(
        lambda q: sq(jm.apply(q, j(x), jrel)))(p))
    with pytest.raises(ValueError, match="expected 3 relation graphs"):
        tm(t(x), trel[:2])


@pytest.mark.parametrize("lead,num_bases,state", [
    ((), None, False), ((), 2, True), ((2,), 2, False), ((2,), None, True)])
def test_lrgcn_matches_jax(lead, num_bases, state):
    jrel, trel = relations(seed=9)
    rng = np.random.default_rng(10)
    x = arr(rng, *lead, N, 4)
    h, c = ((arr(rng, *lead, N, 5), arr(rng, *lead, N, 5)) if state
            else (None, None))
    jm = jmodels.LRGCN(5, 3, num_bases)
    p = shifted(jm.init(jax.random.PRNGKey(0), j(x), jrel, j(h), j(c)))
    tm = tmodels.LRGCN(4, 5, 3, num_bases, **CPU).params_from_flax(p)
    h1, c1 = tm(t(x), trel, t(h), t(c))
    jh, jc = jm.apply(p, j(x), jrel, j(h), j(c))
    close(h1, jh)
    close(c1, jc)
    grads_close(tm, sq(h1, c1), jax.grad(
        lambda q: sq(*jm.apply(q, j(x), jrel, j(h), j(c))))(p))


# -- GatedGraphConv / DyGrEncoder -------------------------------------------

@pytest.mark.parametrize("aggr,lead", [
    ("add", ()), ("mean", ()), ("max", ()), ("add", (2,)), ("mean", (2,))])
def test_gated_graph_conv_matches_jax(aggr, lead):
    # a padded graph whose last nodes receive no edge at all
    ei, w, _ = edges(seed=11, n=N - 4, e=90)
    jg = jops.Graph.from_edge_index(ei, w, num_nodes=N, pad_to=ei.shape[1] + 6)
    tg = tops.Graph.from_edge_index(ei, w, num_nodes=N,
                                    pad_to=ei.shape[1] + 6, **CPU)
    x = arr(np.random.default_rng(12), *lead, N, 3)
    jm = jmodels.GatedGraphConv(5, 2, aggr)
    p = shifted(jm.init(jax.random.PRNGKey(0), j(x), jg))
    tm = tmodels.GatedGraphConv(5, 2, aggr, **CPU).params_from_flax(p)
    out = tm(t(x), tg)
    close(out, jm.apply(p, j(x), jg))
    grads_close(tm, sq(out), jax.grad(
        lambda q: sq(jm.apply(q, j(x), jg)))(p))
    with pytest.raises(ValueError, match="input channels must be <="):
        tm(torch.zeros(N, 6), tg)


@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
@pytest.mark.parametrize("layers,state", [(1, False), (1, True), (2, False),
                                          (2, True)])
def test_dygrencoder_matches_jax(aggr, layers, state):
    jg, tg = graphs(seed=13, pad=4)
    rng = np.random.default_rng(14)
    x = arr(rng, N, 3)
    shape = (N, 6) if layers == 1 else (layers, N, 6)
    h, c = (arr(rng, *shape), arr(rng, *shape)) if state else (None, None)
    jm = jmodels.DyGrEncoder(5, 2, aggr, 6, layers)
    p = shifted(jm.init(jax.random.PRNGKey(0), j(x), jg, j(h), j(c)))
    tm = tmodels.DyGrEncoder(5, 2, aggr, 6, layers,
                             **CPU).params_from_flax(p)
    outs = tm(t(x), tg, t(h), t(c))
    wants = jm.apply(p, j(x), jg, j(h), j(c))
    for got, want in zip(outs, wants):
        assert tuple(got.shape) == want.shape
        close(got, want)
    grads_close(tm, sq(*outs), jax.grad(
        lambda q: sq(*jm.apply(q, j(x), jg, j(h), j(c))))(p))


def test_dygrencoder_errors():
    _, tg = graphs(seed=13)
    x = torch.zeros(N, 3)
    with pytest.raises(ValueError, match="Wrong aggregator"):
        tmodels.DyGrEncoder(5, 1, "sum", 6, 1, **CPU)(x, tg)
    with pytest.raises(ValueError, match="Invalid hidden state and cell"):
        tmodels.DyGrEncoder(5, 1, "add", 6, 1, **CPU)(x, tg,
                                                     torch.zeros(N, 6))


# -- EvolveGCN --------------------------------------------------------------

def evolve_pair(variant, n, f, **kw):
    if variant == "O":
        return (jmodels.EvolveGCNO(f, **kw),
                tmodels.EvolveGCNO(f, **kw, **CPU))
    return (jmodels.EvolveGCNH(n, f, **kw),
            tmodels.EvolveGCNH(n, f, **kw, **CPU))


@pytest.mark.parametrize("variant", ["O", "H"])
@pytest.mark.parametrize("improved,carried", [(False, False), (True, True)])
def test_evolvegcn_cells_match_jax(variant, improved, carried):
    jg, tg = graphs(seed=15, pad=2)
    rng = np.random.default_rng(16)
    x = arr(rng, N, 6)
    w = arr(rng, 6, 6) if carried else None
    jm, tm = evolve_pair(variant, N, 6, improved=improved)
    p = shifted(jm.init(jax.random.PRNGKey(0), j(x), jg, j(w)))
    tm.params_from_flax(p)
    out, new_w = tm(t(x), tg, t(w))
    jout, jw = jm.apply(p, j(x), jg, j(w))
    close(out, jout)
    close(new_w, jw)
    grads_close(tm, sq(out, new_w), jax.grad(
        lambda q: sq(*jm.apply(q, j(x), jg, j(w))))(p))


def dynamic_graphs(seed, n, steps):
    pairs = [graphs(seed + i, n, 5 * n + 20 * i) for i in range(steps)]
    return [a for a, _ in pairs], [b for _, b in pairs]


@pytest.mark.parametrize("variant", ["O", "H"])
@pytest.mark.parametrize("kind", ["static", "dynamic", "bcsr"])
def test_evolvegcn_seq_matches_jax(variant, kind):
    n, f, steps = 200, 8, 4
    xs = arr(np.random.default_rng(17), steps, n, f)
    jgs, tgs = dynamic_graphs(18, n, steps)
    if kind == "static":
        jg, tg = jgs[0], tgs[0]
    else:
        jg, tg = jops.stack_graphs(jgs), tops.stack_graphs(tgs)
    if variant == "O":
        jm, jop = (jmodels.EvolveGCNOSeq(f),
                   jmodels.EvolveGCNOSeq(f, normalize=False))
        tm, top = (tmodels.EvolveGCNOSeq(f, **CPU),
                   tmodels.EvolveGCNOSeq(f, normalize=False, **CPU))
    else:
        jm, jop = (jmodels.EvolveGCNHSeq(n, f),
                   jmodels.EvolveGCNHSeq(n, f, normalize=False))
        tm, top = (tmodels.EvolveGCNHSeq(n, f, **CPU),
                   tmodels.EvolveGCNHSeq(n, f, normalize=False, **CPU))
    p = shifted(jm.init(jax.random.PRNGKey(0), j(xs), jg))
    if kind == "bcsr":
        # the JAX side through its XLA path, as its own tests run it
        jm, tm = jop, top
        jg = jops.stack_bcsr_gcn(jgs, min_block_edges=16, pack=2)
        tg = tops.stack_bcsr_gcn(tgs, min_block_edges=16, **CPU)
    tm.params_from_flax(p)
    out = tm(t(xs), tg)
    assert out.shape == (steps, n, f)
    close(out, jm.apply(p, j(xs), jg))
    grads_close(tm, sq(out), jax.grad(
        lambda q: sq(jm.apply(q, j(xs), jg)))(p))


@pytest.mark.parametrize("variant", ["O", "H"])
def test_evolvegcn_seq_over_bcsr_needs_normalize_false(variant):
    n, f = 130, 4
    _, tgs = dynamic_graphs(19, n, 2)
    ops = tops.stack_bcsr_gcn(tgs, **CPU)
    tm = (tmodels.EvolveGCNOSeq(f, **CPU) if variant == "O"
          else tmodels.EvolveGCNHSeq(n, f, **CPU))
    with pytest.raises(ValueError, match="needs normalize=False"):
        tm(torch.zeros(2, n, f), ops)
    with pytest.raises(ValueError, match=f"EvolveGCN{variant}Seq over a "
                                         "stacked BCSR operator"):
        tm(torch.zeros(2, n, f), ops)


# -- MPNNLSTM ---------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_mpnn_lstm_matches_jax(train):
    n, w, f, hid = 10, 3, 4, 5
    # the window is folded into the node axis: a block-diagonal graph
    ei, ew, _ = edges(seed=20, n=n, e=40)
    ei = np.concatenate([ei + k * n for k in range(w)], axis=1)
    ew = np.tile(ew, w)
    jg = jops.Graph.from_edge_index(ei, ew, num_nodes=n * w)
    tg = tops.Graph.from_edge_index(ei, ew, num_nodes=n * w, **CPU)
    x = arr(np.random.default_rng(21), w * n, f)
    jm = jmodels.MPNNLSTM(hid, n, w, dropout=0.0)
    v = shifted(jm.init(jax.random.PRNGKey(0), j(x), jg))
    tm = tmodels.MPNNLSTM(f, hid, n, w, dropout=0.0,
                          **CPU).params_from_flax(v)
    out = tm(t(x), tg, train=train)
    assert out.shape == (n, 2 * hid + f + w - 1)

    def japply(q):
        return jm.apply({"params": q, "batch_stats": v["batch_stats"]},
                        j(x), jg, train=train, mutable=["batch_stats"])

    want, stats = japply(v["params"])
    close(out, want)
    # running statistics after the call: moved in training (momentum 0.99,
    # biased variance), untouched in evaluation
    for bn in ("bn_1", "bn_2"):
        for stat in ("mean", "var"):
            got = getattr(getattr(tm, bn), stat)
            close(got, stats["batch_stats"][bn][stat], 1e-6, f"{bn}.{stat}")
            moved = not np.allclose(got.numpy(), v["batch_stats"][bn][stat])
            assert moved == train
    grads_close(tm, sq(out), {"params": jax.grad(
        lambda q: sq(japply(q)[0]))(v["params"])})


def test_mpnn_lstm_dropout_only_in_training():
    n, w = 6, 2
    ei, ew, _ = edges(seed=22, n=n * w, e=30)
    tg = tops.Graph.from_edge_index(ei, ew, num_nodes=n * w, **CPU)
    tm = tmodels.MPNNLSTM(3, 4, n, w, dropout=0.5, **CPU,
                          generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(arr(np.random.default_rng(23), w * n, 3))
    torch.testing.assert_close(tm(x, tg), tm(x, tg))
    torch.manual_seed(0)
    a = tm(x, tg, train=True)
    b = tm(x, tg, train=True)
    assert not torch.allclose(a, b)


# -- AVWGCN / AGCRN ---------------------------------------------------------

@pytest.mark.parametrize("topk", [None, 5])
@pytest.mark.parametrize("lead,K,with_h", [((2,), 2, False), ((2,), 3, True),
                                           ((), 2, True)])
def test_agcrn_matches_jax(topk, lead, K, with_h):
    rng = np.random.default_rng(24)
    x = arr(rng, *lead, N, 3)
    e = arr(rng, N, 4)
    h = arr(rng, *lead, N, 6) if with_h else None
    jm = jmodels.AGCRN(N, 6, K, 4, topk)
    p = shifted(jm.init(jax.random.PRNGKey(0), j(x), j(e), j(h)))
    tm = tmodels.AGCRN(N, 3, 6, K, 4, topk, **CPU).params_from_flax(p)
    te = t(e).requires_grad_()
    out = tm(t(x), te, t(h))
    close(out, jm.apply(p, j(x), j(e), j(h)))
    jgp, jge = jax.grad(lambda q, ee: sq(jm.apply(q, j(x), ee, j(h))),
                        argnums=(0, 1))(p, j(e))
    grads_close(tm, sq(out), jgp)
    np.testing.assert_allclose(te.grad.numpy(), jge, rtol=0,
                               atol=1e-4 * np.abs(jge).max())


def test_agcrn_errors():
    tm = tmodels.AGCRN(N, 3, 6, 2, 4, **CPU)
    with pytest.raises(ValueError, match="expects node embeddings E"):
        tm(torch.zeros(2, N, 3), torch.zeros(N, 5))
    with pytest.raises(ValueError, match=r"expects X \(\.\.\., N="):
        tm(torch.zeros(2, N + 1, 3), torch.zeros(N, 4))
    big = tmodels.AVWGCN(2, 2, 2, 2, **CPU)
    with pytest.raises(ValueError, match=r"O\(N²\) memory; N=8193 would "
                                         r"allocate 0\.5 GiB.*topk=16"):
        big(torch.zeros(8193, 2), torch.zeros(8193, 2))


def test_avwgcn_topk_breaks_ties_like_jax():
    """Many equal scores (relu zeroes half the pairs, rows repeat): the
    kept columns are the JAX package's, lowest index first."""
    rng = np.random.default_rng(25)
    e = np.repeat(arr(rng, 6, 3), 5, axis=0)          # 30 rows, 6 distinct
    from pytorch_geometric_temporal_tpu.models import conv as jconv
    from pytorch_geometric_temporal_tpu_torch.models import conv as tconv
    jcols, jvals = jconv._topk_support(j(e), 7, chunk=8)
    tcols, tvals = tconv._topk_support(t(e), 7, chunk=8)
    np.testing.assert_array_equal(tcols.numpy(), jcols)
    close(tvals, jvals, 1e-6)


# -- the flax building blocks' initial draws --------------------------------

def test_initial_draws_have_flax_distributions():
    gen = torch.Generator().manual_seed(0)
    k = _cells.lecun_normal((400, 300), gen).numpy()
    assert abs(k.std() - 400 ** -0.5) < 2e-3
    assert np.abs(k).max() <= 2.0 * 400 ** -0.5 / 0.87962566103423978
    q = _cells.orthogonal((6, 6), gen).double().numpy()
    np.testing.assert_allclose(q.T @ q, np.eye(6), atol=1e-6)
    g = _cells.glorot((3, 2, 50, 40), gen).numpy()
    limit = (6.0 / ((50 + 40) * 6)) ** 0.5        # leading axes count
    assert np.abs(g).max() <= limit
    assert abs(g.std() - limit / 3 ** 0.5) < 0.01 * limit
    cell = _cells.GRUCell(5, 4, **CPU, generator=gen)
    names = {n for n, _ in cell.named_parameters()}
    assert names == {"ir.kernel", "ir.bias", "iz.kernel", "iz.bias",
                     "in.kernel", "in.bias", "hr.kernel", "hz.kernel",
                     "hn.kernel", "hn.bias"}
    for n, p in cell.named_parameters():
        if n.endswith("bias"):
            assert not p.detach().any()
    lstm = _cells.LSTMCell(5, 4, **CPU, generator=gen)
    assert {n for n, _ in lstm.named_parameters()} == (
        {f"i{g}.kernel" for g in "ifgo"} | {f"h{g}.kernel" for g in "ifgo"}
        | {f"h{g}.bias" for g in "ifgo"})


def test_load_flax_refuses_other_names():
    cell = _cells.GRUCell(3, 2, **CPU)
    with pytest.raises(ValueError, match="parameter names differ"):
        cell.params_from_flax({"params": {"ir": {"kernel": np.zeros((3, 2))}}})
