"""Port parity: ChebConv, GCNConv, GConvGRU, ``stack_bcsr`` and the
snapshot trainer against the JAX package, and the snapshot pipeline as a
whole (three epochs on Chickenpox from transplanted parameters).

Inputs are made with numpy from a seed and handed to both packages; flax
parameters are transplanted with ``params_from_flax``.  Tolerances (f32 on
the CPU, JAX at "highest" matmul precision): forwards 1e-5 of the output's
scale, parameter gradients 1e-4 relative to each gradient's scale (sums
over nodes and steps in another order), per-epoch losses of the trainer
1e-5 relative and parameters after three Adam steps 5e-6 (each step moves
a parameter by ~1e-2; Adam divides the gradient by its own magnitude, so
gradient rounding of ~1e-5 relative moves the update by ~1e-7).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_temporal_tpu import models as jmodels
from pytorch_geometric_temporal_tpu import ops as jops
from pytorch_geometric_temporal_tpu import signal as jsig
from pytorch_geometric_temporal_tpu import train as jtrain
from pytorch_geometric_temporal_tpu.data import (
    ChickenpoxDatasetLoader as JChickenpox)
from pytorch_geometric_temporal_tpu_torch import config_override
from pytorch_geometric_temporal_tpu_torch import models as tmodels
from pytorch_geometric_temporal_tpu_torch import ops as tops
from pytorch_geometric_temporal_tpu_torch import signal as tsig
from pytorch_geometric_temporal_tpu_torch.data import ChickenpoxDatasetLoader
from pytorch_geometric_temporal_tpu_torch.models.conv import load_linear
from pytorch_geometric_temporal_tpu_torch.ops import bcsr as tb
from pytorch_geometric_temporal_tpu_torch.train import SnapshotTrainer, mse
from _torch_jax_native import jax_native  # noqa: F401

# the JAX package's native library, loaded race-free: its RCM order is
# what the port's native layer is compared with (see the module)
pytestmark = pytest.mark.usefixtures("jax_native")


N = 30


def graphs(seed=0, n=N, e=150, loops=3):
    rng = np.random.default_rng(seed)
    ei = np.unique(rng.integers(0, n, size=(2, e)), axis=1)
    loop = rng.choice(n, size=loops, replace=False)
    ei = np.concatenate([ei, np.stack([loop, loop])], axis=1)
    w = rng.uniform(0.1, 1.5, ei.shape[1]).astype(np.float32)
    return (jops.Graph.from_edge_index(ei, w, num_nodes=n),
            tops.Graph.from_edge_index(ei, w, num_nodes=n, device="cpu"))


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def assert_close(got, want, tol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-3),
                               err_msg=msg)


def assert_grads_match(tmodule, loss, jgrads, names=None):
    loss.backward()
    jgrads = numpy_tree(jgrads)["params"]
    got = dict(tmodule.named_parameters())
    assert set(got) == set(names or jgrads)
    for name, p in got.items():
        assert_close(p.grad, jgrads[name], 1e-4, name)


@pytest.mark.parametrize("K,normalization,lam", [
    (1, "sym", None), (2, "sym", None), (3, "sym", 1.6), (3, "rw", None),
    (2, None, 3.0)])
def test_cheb_conv_matches_jax(K, normalization, lam):
    jg, tg = graphs()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, N, 4)).astype(np.float32)
    y = rng.normal(size=(2, N, 6)).astype(np.float32)
    jconv = jmodels.ChebConv(out_channels=6, K=K,
                             normalization=normalization)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x), jg, lam)
    # the zero-initialized bias gets a value, so the transplant is seen
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)
    tconv = tmodels.ChebConv(4, 6, K, normalization, device="cpu")
    tconv.params_from_flax(numpy_tree(params))

    def jloss(p):
        return jnp.mean((jconv.apply(p, jnp.asarray(x), jg, lam) - y) ** 2)

    out = tconv(torch.from_numpy(x), tg, lam)
    assert_close(out, jconv.apply(params, jnp.asarray(x), jg, lam), 1e-5)
    assert_grads_match(tconv, mse(out, torch.from_numpy(y)),
                       jax.grad(jloss)(params))


@pytest.mark.parametrize("improved,add_self_loops,normalize", [
    (False, True, True), (True, True, True), (False, False, True),
    (False, True, False)])
def test_gcn_conv_matches_jax(improved, add_self_loops, normalize):
    jg, tg = graphs(seed=2)
    if not normalize:       # an already-normalized operator on both sides
        jg = jops.prenormalize_gcn(jg)
        tg = tops.prenormalize_gcn(tg, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(N, 5)).astype(np.float32)
    y = rng.normal(size=(N, 3)).astype(np.float32)
    jconv = jmodels.GCNConv(out_channels=3, improved=improved,
                            add_self_loops=add_self_loops,
                            normalize=normalize)
    params = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x), jg)
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)
    tconv = tmodels.GCNConv(5, 3, improved, add_self_loops, normalize,
                            device="cpu")
    tconv.params_from_flax(numpy_tree(params))

    def jloss(p):
        return jnp.mean((jconv.apply(p, jnp.asarray(x), jg) - y) ** 2)

    out = tconv(torch.from_numpy(x), tg)
    assert_close(out, jconv.apply(params, jnp.asarray(x), jg), 1e-5)
    assert_grads_match(tconv, mse(out, torch.from_numpy(y)),
                       jax.grad(jloss)(params))
    w = np.array(params["params"]["weight"])
    want = jmodels.conv.gcn_conv_fixed_w(
        jnp.asarray(x), jg, jnp.asarray(w), improved=improved,
        add_self_loops=add_self_loops, normalize=normalize)
    got = tmodels.gcn_conv_fixed_w(
        torch.from_numpy(x), tg, torch.from_numpy(w), improved=improved,
        add_self_loops=add_self_loops, normalize=normalize)
    assert_close(got, want, 1e-5)


def test_layers_reject_a_wrong_node_axis():
    _, tg = graphs()
    x = torch.zeros(4, N + 1, 4)
    for layer in (tmodels.ChebConv(4, 2, 2, device="cpu"),
                  tmodels.GCNConv(4, 2, device="cpu"),
                  tmodels.GConvGRU(4, 2, 2, device="cpu")):
        with pytest.raises(ValueError, match="node axis"):
            layer(x, tg)
    with pytest.raises(ValueError, match="does not match"):
        tmodels.ChebConv(4, 2, 2, device="cpu").params_from_flax(
            {"weight": np.zeros((3, 2)), "bias": np.zeros(2)})


@pytest.mark.parametrize("K,with_h,use_bias", [
    (1, False, True), (2, True, True), (3, True, False), (3, False, True)])
def test_gconv_gru_matches_jax(K, with_h, use_bias):
    jg, tg = graphs(seed=4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, N, 4)).astype(np.float32)
    h = rng.normal(size=(2, N, 8)).astype(np.float32) if with_h else None
    y = rng.normal(size=(2, N, 8)).astype(np.float32)
    jh = None if h is None else jnp.asarray(h)
    jcell = jmodels.GConvGRU(out_channels=8, K=K, use_bias=use_bias)
    params = jcell.init(jax.random.PRNGKey(2), jnp.asarray(x), jg, jh)
    params = jax.tree_util.tree_map(lambda a: a + 0.05, params)
    tcell = tmodels.GConvGRU(4, 8, K, use_bias=use_bias, device="cpu")
    tcell.params_from_flax(numpy_tree(params))
    names = {f"w_{s}{g}" for s in "xh" for g in "zrh"}
    if use_bias:
        names |= {"b_z", "b_r", "b_h"}

    def jloss(p):
        return jnp.mean((jcell.apply(p, jnp.asarray(x), jg, jh) - y) ** 2)

    out = tcell(torch.from_numpy(x), tg,
                None if h is None else torch.from_numpy(h))
    assert_close(out, jcell.apply(params, jnp.asarray(x), jg, jh), 1e-5)
    assert_grads_match(tcell, mse(out, torch.from_numpy(y)),
                       jax.grad(jloss)(params), names)


def cheb_setup(n=600, t=4, f=5, bf16=False):
    """A banded graph with ~10% cross edges, its Chebyshev BCSR operator
    (tiles and a remainder) and a seeded (t, n, f) signal."""
    rng = np.random.default_rng(8)
    s = rng.integers(0, n, size=5000)
    r = np.clip(s + rng.integers(-20, 21, size=5000), 0, n - 1)
    cross = rng.random(5000) < 0.1
    r[cross] = rng.integers(0, n, size=cross.sum())
    ei = np.stack([s, r])
    w = rng.uniform(0.1, 1.0, 5000).astype(np.float32)
    g = tops.Graph.from_edge_index(ei, w, num_nodes=n, device="cpu")
    op = tops.prenormalize_cheb(
        g, bcsr=True, min_block_edges=32, device="cpu",
        dtype=torch.bfloat16 if bf16 else None)
    assert op.op.fwd.nnzb and op.op.fwd.num_rem
    sig = tsig.StackedSignal.from_arrays(
        rng.normal(size=(t, n, f)), rng.normal(size=(t, n)), ei, w,
        device="cpu")
    return g, op, sig


def test_gconv_gru_over_prenormalized_operators():
    """The same cell over the raw graph, the prenormalized Graph, the
    prenormalized BCSR operator (f32 tiles and a remainder) and a
    PreparedGraph: one function, four routes."""
    tg, mat, sig = cheb_setup()
    cell = tmodels.GConvGRU(5, 6, 3, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    x = sig.features[0]
    want = cell(x, tg)
    pre = tops.prenormalize_cheb(tg, device="cpu")
    assert isinstance(pre.op, tops.Graph)
    for route in (pre, mat,
                  tops.prepare_graph(tg, kinds=("cheb",), device="cpu")):
        torch.testing.assert_close(cell(x, route), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the snapshot pipeline as a whole
# ---------------------------------------------------------------------------


class JNet(fnn.Module):
    K: int = 1

    @fnn.compact
    def __call__(self, x, graph, h=None):
        h = jmodels.GConvGRU(out_channels=32, K=self.K,
                             name="recurrent")(x, graph, h)
        return fnn.Dense(1, name="linear")(fnn.relu(h))[..., 0], h


class TNet(torch.nn.Module):
    def __init__(self, in_channels, K=1, hidden=32):
        super().__init__()
        self.recurrent = tmodels.GConvGRU(in_channels, hidden, K,
                                          device="cpu")
        self.linear = torch.nn.Linear(hidden, 1)

    def forward(self, x, graph, h=None):
        h = self.recurrent(x, graph, h)
        return self.linear(torch.relu(h))[..., 0], h

    def params_from_flax(self, tree):
        p = tree["params"]
        self.recurrent.params_from_flax(p["recurrent"])
        load_linear(self.linear, p["linear"])
        return self


def flat_params(tree):
    p = numpy_tree(tree)["params"]
    out = {f"recurrent.{k}": v for k, v in p["recurrent"].items()}
    out["linear.weight"] = p["linear"]["kernel"].T
    out["linear.bias"] = p["linear"]["bias"]
    return out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("threaded", [False, True])
def test_snapshot_trainer_three_epochs_on_chickenpox_match_jax(remat,
                                                               threaded):
    """The accuracy protocol's pipeline on both sides: loader → split →
    stacked signal → GConvGRU(4→32, K=1) + relu + Linear → three epochs of
    full-sequence BPTT, one Adam(1e-2) update each; ``threaded`` carries
    the hidden state across snapshots."""
    jtr, _ = jsig.temporal_signal_split(JChickenpox().get_dataset(lags=4),
                                        0.2)
    ttr, tte = tsig.temporal_signal_split(
        ChickenpoxDatasetLoader().get_dataset(lags=4, device="cpu"), 0.2)
    jtrain_sig = jsig.StackedSignal.from_signal(jtr)
    ttrain_sig = tsig.StackedSignal.from_signal(ttr)
    jnet = JNet()
    params = jnet.init(jax.random.PRNGKey(42), jtrain_sig.features[0],
                       jtrain_sig.graph())
    tnet = TNet(4).params_from_flax(numpy_tree(params))
    h0 = jnp.zeros((20, 32), jnp.float32)

    def j_loss_and_state(p, carry, x, y, g):
        out, h = jnet.apply(p, x, g, carry if threaded else None)
        return jtrain.mse(out, y), h

    def t_loss_and_state(carry, x, y, g):
        out, h = tnet(x, g, carry if threaded else None)
        return mse(out, y), h

    jtrainer = jtrain.SnapshotTrainer(j_loss_and_state, optax.adam(1e-2),
                                      remat=remat)
    ttrainer = SnapshotTrainer(tnet, t_loss_and_state, lr=1e-2, remat=remat,
                               device="cpu")
    opt_state = jtrainer.init(params)
    for _ in range(3):
        params, opt_state, jloss = jtrainer.train_epoch(
            params, opt_state, jtrain_sig, h0)
        tloss = ttrainer.train_epoch(ttrain_sig, torch.zeros(20, 32))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = {k: v.detach().numpy() for k, v in tnet.named_parameters()}
    want = flat_params(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-6, err_msg=k)
    teval = ttrainer.evaluate(tsig.StackedSignal.from_signal(tte),
                              torch.zeros(20, 32))
    assert teval.requires_grad is False and np.isfinite(float(teval))


def test_fit_reports_every_log_every_epochs_and_learns():
    ttr, _ = tsig.temporal_signal_split(
        ChickenpoxDatasetLoader().get_dataset(lags=4, device="cpu"), 0.05)
    sig = tsig.StackedSignal.from_signal(ttr)
    torch.manual_seed(0)
    net = TNet(4)
    trainer = SnapshotTrainer(
        net, lambda c, x, y, g: (mse(net(x, g)[0], y), c), device="cpu")
    seen = []
    assert trainer.fit(sig, 7, callback=lambda e, loss: seen.append(
        (e, float(loss))), log_every=3) is net
    assert [e for e, _ in seen] == [2, 5, 6]
    assert seen[-1][1] < seen[0][1]
    assert float(trainer.evaluate(sig)) < seen[0][1]


@pytest.mark.parametrize("remat", [False, True])
def test_aggregations_per_epoch_over_a_bcsr_operator(remat, monkeypatch):
    """GConvGRU at K=2 with the hidden state threaded makes 3 aggregations
    per snapshot forward and, backward, one at t=0 (only H·R depends on a
    parameter there) and two after: 5T − 1 per epoch.  Under ``remat`` the
    forward runs twice: 8T − 1.  Counted as calls of the kernel's wrapper
    (on the CPU it runs the plain version and its launch counter stays 0);
    the gradients with and without ``remat`` are the same numbers."""
    t = 4
    _, op, sig = cheb_setup(t=t)
    calls = []
    real = tb.hybrid_spmm
    monkeypatch.setattr(tb, "hybrid_spmm",
                        lambda half, x: calls.append(x.shape[1])
                        or real(half, x))
    torch.manual_seed(1)
    net = TNet(5, K=2, hidden=8)

    def loss_and_state(carry, x, y, g):
        out, h = net(x, op, carry)
        return mse(out, y), h

    trainer = SnapshotTrainer(net, loss_and_state, remat=remat,
                              device="cpu")
    before = [p.detach().clone() for p in net.parameters()]
    tb.reset_launch_counts()
    loss = trainer.train_epoch(sig, None)
    assert len(calls) == (8 * t - 1 if remat else 5 * t - 1)
    assert sorted(set(calls)) == [5, 8]      # F of x, F of H and H·R
    assert calls.count(5) == (2 * t if remat else t)
    assert tb.hybrid_spmm.launches == 0
    assert any(not torch.equal(a, b)
               for a, b in zip(before, net.parameters()))
    # the same epoch without remat from the same start: same loss
    with torch.no_grad():
        for p, b in zip(net.parameters(), before):
            p.copy_(b)
    plain = SnapshotTrainer(net, loss_and_state, device="cpu")
    torch.testing.assert_close(plain.train_epoch(sig, None), loss,
                               rtol=1e-6, atol=0)


def test_bf16_bcsr_training_follows_the_segment_path():
    """Forward and parameter gradients of the threaded model over the
    bf16-tile operator against the f32 segment path: bf16 weights and
    bf16-cast activations in every hop, ~2^-9 relative per product term
    (2e-2 of the scale forward, 3e-2 of each gradient's scale)."""
    g, op, sig = cheb_setup(bf16=True)
    seg = tops.Prenormalized(tops.host_cheb_norm(g))
    torch.manual_seed(2)
    net = TNet(5, K=2, hidden=8)
    results = []
    for operator in (op, seg):
        def step(carry, x, y, g_):
            h, acc = carry
            out, h = net(x, operator, h)
            return (h, acc + mse(out, y)), out

        with config_override(spmm_backend="segment"):
            (_, total), outs = sig.scan(step, (None, torch.zeros(())))
        grads = torch.autograd.grad(total, list(net.parameters()))
        results.append((outs.detach(), grads))
    (out_b, g_b), (out_s, g_s) = results
    assert float((out_b - out_s).abs().max()) <= 2e-2 * float(
        out_s.abs().max())
    for gb, gs in zip(g_b, g_s):
        assert float((gb - gs).abs().max()) <= 3e-2 * float(gs.abs().max())


# ---------------------------------------------------------------------------
# stack_bcsr: dynamic-edge sequences
# ---------------------------------------------------------------------------

SN, SF, ST = 600, 32, 5


def dynamic_graphs(seed=0, n=SN, t=ST):
    """Drifting banded graphs with varying edge counts and ~10% random
    cross edges (as the JAX package's stacked tests use)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(t):
        e = int(n * (6 + 3 * rng.random()))
        s = rng.integers(0, n, size=e)
        r = np.clip(s + rng.integers(-20, 21, size=e), 0, n - 1)
        cross = rng.random(e) < 0.1
        r[cross] = rng.integers(0, n, size=cross.sum())
        w = rng.uniform(0.1, 1.0, e).astype(np.float32)
        ei = np.stack([s, r])
        out.append((jops.Graph.from_edge_index(ei, w, num_nodes=n),
                    tops.Graph.from_edge_index(ei, w, num_nodes=n,
                                               device="cpu")))
    return [p[0] for p in out], [p[1] for p in out]


def test_stack_bcsr_steps_match_the_jax_stacked_scan():
    jgs, tgs = dynamic_graphs()
    jst = jops.stack_bcsr([jops.BCSRMatrix.from_graph(
        g, min_block_edges=16, pack=2) for g in jgs])
    tst = tops.stack_bcsr([tops.BCSRMatrix.from_graph(
        g, min_block_edges=16) for g in tgs])
    assert len(tst) == ST and tst.num_nodes == SN
    assert tst[1] is list(tst)[1]
    assert all(m.fwd.nnzb and m.fwd.num_rem for m in tst)
    x = np.random.default_rng(1).normal(size=(SN, SF)).astype(np.float32)

    @jax.jit
    def scan_all(x0, st):
        def step(h, mat_t):
            return h, jops.bcsr_spmm(mat_t, h, use_pallas=False)

        return jax.lax.scan(step, x0, st)[1]

    want = np.asarray(scan_all(jnp.asarray(x), jst))
    for t, mat_t in enumerate(tst):
        got = tb.bcsr_spmm(mat_t, torch.from_numpy(x)).numpy()
        # f32 sums in another order
        np.testing.assert_allclose(got, want[t],
                                   atol=1e-5 * np.abs(want[t]).max())
        seg = tops.spmm_segment(tgs[t], torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, seg, atol=1e-5 * np.abs(seg).max())


def test_stack_bcsr_gradient_matches_the_jax_stacked_scan():
    jgs, tgs = dynamic_graphs()
    jst = jops.stack_bcsr([jops.BCSRMatrix.from_graph(
        g, min_block_edges=16, pack=2) for g in jgs])
    tst = tops.stack_bcsr([tops.BCSRMatrix.from_graph(
        g, min_block_edges=16) for g in tgs])
    x = np.random.default_rng(3).normal(size=(SN, SF)).astype(np.float32)

    @jax.jit
    def loss_scan(x0, st):
        def step(h, mat_t):
            return jnp.tanh(jops.bcsr_spmm(mat_t, h, use_pallas=False)), None

        return (jax.lax.scan(step, x0, st)[0] ** 2).sum()

    want = np.asarray(jax.grad(loss_scan)(jnp.asarray(x), jst))
    h = x0 = torch.from_numpy(x).requires_grad_()
    for mat_t in tst:
        h = torch.tanh(tb.bcsr_spmm(mat_t, h))
    (got,) = torch.autograd.grad((h ** 2).sum(), x0)
    # five chained aggregations and tanh, f32 sums in another order
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


def test_stack_bcsr_validation():
    _, (g1,) = dynamic_graphs(seed=5, n=128, t=1)
    _, (g2,) = dynamic_graphs(seed=6, n=256, t=1)
    m1 = tops.BCSRMatrix.from_graph(g1)
    with pytest.raises(ValueError, match="at least one"):
        tops.stack_bcsr([])
    with pytest.raises(ValueError, match="num_nodes"):
        tops.stack_bcsr([m1, tops.BCSRMatrix.from_graph(g2)])
    with pytest.raises(ValueError, match="dtype"):
        tops.stack_bcsr([m1, tops.BCSRMatrix.from_graph(
            g1, dtype=torch.bfloat16)])
    _, (g3,) = dynamic_graphs(seed=7, n=300, t=1)
    with pytest.raises(ValueError, match="reordered and plain"):
        tops.stack_bcsr([tops.BCSRMatrix.from_graph(g3),
                         tops.BCSRMatrix.from_graph(g3, reorder="rcm")])
    assert len(tops.stack_bcsr(iter([m1, m1]))) == 2
    # two snapshots of different tile counts, built with the defaults,
    # stack; the JAX package picks them different tiles a TPU grid step
    # and refuses the pair
    jgs, tgs = dynamic_graphs(seed=10, n=600, t=2)
    jmats = [jops.BCSRMatrix.from_graph(g) for g in jgs]
    with pytest.raises(ValueError, match="pack"):
        jops.stack_bcsr(jmats)
    st = tops.stack_bcsr([tops.BCSRMatrix.from_graph(g) for g in tgs])
    assert len(st) == 2 and st[0].fwd.nnzb != st[1].fwd.nnzb
    assert [m.fwd.nnzb for m in st] == [m.fwd.nnzb for m in jmats]


def test_stack_bcsr_gcn_matches_jax_per_step():
    jgs, tgs = dynamic_graphs(seed=8, n=200, t=3)
    jst = jops.stack_bcsr_gcn(jgs, min_block_edges=16, pack=2)
    tst = tops.stack_bcsr_gcn(tgs, min_block_edges=16, device="cpu")
    x = np.random.default_rng(9).normal(size=(200, 8)).astype(np.float32)
    for t, mat_t in enumerate(tst):
        jmat = jax.tree_util.tree_map(lambda a: a[t], jst)
        want = np.asarray(jops.bcsr_spmm(jmat, jnp.asarray(x),
                                         use_pallas=False))
        got = tb.bcsr_spmm(mat_t, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want,
                                   atol=1e-5 * np.abs(want).max())
        ref = tops.spmm_segment(tops.gcn_norm(tgs[t]),
                                torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
