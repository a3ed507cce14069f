"""Port parity of the heterogeneous-graph family against the JAX package:
SAGEConv, HeteroGCLSTM, the six heterogeneous signal classes with
``temporal_signal_split``, ``StackedHeteroSignal`` and the hetero protocol
twin (``protocols/hetero.py`` against ``examples/recurrent/hetero_example.py``).

Inputs are made with numpy from a seed and handed to both packages; flax
parameters (moved off their initial values by 0.05, so a missed transplant
shows) go through ``params_from_flax``.  Tolerances (f32 on the CPU, JAX at
"highest" matmul precision): outputs and carried state 1e-5 absolute,
parameter gradients 1e-4 of each gradient's largest entry, signal arrays
equal (indices exactly, features bit for bit), the hetero protocol's
losses 1e-5 relative.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_temporal_tpu import config_override as j_override
from pytorch_geometric_temporal_tpu import models as jmodels
from pytorch_geometric_temporal_tpu import ops as jops
from pytorch_geometric_temporal_tpu import signal as jsignal
from pytorch_geometric_temporal_tpu_torch import config_override
from pytorch_geometric_temporal_tpu_torch import models as tmodels
from pytorch_geometric_temporal_tpu_torch import ops as tops
from pytorch_geometric_temporal_tpu_torch import signal as tsignal
from pytorch_geometric_temporal_tpu_torch.models import _cells
from pytorch_geometric_temporal_tpu_torch.protocols import hetero as thetero

CPU = dict(device="cpu")
EXAMPLES = Path(__file__).parent.parent / "examples" / "recurrent"

# pin torch to one thread: many tiny ops, a thread pool only spins
torch.set_num_threads(1)


def shifted(variables):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05, variables)


def close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol, err_msg=msg)


def bipartite(rng, n_src, n_dst, e):
    ei = np.stack([rng.integers(0, n_src, e), rng.integers(0, n_dst, e)])
    return ei, rng.uniform(0.2, 1.5, e).astype(np.float32)


def both_graphs(ei, w, n_dst, n_src=None, pad_to=None):
    return (jops.Graph.from_edge_index(ei, w, num_nodes=n_dst,
                                       num_src=n_src, pad_to=pad_to),
            tops.Graph.from_edge_index(ei, w, num_nodes=n_dst,
                                       num_src=n_src, pad_to=pad_to, **CPU))


# --- SAGEConv -------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "segment"])
@pytest.mark.parametrize("kind", ["square", "bipartite"])
def test_sageconv_matches_jax(kind, backend):
    rng = np.random.default_rng(0)
    n_src, n_dst, f_src, f_dst = (15, 15, 5, 5) if kind == "square" else (
        15, 9, 5, 3)
    ei, w = bipartite(rng, n_src, n_dst, 60)
    # a zero in-degree node (the mean divides by 0 there) and padding
    ei[1][ei[1] == 0] = 1
    jg, tg = both_graphs(ei, w, n_dst, None if kind == "square" else n_src,
                         pad_to=64)
    x = rng.normal(size=(2, n_src, f_src)).astype(np.float32)
    x_dst = (None if kind == "square"
             else rng.normal(size=(2, n_dst, f_dst)).astype(np.float32))
    jm = jmodels.SAGEConv(7)
    jx_dst = None if x_dst is None else jnp.asarray(x_dst)
    p = shifted(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg, jx_dst))
    in_ch = f_src if kind == "square" else (f_src, f_dst)
    tm = tmodels.SAGEConv(in_ch, 7, **CPU).params_from_flax(p)
    with j_override(spmm_backend=backend), config_override(
            spmm_backend=backend):
        want = jm.apply(p, jnp.asarray(x), jg, jx_dst)
        got = tm(torch.from_numpy(x), tg,
                 None if x_dst is None else torch.from_numpy(x_dst))
    assert got.shape == (2, n_dst, 7)
    close(got, want)
    assert float(got[:, 0].detach().abs().max()) > 0  # lin_r alone at degree 0


# --- HeteroGCLSTM ---------------------------------------------------------

METADATA = (["a", "b"], [("a", "to", "b"), ("b", "to", "a"),
                         ("a", "near", "a")])
SIZES = {"a": (11, 4), "b": (7, 3)}


def hetero_inputs(rng, missing):
    """x_dicts for two steps and both packages' edge graphs; ``missing``
    drops ("b", "to", "a") and ("a", "near", "a"), so "a" is the
    destination of no edge type."""
    graphs_j, graphs_t = {}, {}
    for et in METADATA[1]:
        if missing and et != ("a", "to", "b"):
            continue
        src, _, dst = et
        ei, w = bipartite(rng, SIZES[src][0], SIZES[dst][0], 30)
        graphs_j[et], graphs_t[et] = both_graphs(
            ei, w, SIZES[dst][0], SIZES[src][0], pad_to=32)
    xs = [{nt: rng.normal(size=(n, f)).astype(np.float32)
           for nt, (n, f) in SIZES.items()} for _ in range(2)]
    return xs, graphs_j, graphs_t


@pytest.mark.parametrize("missing", [False, True])
def test_heterogclstm_matches_jax(missing):
    rng = np.random.default_rng(1)
    xs, gj, gt = hetero_inputs(rng, missing)
    in_ch = {nt: f for nt, (_, f) in SIZES.items()}
    jm = jmodels.HeteroGCLSTM(in_ch, 6, METADATA)
    jx = [{k: jnp.asarray(v) for k, v in x.items()} for x in xs]
    p = shifted(jax.jit(jm.init)(jax.random.PRNGKey(0), jx[0], gj))
    tm = tmodels.HeteroGCLSTM(in_ch, 6, METADATA, **CPU).params_from_flax(p)
    n_convs = 4 * (1 if missing else 3)
    assert sum(name.startswith("conv_") for name in tm._modules) == n_convs

    def jrun(params):
        h, c = jm.apply(params, jx[0], gj)
        h, c = jm.apply(params, jx[1], gj, h, c)
        loss = sum(jnp.sum(h[k] ** 2) + jnp.sum(jnp.sin(c[k])) for k in h)
        return loss, (h, c)

    (jloss, (jh, jc)), jgrads = jax.jit(
        jax.value_and_grad(jrun, has_aux=True))(p)
    tx = [{k: torch.from_numpy(v) for k, v in x.items()} for x in xs]
    h, c = tm(tx[0], gt)
    h, c = tm(tx[1], gt, h, c)
    for nt in SIZES:
        close(h[nt], jh[nt], msg=f"h[{nt}]")
        close(c[nt], jc[nt], msg=f"c[{nt}]")
    loss = sum(h[k].square().sum() + c[k].sin().sum() for k in h)
    loss.backward()
    flat = _cells._flatten(jax.tree_util.tree_map(np.asarray,
                                                  jgrads)["params"])
    named = dict(tm.named_parameters())
    assert set(named) == set(flat)
    for name, prm in named.items():
        want = flat[name]
        np.testing.assert_allclose(
            prm.grad.numpy(), want, rtol=0,
            atol=1e-4 * max(float(np.abs(want).max()), 1e-30),
            err_msg=name)


def test_heterogclstm_refuses_an_edge_type_its_params_lack():
    rng = np.random.default_rng(2)
    xs, gj, gt = hetero_inputs(rng, True)
    in_ch = {nt: f for nt, (_, f) in SIZES.items()}
    jm = jmodels.HeteroGCLSTM(in_ch, 6, METADATA)
    p = jm.init(jax.random.PRNGKey(0),
                {k: jnp.asarray(v) for k, v in xs[0].items()}, gj)
    tm = tmodels.HeteroGCLSTM(in_ch, 6, METADATA, **CPU).params_from_flax(p)
    _, full = hetero_inputs(np.random.default_rng(3), False)[1:]
    with pytest.raises(KeyError, match="b__to__a"):
        tm({k: torch.from_numpy(v) for k, v in xs[0].items()}, full)


# --- the six hetero signal classes ---------------------------------------

T = 5
EDGE_TYPES = [("a", "to", "b"), ("b", "to", "a"), ("a", "to", "c")]
NODES = {"a": 6, "b": 4}        # "c" has no features: counted from edges


def signal_inputs(seed=0):
    rng = np.random.default_rng(seed)

    def edges(e_max):
        out, weights = {}, {}
        for src, rel, dst in EDGE_TYPES:
            n_src = NODES.get(src, 3)
            n_dst = NODES.get(dst, 3)
            e = int(rng.integers(2, e_max))
            out[(src, rel, dst)] = np.stack([rng.integers(0, n_src, e),
                                             rng.integers(0, n_dst, e)])
            weights[(src, rel, dst)] = rng.uniform(0.1, 1, e)
        weights[("a", "to", "c")] = None     # None entries are skipped
        return out, weights

    ei, ew = edges(9)
    eis, ews = zip(*(edges(9) for _ in range(T)))
    feats = [{nt: rng.normal(size=(n, 2)) for nt, n in NODES.items()}
             for _ in range(T)]
    for f in feats[1:3]:
        f["b"] = None
    targs = [{"a": rng.normal(size=NODES["a"]),
              "b": rng.integers(0, 3, NODES["b"])} for _ in range(T)]
    batch = {"a": np.arange(NODES["a"]) % 2, "b": np.zeros(NODES["b"], int)}
    batches = [{k: (v + t) % 3 for k, v in batch.items()} for t in range(T)]
    extra = [{"a": rng.normal(size=(NODES["a"], 1))} for _ in range(T)]
    return dict(ei=ei, ew=ew, eis=list(eis), ews=list(ews), feats=feats,
                feat=feats[0], targs=targs, batch=batch, batches=batches,
                extra=extra)


SIGNALS = {
    "StaticHeteroGraphTemporalSignal": ("ei", "ew", "feats", "targs"),
    "DynamicHeteroGraphTemporalSignal": ("eis", "ews", "feats", "targs"),
    "DynamicHeteroGraphStaticSignal": ("eis", "ews", "feat", "targs"),
    "StaticHeteroGraphTemporalSignalBatch": ("ei", "ew", "feats", "targs",
                                             "batch"),
    "DynamicHeteroGraphTemporalSignalBatch": ("eis", "ews", "feats", "targs",
                                              "batches"),
    "DynamicHeteroGraphStaticSignalBatch": ("eis", "ews", "feat", "targs",
                                            "batches"),
}


def same_dict(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, (what, k)
        if w.dtype.kind in "iu":
            assert g.dtype == np.int64, (what, k)
        else:
            assert g.dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}[{k}]")


def same_snapshot(ts, js):
    same_dict(ts.x_dict, js.x_dict, "x_dict")
    same_dict(ts.y_dict, js.y_dict, "y_dict")
    same_dict(ts.batch_dict, js.batch_dict, "batch_dict")
    assert set(ts.additional) == set(js.additional)
    for key in js.additional:
        same_dict(ts.additional[key], js.additional[key], key)
    assert set(ts.edge_graphs) == set(js.edge_graphs)
    for k, jg in js.edge_graphs.items():
        tg = ts.edge_graphs[k]
        assert (tg.num_nodes, tg.num_edges, tg.num_src) == (
            jg.num_nodes, jg.num_edges, jg.num_src), k
        for field in ("senders", "receivers", "weights"):
            np.testing.assert_array_equal(getattr(tg, field).numpy(),
                                          np.asarray(getattr(jg, field)))
    same_dict(ts.edge_index_dict, js.edge_index_dict, "edge_index_dict")
    same_dict(ts.edge_weight_dict, js.edge_weight_dict, "edge_weight_dict")


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_hetero_signal_matches_jax(name):
    d = signal_inputs()
    args = [d[k] for k in SIGNALS[name]]
    js = getattr(jsignal, name)(*args, extra=d["extra"])
    ts = getattr(tsignal, name)(*args, extra=d["extra"], **CPU)
    assert ts.snapshot_count == js.snapshot_count == T
    assert ts._node_counts == js._node_counts == {"a": 6, "b": 4, "c": 3}
    assert ts._edge_pads == js._edge_pads
    for t in range(T):
        same_snapshot(ts[t], js[t])
    assert ts[2].edge_graphs is ts[2].edge_graphs  # cached per step
    for (tt, jt) in zip(tsignal.temporal_signal_split(ts, 0.6),
                        jsignal.temporal_signal_split(js, 0.6)):
        assert tt.snapshot_count == jt.snapshot_count
        for t_snap, j_snap in zip(tt, jt):
            same_snapshot(t_snap, j_snap)


# --- StackedHeteroSignal ----------------------------------------------------


def stackable(dynamic, batch, seed=4):
    rng = np.random.default_rng(seed)
    n = {"a": 6, "b": 4}
    types = [("a", "to", "b"), ("b", "to", "a")]

    def edges():
        ei = {}
        for src, rel, dst in types:
            e = int(rng.integers(3, 9))
            ei[(src, rel, dst)] = np.stack([rng.integers(0, n[src], e),
                                            rng.integers(0, n[dst], e)])
        return ei, {k: rng.uniform(0.1, 1, v.shape[1])
                    for k, v in ei.items()}

    feats = [{k: rng.normal(size=(v, 3)) for k, v in n.items()}
             for _ in range(T)]
    targs = [{k: rng.normal(size=v) for k, v in n.items()} for _ in range(T)]
    bvec = [{k: (np.arange(v) + t) % 2 for k, v in n.items()}
            for t in range(T)]
    if dynamic:
        eis, ews = zip(*(edges() for _ in range(T)))
        args = [list(eis), list(ews), feats, targs]
        name = "DynamicHeteroGraphTemporalSignal"
        if batch:
            args.append(bvec)
    else:
        ei, ew = edges()
        args = [ei, ew, feats, targs]
        name = "StaticHeteroGraphTemporalSignal"
        if batch:
            args.append(bvec[0])
    if batch:
        name += "Batch"
    return (jsignal.StackedHeteroSignal.from_signal(
                getattr(jsignal, name)(*args)),
            tsignal.StackedHeteroSignal.from_signal(
                getattr(tsignal, name)(*args, **CPU)))


@pytest.mark.parametrize("dynamic,batch", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_stacked_hetero_scan_matches_jax(dynamic, batch):
    jst, tst = stackable(dynamic, batch)
    assert tst.edge_meta == jst.edge_meta
    assert tst.snapshot_count == jst.snapshot_count == T

    def body(lib, spmm):
        def step(carry, xd, yd, graphs, *bd):
            agg = {dst: spmm(g, xd[src]) for (src, _, dst), g in
                   graphs.items()}
            out = {k: agg[k].sum(-1) + yd[k] for k in agg}
            if bd:
                out = {k: v + bd[0][k] for k, v in out.items()}
            return carry + sum(v.sum() for v in out.values()), out
        return step

    jcarry, jouts = jst.scan(body(jnp, lambda g, x: jops.spmm(
        g, x, backend="segment")), jnp.float32(0))
    tcarry, touts = tst.scan(body(torch, lambda g, x: tops.spmm(
        g, x, backend="segment")), torch.zeros(()))
    close(tcarry, jcarry, 1e-4)
    for k in jouts:
        assert touts[k].shape == jouts[k].shape
        close(touts[k], jouts[k])


# --- the hetero protocol twin ----------------------------------------------


def _load_example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hetero_protocol_matches_jax_example():
    ex = _load_example("hetero_example")
    epochs = 3
    # the example's own pieces and epoch, stopped after ``epochs``
    sig = ex.make_signal(np.random.default_rng(0))
    train_sig, _ = jsignal.temporal_signal_split(sig, 0.8)
    model = ex.HeteroRegressor(thetero.METADATA, thetero.IN_CHANNELS)
    snap0 = train_sig[0]
    params = jax.jit(model.init)(jax.random.PRNGKey(0), snap0.x_dict,
                                 snap0.edge_graphs)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    snaps = list(train_sig)

    # the example jits the whole epoch; one jitted cell per snapshot
    # computes the same and compiles in a fraction of the time
    apply = jax.jit(model.apply)

    def epoch(params, opt_state):
        def loss_fn(p):
            total, h, c = 0.0, None, None
            for snap in snaps:
                preds, h, c = apply(p, snap.x_dict, snap.edge_graphs, h, c)
                total = total + sum(jnp.mean((preds[k] - snap.y_dict[k]) ** 2)
                                    for k in preds)
            return total / len(snaps)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    want = []
    for _ in range(epochs):
        params_next, opt_state, loss = epoch(params, opt_state)
        if not want:
            params0 = params
        params = params_next
        want.append(float(loss))
    got, test_loss = thetero.main(
        epochs, params=jax.tree_util.tree_map(np.asarray, params0),
        log=lambda *a: None, **CPU)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0] and np.isfinite(test_loss)
