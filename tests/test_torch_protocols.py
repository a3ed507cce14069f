"""The eight bundled-data accuracy protocols of the port against the JAX
package's, three epochs each on the bundled data on the CPU.

The flax nets below are those of ``benchmarks/bundled_accuracy.py`` (cell +
ReLU + ``Dense(hidden -> 1)``, same names); each is initialized from
``PRNGKey(0)``, its parameters are transplanted into the port's run
(``params=``), and both sides train with Adam(1e-2) on the mean snapshot
MSE, one update an epoch.  The training loss of every epoch and the test
MSE agree within 1e-4 relative (f32; three Adam steps from equal
parameters).

Run as a script from the root of the repo, ``JAX_PLATFORMS=cpu PYTHONPATH=.
python tests/test_torch_protocols.py [names...]``, it
trains every protocol for its full epoch count on the CPU and prints the
test MSE of the JAX package from ``PRNGKey(0)`` to ``PRNGKey(3)``, of the
port from ``PRNGKey(0)``'s parameters, and of the port from its own seeds 0
to 3 — how far the initial draw alone moves each number.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_geometric_temporal_tpu import data as jdata
from pytorch_geometric_temporal_tpu import models as jmodels
from pytorch_geometric_temporal_tpu import signal as jsig
from pytorch_geometric_temporal_tpu import train as jtrain
from pytorch_geometric_temporal_tpu.ops.graph import Graph as JGraph
from pytorch_geometric_temporal_tpu_torch.protocols import (
    RUNS, ProtocolRun, bundled_accuracy)

EPOCHS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of tiny CPU ops: a thread pool only adds spinning when
    several test processes share the cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def head(h):
    return fnn.Dense(1, name="linear")(fnn.relu(h))[..., 0]


class DCRNNNet(fnn.Module):
    hidden: int

    @fnn.compact
    def __call__(self, x, graph):
        return head(jmodels.DCRNN(self.hidden, K=1, name="recurrent")(
            x, graph))


class TGCNNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, graph, h):
        h = jmodels.TGCN(32, name="recurrent")(x, graph, h)
        return head(h), h


class A3TGCNNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, graph):
        return head(jmodels.A3TGCN(32, periods=4, name="recurrent")(
            x[:, None, :], graph))


class OSeqNet(fnn.Module):
    f: int

    @fnn.compact
    def __call__(self, xs, g):
        return head(jmodels.EvolveGCNOSeq(self.f, name="recurrent")(xs, g))


class HSeqNet(fnn.Module):
    n: int
    f: int

    @fnn.compact
    def __call__(self, xs, g):
        return head(jmodels.EvolveGCNHSeq(self.n, self.f,
                                          name="recurrent")(xs, g))


class DygraeNet(fnn.Module):
    f: int

    @fnn.compact
    def __call__(self, x, graph, h, c):
        h_tilde, h, c = jmodels.DyGrEncoder(
            self.f, 1, "mean", 32, 1, name="recurrent")(x, graph, h, c)
        return head(h_tilde), h, c


class BusNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, graph):
        return head(jmodels.GConvGRU(32, K=1, name="recurrent")(x, graph))


def signals(dataset):
    train, test = jsig.temporal_signal_split(dataset, 0.2)
    return (jsig.StackedSignal.from_signal(train),
            jsig.StackedSignal.from_signal(test))


def jax_snapshots(model, params, loss_fn, train, test, carry=(),
                  epochs=EPOCHS):
    trainer = jtrain.SnapshotTrainer(loss_fn, optax.adam(1e-2))
    state, losses = trainer.init(params), []
    for _ in range(epochs):
        params, state, loss = trainer.train_epoch(params, state, train,
                                                  carry)
        losses.append(float(loss))
    return losses, float(trainer.evaluate(params, test, carry))


def jax_sequence(model, params, train, test, epochs=EPOCHS):
    def gstack(sig):
        return JGraph(sig.senders, sig.receivers, sig.weights,
                      sig.num_nodes, sig.num_edges)

    def loss_fn(p, sig_x, sig_y, g):
        return jnp.mean((model.apply(p, sig_x, g) - sig_y) ** 2)

    opt = optax.adam(1e-2)
    step = jax.jit(jax.value_and_grad(loss_fn))
    state, losses = opt.init(params), []
    for _ in range(epochs):
        loss, grads = step(params, train.features, train.targets,
                           gstack(train))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, float(loss_fn(params, test.features, test.targets,
                                 gstack(test)))


def stateless(model, dataset, epochs, key, t=None):
    train, test = signals(dataset)
    params = model.init(jax.random.PRNGKey(key), train.features[0],
                        train.graph(t))

    def loss_fn(p, carry, x, y, g):
        return jtrain.mse(model.apply(p, x, g), y), carry

    return params, jax_snapshots(model, params, loss_fn, train, test,
                                 epochs=epochs)


def jax_run(name, epochs=EPOCHS, key=0):
    """(initial flax params from ``PRNGKey(key)``, (losses, test MSE)) of
    the JAX package."""
    if name == "pedalme_dcrnn":
        return stateless(DCRNNNet(32),
                         jdata.PedalMeDatasetLoader().get_dataset(lags=4),
                         epochs, key)
    if name == "pedalme_a3tgcn":
        return stateless(A3TGCNNet(),
                         jdata.PedalMeDatasetLoader().get_dataset(lags=4),
                         epochs, key)
    if name == "englandcovid_dcrnn":
        return stateless(
            DCRNNNet(16),
            jdata.EnglandCovidDatasetLoader().get_dataset(lags=8), epochs,
            key, t=0)
    if name == "montevideobus_gconvgru":
        return stateless(
            BusNet(), jdata.MontevideoBusDatasetLoader().get_dataset(lags=4),
            epochs, key)
    if name == "pedalme_tgcn":
        train, test = signals(
            jdata.PedalMeDatasetLoader().get_dataset(lags=4))
        model, h0 = TGCNNet(), jnp.zeros((train.num_nodes, 32))
        params = model.init(jax.random.PRNGKey(key), train.features[0],
                            train.graph(), h0)

        def loss_fn(p, carry, x, y, g):
            pred, carry = model.apply(p, x, g, carry)
            return jtrain.mse(pred, y), carry

        return params, jax_snapshots(model, params, loss_fn, train, test, h0,
                                     epochs)
    train, test = signals(
        jdata.TwitterTennisDatasetLoader(event_id="rg17").get_dataset())
    n, f = train.features.shape[1:]
    if name == "twittertennis_dygrae":
        model, zero = DygraeNet(f), jnp.zeros((n, 32))
        params = model.init(jax.random.PRNGKey(key), train.features[0],
                            train.graph(0), zero, zero)

        def loss_fn(p, carry, x, y, g):
            pred, h, c = model.apply(p, x, g, *carry)
            return jtrain.mse(pred, y), (h, c)

        return params, jax_snapshots(model, params, loss_fn, train, test,
                                     (zero, zero), epochs)
    model = (OSeqNet(f) if name == "twittertennis_evolvegcno"
             else HSeqNet(n, f))
    params = model.init(jax.random.PRNGKey(key), train.features, JGraph(
        train.senders, train.receivers, train.weights, train.num_nodes,
        train.num_edges))
    return params, jax_sequence(model, params, train, test, epochs)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_protocol_matches_jax_over_three_epochs(name):
    params, (want_losses, want_mse) = jax_run(name)
    got = RUNS[name](EPOCHS, device="cpu",
                     params=jax.tree_util.tree_map(np.asarray, params))
    assert isinstance(got, ProtocolRun) and len(got.losses) == EPOCHS
    np.testing.assert_allclose(got.losses, want_losses, rtol=1e-4)
    np.testing.assert_allclose(got.test_mse, want_mse, rtol=1e-4)
    assert got.losses[-1] < got.losses[0] and got.seconds > 0


def test_public_functions_name_the_jax_packages_keys():
    out = bundled_accuracy.pedalme_accuracy(2, 1, device="cpu")
    assert set(out) == {"pedalme_dcrnn_test_mse", "pedalme_tgcn_test_mse",
                        "pedalme_a3tgcn_test_mse"}
    out.update(bundled_accuracy.twitter_tennis_accuracy(1, device="cpu"))
    out.update(bundled_accuracy.extra_bundled_accuracy(1, 1, device="cpu"))
    assert set(out) == {f"{name}_test_mse" for name in RUNS}
    assert all(np.isfinite(v) for v in out.values())


def test_seeded_runs_are_reproducible():
    a = RUNS["pedalme_a3tgcn"](2, device="cpu", seed=3)
    b = RUNS["pedalme_a3tgcn"](2, device="cpu", seed=3)
    c = RUNS["pedalme_a3tgcn"](2, device="cpu", seed=4)
    assert a.losses == b.losses and a.test_mse == b.test_mse
    assert a.losses != c.losses


FULL_EPOCHS = {
    "pedalme_dcrnn": 200, "pedalme_tgcn": 50, "pedalme_a3tgcn": 50,
    "twittertennis_evolvegcno": 200, "twittertennis_evolvegcnh": 200,
    "twittertennis_dygrae": 200, "englandcovid_dcrnn": 100,
    "montevideobus_gconvgru": 50}


def full_epoch_spread(names):
    import torch

    torch.set_num_threads(2)
    jax.config.update("jax_default_matmul_precision", "highest")
    for name in names or FULL_EPOCHS:
        epochs = FULL_EPOCHS[name]
        params, (_, jax_mse) = jax_run(name, epochs)
        keys = [jax_mse] + [jax_run(name, epochs, k)[1][1]
                            for k in range(1, 4)]
        same = RUNS[name](epochs, device="cpu", params=jax.tree_util.tree_map(
            np.asarray, params)).test_mse
        seeds = [RUNS[name](epochs, device="cpu", seed=s).test_mse
                 for s in range(4)]
        print(f"{name}: {epochs} epochs on the CPU; test MSE JAX package "
              f"PRNGKey(0)-(3) {' '.join('%.4f' % v for v in keys)}; port "
              f"from PRNGKey(0)'s parameters {same:.4f}; port seeds 0-3 "
              f"{' '.join('%.4f' % v for v in seeds)}", flush=True)


if __name__ == "__main__":
    import sys

    full_epoch_spread(sys.argv[1:])
