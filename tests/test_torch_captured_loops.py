"""The training loops the JAX side compiles, on the CPU: the METR-LA
protocol, the full-sequence bundled protocols, the harness's epoch and
MTGNN's dropout step.

On the card each runs as replays of CUDA graphs (``capture=None``); here,
on the CPU, ``capture=True`` raises for every entry point, ``capture=None``
runs eagerly and gives ``capture=False``'s numbers, and each loop's new
step function gives the numbers of the loop it replaced (kept below as
``_old_*``) to the bit: the CPU Adam and the operations are the same.  The
card's side, captured against eager, is in ``tests/test_torch_cuda.py``.
"""

import copy

import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq, MTGNN
from pytorch_geometric_temporal_tpu_torch.ops import Graph
from pytorch_geometric_temporal_tpu_torch.protocols import (
    RUNS, bundled_accuracy, harness, metrla_protocol as mp)
from pytorch_geometric_temporal_tpu_torch.signal import DeviceWindower
from pytorch_geometric_temporal_tpu_torch.train import (
    BatchTrainer, TrainState, apply_gradients, mse)
from pytorch_geometric_temporal_tpu_torch.train.trainer import _adam

torch.set_num_threads(1)    # thousands of tiny ops: a thread pool only spins

CPU_ONLY = "capture=True needs a CUDA trainer"
SEQUENCE_RUNS = ["twittertennis_evolvegcno", "twittertennis_evolvegcnh"]


def _params_equal(a, b):
    pa, pb = list(a.parameters()), list(b.parameters())
    return len(pa) == len(pb) and all(map(torch.equal, pa, pb))


# ---------------------------------------------------------------------------
# METR-LA
# ---------------------------------------------------------------------------


def _metrla_case(epochs=2, t_len=288, n=48):
    (data, ei, w, means, stds, _), schedule, test_idx = mp._split(
        epochs, 0, t_len, n)
    return (data, ei, w, means, stds, schedule, test_idx)


def _old_metrla_train(data, ei, w, means, stds, schedule, test_idx,
                      batch_size, K):
    """The protocol's loop before it went through BatchTrainer."""
    n, f = data.shape[1], data.shape[2]
    g = Graph.from_edge_index(ei, np.asarray(w, np.float32), num_nodes=n,
                              device="cpu")
    std = torch.as_tensor(np.asarray(stds, np.float32))
    m32, s32 = np.asarray(means, np.float32), np.asarray(stds, np.float32)
    norm0 = torch.as_tensor((np.float32(0.0) - m32) / s32)
    model = DCRNNSeq(f, f, K, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    windows = DeviceWindower(data, mp.IN_T, device="cpu")

    def loss_fn(x, y):
        pred = model(x, g)
        mask = (y != norm0).to(torch.float32)
        mask = mask / torch.clamp(mask.mean(), min=1e-16)
        return torch.nan_to_num(torch.abs(pred - y) * std * mask).mean()

    optimizer = _adam(model, 1e-3)
    curve = []
    for epoch_batches in schedule:
        for i in range(0, len(epoch_batches) - batch_size + 1, batch_size):
            x, y = windows(epoch_batches[i: i + batch_size])
            optimizer.zero_grad(set_to_none=True)
            last = loss_fn(x, y)
            last.backward()
            optimizer.step()
        curve.append(last.detach())
    with torch.no_grad():
        maes = [loss_fn(*windows(test_idx[i: i + batch_size]))
                for i in range(0, len(test_idx) - batch_size + 1, batch_size)]
    return float(torch.stack(maes).mean()), [float(v) for v in curve], model


def test_metrla_train_gives_the_old_loops_numbers_to_the_bit():
    case = _metrla_case()
    mae_old, curve_old, model_old = _old_metrla_train(*case, 32, 3)
    mae, curve, model = mp.train(*case, 32, 3, device="cpu")
    assert curve == curve_old and mae == mae_old
    assert _params_equal(model, model_old)


def test_metrla_capture_switch_on_the_cpu():
    case = _metrla_case(epochs=1, t_len=120, n=12)
    with pytest.raises(ValueError, match=CPU_ONLY):
        mp.train(*case, 16, 2, device="cpu", capture=True)
    with pytest.raises(ValueError, match=CPU_ONLY):
        mp.run(epochs=1, batch_size=16, t_len=120, n=12, device="cpu",
               capture=True)
    eager = mp.run(epochs=2, batch_size=16, t_len=120, n=12, device="cpu",
                   capture=False)
    default = mp.run(epochs=2, batch_size=16, t_len=120, n=12, device="cpu")
    for rec in (eager, default):
        assert (rec["cuda_graphs"], rec["replays"]) == (0, 0)
    for key in ("train_curve", "test_masked_mae_denorm"):
        assert default[key] == eager[key]


def test_metrla_split_is_runs_split():
    series, schedule, test_idx = mp._split(3, 5, 200, 10)
    data = mp.load_series(seed=5, t=200, n=10)[0]
    idx = mp._windows(data)
    n_train, n_val = int(0.7 * len(idx)), int(0.1 * len(idx))
    np.testing.assert_array_equal(series[0], data)
    np.testing.assert_array_equal(test_idx, idx[n_train + n_val:])
    rng = np.random.default_rng(6)
    for got in schedule:
        np.testing.assert_array_equal(got, rng.permutation(idx[:n_train]))


# ---------------------------------------------------------------------------
# The bundled protocols: the full-sequence update and the snapshot loop
# ---------------------------------------------------------------------------


def _old_fit_sequence(net, train, test, epochs):
    """``_fit_sequence``'s loop before it went through BatchTrainer."""
    optimizer = _adam(net, bundled_accuracy.LR)
    graph, losses = bundled_accuracy._stacked_graph(train), []
    for _ in range(epochs):
        optimizer.zero_grad(set_to_none=True)
        loss = mse(net(train.features, graph), train.targets)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    with torch.no_grad():
        test_mse = mse(net(test.features,
                           bundled_accuracy._stacked_graph(test)),
                       test.targets)
    return float(test_mse), [float(v) for v in losses]


@pytest.mark.parametrize("name", SEQUENCE_RUNS)
def test_fit_sequence_gives_the_old_loops_numbers_to_the_bit(name,
                                                              monkeypatch):
    old = {}

    def record(net, train, test, epochs, device, capture=None):
        # the old loop trains a copy of the run's freshly drawn net
        twin = copy.deepcopy(net)
        old["run"] = _old_fit_sequence(twin, train, test, epochs), twin
        return fit(net, train, test, epochs, device, capture)

    fit = bundled_accuracy._fit_sequence
    monkeypatch.setattr(bundled_accuracy, "_fit_sequence", record)
    got = RUNS[name](3, device="cpu")
    (test_mse, losses), twin = old["run"]
    assert got.losses == losses and got.test_mse == test_mse
    assert _params_equal(got.model, twin)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_every_run_refuses_capture_on_the_cpu(name):
    with pytest.raises(ValueError, match=CPU_ONLY):
        RUNS[name](1, device="cpu", capture=True)


@pytest.mark.parametrize("name", SEQUENCE_RUNS + ["pedalme_dcrnn"])
def test_runs_capture_none_equals_capture_false_on_the_cpu(name):
    eager = RUNS[name](2, device="cpu", capture=False)
    default = RUNS[name](2, device="cpu")
    assert default.losses == eager.losses
    assert default.test_mse == eager.test_mse
    assert _params_equal(default.model, eager.model)
    for run in (eager, default):
        assert (run.captures, run.replays) == (0, 0)


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


def _old_harness_epochs(epochs):
    """The harness's epoch and validation pass as plain loops (no guard,
    no checkpoint): (train MSE, validation MSE) an epoch."""
    from pytorch_geometric_temporal_tpu_torch.models import DCRNN

    train, val = harness.chickenpox(device="cpu")
    graph = train.graph()
    gen = torch.Generator().manual_seed(0)
    model = bundled_accuracy._Net(
        DCRNN(harness.LAGS, harness.FILTERS, K=1, device="cpu",
              generator=gen), harness.FILTERS, "cpu", gen)
    state = TrainState.create(model, _adam(model, harness.LR))

    def predict(x):
        return model.head(model.recurrent(x, graph))

    out = []
    for _ in range(epochs):
        total = torch.zeros(())
        for t in range(train.snapshot_count):
            loss = mse(predict(train.features[t]), train.targets[t])
            apply_gradients(state, torch.autograd.grad(
                loss, list(model.parameters())))
            total = total + loss.detach()
        with torch.no_grad():
            v = sum((mse(predict(val.features[t]), val.targets[t])
                     for t in range(val.snapshot_count)), torch.zeros(()))
        out.append((float(total / train.snapshot_count),
                    float(v / val.snapshot_count)))
    return out


def test_harness_gives_the_old_loops_numbers_to_the_bit(tmp_path):
    lines = []
    _, hist = harness.main(2, ckpt_dir=str(tmp_path), device="cpu",
                           log=lines.append)
    assert [(h["train_mse"], h["val_mse"]) for h in hist] == (
        _old_harness_epochs(2))
    assert lines[-1] == "0 CUDA graphs captured, 0 replays"


def test_harness_capture_switch_on_the_cpu(tmp_path):
    quiet = dict(device="cpu", log=lambda *a: None)
    with pytest.raises(ValueError, match=CPU_ONLY):
        harness.main(1, ckpt_dir=str(tmp_path / "t"), capture=True, **quiet)
    _, eager = harness.main(2, ckpt_dir=str(tmp_path / "f"), capture=False,
                            **quiet)
    _, default = harness.main(2, ckpt_dir=str(tmp_path / "n"), **quiet)
    assert default == eager and len(eager) == 2


# ---------------------------------------------------------------------------
# MTGNN's dropout step: a generator made once, handed to the trainer
# ---------------------------------------------------------------------------


def _mtgnn(n=20, t=24):
    return MTGNN(True, True, 2, n, [2, 3, 6, 7], 7, 0.3, 5, 16, 2, 8, 8, 16,
                 32, t, 2, 12, 3, 0.05, 3.0, True, device="cpu",
                 generator=torch.Generator().manual_seed(0))


def _mtgnn_batch(n=20, t=24):
    rng = np.random.default_rng(25)
    return (torch.from_numpy(rng.normal(size=(4, 2, n, t)).astype(
        np.float32)),
        torch.from_numpy(rng.normal(size=(4, 12, n, 1)).astype(np.float32)))


def _mtgnn_steps(capture, steps=3, seed=7):
    x, y = _mtgnn_batch()
    model, gen = _mtgnn(), torch.Generator()
    kw = {} if capture == "plain" else dict(capture=capture)
    if capture == "plain":
        optimizer = _adam(model, 1e-3)
    else:
        trainer = BatchTrainer(model, lambda xb: model(
            xb, train=True, generator=gen), lr=1e-3, loss_fn=mse,
            device="cpu", generators=(gen,), **kw)
    losses = []
    for _ in range(steps):
        gen.manual_seed(seed)
        if capture == "plain":
            optimizer.zero_grad(set_to_none=True)
            loss = mse(model(x, train=True, generator=gen), y)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        else:
            losses.append(trainer.train_step(x, y))
    return torch.stack(losses), model


def test_mtgnn_step_with_its_generator_gives_the_plain_loops_numbers():
    plain, m_plain = _mtgnn_steps("plain")
    for capture in (None, False):
        got, m = _mtgnn_steps(capture)
        assert torch.equal(got, plain) and _params_equal(m, m_plain)
    other, _ = _mtgnn_steps(None, seed=8)
    assert not torch.equal(other, plain)


def test_mtgnn_step_refuses_capture_on_the_cpu():
    model, gen = _mtgnn(), torch.Generator()
    with pytest.raises(ValueError, match=CPU_ONLY):
        BatchTrainer(model, lambda xb: model(xb, train=True, generator=gen),
                     device="cpu", capture=True, generators=(gen,))


# ---------------------------------------------------------------------------
# Degrees: the CPU keeps index_add_'s sum
# ---------------------------------------------------------------------------


def test_degrees_on_the_cpu_are_index_add_sums():
    rng = np.random.default_rng(3)
    ei = rng.integers(0, 300, size=(2, 20_000))
    w = rng.uniform(0.1, 1.0, 20_000).astype(np.float32)
    g = Graph.from_edge_index(ei, w, num_nodes=300, device="cpu")
    for got, index in ((g.out_degree(), g.senders),
                       (g.in_degree(), g.receivers)):
        want = torch.zeros(300).index_add_(0, index, g.masked_weights())
        assert torch.equal(got, want)
    assert torch.equal(g.in_degree(weighted=False), torch.from_numpy(
        np.bincount(ei[1], minlength=300).astype(np.float32)))
