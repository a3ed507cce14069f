"""The plain reference (``perfbench/reference``) against the port on the
CPU at a small size: forward, loss and gradients, the σ-scrambled graph,
and one data-parallel step over four gloo ranks against the global batch."""

import time

import numpy as np
import pytest
import torch

from perfbench import traffic
from perfbench.reference import dcrnn as ref
from perfbench.tests._tiny import tiny_cell

NAMES = {"cell.w_zr": "w_zr", "cell.b_zr": "b_zr", "cell.w_h": "w_h",
         "cell.b_h": "b_h"}


def _setup(name, num_nodes, seed=3, scramble=None, windows=6):
    cell = tiny_cell(name, num_nodes=num_nodes)
    if scramble is not None:
        cell.traffic["scramble_ids"] = scramble
    inputs = traffic.make(cell.config, cell.traffic, seed, "cpu")
    lags = cell.config["recipe"]["seq_len"]
    series = torch.from_numpy(inputs.series)
    x, y = ref.windows(series, inputs.starts[0][:windows], lags)
    return cell, inputs, x, y


def _port(cell, inputs, x, y):
    """The port's DCRNNSeq (and readout) on (x, y): outputs, masked-MAE
    loss and parameter gradients, by the reference's names."""
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.models._cells import Dense
    from pytorch_geometric_temporal_tpu_torch.ops import Graph
    from pytorch_geometric_temporal_tpu_torch.train import (
        ZScoreScaler, masked_mae_loss)

    m = cell.config["model"]
    gen = torch.Generator().manual_seed(0)
    seq = DCRNNSeq(m["input_dim"], m["rnn_units"], m["basis_terms"],
                   device="cpu", generator=gen)
    readout = (Dense(m["rnn_units"], m["output_dim"], device="cpu",
                     generator=gen) if m.get("output_dim") else None)
    g = Graph.from_edge_index(np.stack([inputs.senders, inputs.receivers]),
                              inputs.weights, num_nodes=inputs.num_nodes,
                              device="cpu")
    scaler = ZScoreScaler(mean=torch.from_numpy(inputs.means),
                          std=torch.from_numpy(inputs.stds))
    out = seq(x, g)
    if readout is not None:
        out = readout(out)
    k = ref.out_dim(m)
    part = ZScoreScaler(mean=scaler.mean[:k], std=scaler.std[:k])
    loss = masked_mae_loss(part.inverse(out), part.inverse(y[..., :k]))
    loss.backward()
    names = dict(NAMES, **{"kernel": "w_out", "bias": "b_out"})
    params, grads = {}, {}
    for mod, prefix in ((seq, ""), (readout, "")):
        if mod is None:
            continue
        for n, p in mod.named_parameters():
            key = names[n if n in names else n.split(".")[-1]]
            params[key] = p.detach().clone()
            grads[key] = p.grad.clone()
    return out.detach(), float(loss), params, grads


@pytest.mark.parametrize("num_nodes", [40, 4200])
@pytest.mark.parametrize("name", ["pems-pgti", "pems-dcrnn64"])
def test_reference_matches_the_port(name, num_nodes):
    """40 sensors take the port's dense path on the CPU, 4,200 its segment
    path (above the dense threshold)."""
    cell, inputs, x, y = _setup(name, num_nodes)
    if num_nodes > 1000:
        x, y = x[:2], y[:2]
    out, loss, params, grads = _port(cell, inputs, x, y)
    ops = ref.Operators(inputs.senders, inputs.receivers, inputs.weights,
                        inputs.num_nodes, "cpu")
    want = ref.forward(params, ops, x, cell.config["model"])
    assert torch.allclose(out, want, rtol=1e-5, atol=1e-6)
    means = torch.from_numpy(inputs.means)
    stds = torch.from_numpy(inputs.stds)
    r_loss, r_grads = ref.loss_and_grads(params, ops, x, y, means, stds,
                                         cell.config["model"], block=1)
    assert r_loss == pytest.approx(loss, rel=1e-5)
    for k, g in grads.items():
        scale = float(r_grads[k].abs().max())
        assert float((g - r_grads[k]).abs().max()) <= 1e-4 * scale, k


def test_reference_on_scrambled_ids_is_the_ordered_run_permuted():
    cell, inputs, x, y = _setup("pems-pgti", 60, scramble=False)
    _, inputs_s, xs, ys = _setup("pems-pgti", 60, scramble=True)
    # the same series and graph under σ: column σ[i] of the scrambled
    # series is column i of the ordered one
    sigma = np.empty(60, dtype=np.int64)
    for i in range(60):
        sigma[i] = int(np.flatnonzero(
            (inputs_s.series[:, :, 0].T == inputs.series[:, i, 0]).all(1))[0])
    _, _, params, _ = _port(cell, inputs, x, y)
    model = cell.config["model"]
    ops = ref.Operators(inputs.senders, inputs.receivers, inputs.weights, 60,
                        "cpu")
    ops_s = ref.Operators(inputs_s.senders, inputs_s.receivers,
                          inputs_s.weights, 60, "cpu")
    a = ref.forward(params, ops, x, model)
    b = ref.forward(params, ops_s, xs, model)
    assert torch.allclose(b[:, :, sigma], a, rtol=1e-5, atol=1e-6)
    out_s, _, _, _ = _port(cell, inputs_s, xs, ys)
    assert torch.allclose(out_s, b, rtol=1e-5, atol=1e-6)


def test_data_parallel_step_over_four_gloo_ranks(tmp_path):
    """The port's ``make_dp_train_step`` on four ranks, each with a block of
    the global batch, takes the reference's step on the whole batch."""
    import torch.multiprocessing as mp

    from perfbench.tests import _dp_ranks

    cell, inputs, x, y = _setup("pems-pgti", 40, windows=8)
    path = tmp_path / "inputs.npz"
    np.savez(path, ei=np.stack([inputs.senders, inputs.receivers]),
             w=inputs.weights, n=inputs.num_nodes, means=inputs.means,
             stds=inputs.stds, x=x.numpy(), y=y.numpy())
    out = tmp_path / "rank0.npz"
    ctx = mp.start_processes(
        _dp_ranks.rank_main, args=(4, str(tmp_path / "store"), str(path),
                                   str(out), cell.config),
        nprocs=4, join=False, start_method="spawn")
    # join returns once any rank ends; a rank's failure raises here
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        assert time.monotonic() < deadline, "ranks did not finish"
    got = np.load(out)
    model = _dp_ranks.model_of(cell.config)
    p0 = {NAMES[n]: p.detach().clone() for n, p in model.named_parameters()}
    ops = ref.Operators(inputs.senders, inputs.receivers, inputs.weights, 40,
                        "cpu")
    losses, _, p1 = ref.train(p0, ops, [(x, y)], torch.from_numpy(
        inputs.means), torch.from_numpy(inputs.stds), cell.config["model"],
        float(cell.config["recipe"]["lr"]), block=8)
    assert float(got["loss"]) == pytest.approx(losses[0], rel=1e-5)
    for n, key in NAMES.items():
        # one Adam step moves each entry by lr·sign(g): compare within a
        # hundredth of that
        assert np.abs(got[n] - p1[key].numpy()).max() <= 1e-5, n
