"""End-to-end accuracy protocols on the real bundled datasets.

Counterpart of the JAX package's ``benchmarks/bundled_accuracy.py``: every
run trains on the bytes shipped in ``data/bundled/`` (no downloads) with
the upstream example protocol — train ratio 0.2, Adam(0.01), one update an
epoch on the per-snapshot MSE averaged over time (full-sequence BPTT), test
MSE reported; every net is cell + ReLU + ``Dense(hidden -> 1)``:

- **PedalMe**: DCRNN(4->32, K=1) and A3TGCN(periods 4, on ``x[:, None,
  :]``) reset their state every snapshot, TGCN(4->32) threads H across the
  snapshots of an epoch.
- **TwitterTennis rg17** (dynamic edges): EvolveGCN-O / EvolveGCN-H as
  full-sequence ``Seq`` models — the evolved weight restarts each epoch
  from the learned initial weight — and DyGrEncoder (``conv_out_channels``
  = the encoded feature width, ``mean``) with (H, C) threaded.
- **EnglandCovid** (a graph per snapshot): DCRNN(8->16, K=1);
  **MontevideoBus**: GConvGRU(4->32, K=1).

:data:`RUNS` names the eight runs; each takes ``(epochs, device=None,
params=None, seed=0)`` — ``params`` is a flax parameter tree to start from
instead of the seeded initial draw — and returns a :class:`ProtocolRun`.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List

import torch

from .._device import resolve_device
from ..data import (
    EnglandCovidDatasetLoader,
    MontevideoBusDatasetLoader,
    PedalMeDatasetLoader,
    TwitterTennisDatasetLoader,
)
from ..models import (
    A3TGCN,
    DCRNN,
    TGCN,
    DyGrEncoder,
    EvolveGCNHSeq,
    EvolveGCNOSeq,
    GConvGRU,
)
from ..models._cells import Dense, FlaxModule
from ..ops.graph import Graph
from ..signal import StackedSignal, temporal_signal_split
from ..train import SnapshotTrainer, mse
from ..train.trainer import _adam

LR = 1e-2
TRAIN_RATIO = 0.2


@dataclasses.dataclass
class ProtocolRun:
    """One protocol run: the test MSE, the training loss of every epoch
    (each taken before that epoch's update) and the training seconds
    (host clock, the device synchronized)."""

    test_mse: float
    losses: List[float]
    seconds: float


class _Net(FlaxModule):
    """cell + ReLU + Dense(hidden -> 1); :meth:`head` maps a hidden state
    (..., N, hidden) to predictions (..., N)."""

    def __init__(self, recurrent, hidden: int, device, generator):
        super().__init__()
        self.recurrent = recurrent
        self.linear = Dense(hidden, 1, device=device, generator=generator)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        return self.linear(torch.relu(h))[..., 0]


_LOADERS = {
    "pedalme": lambda dev: PedalMeDatasetLoader().get_dataset(
        lags=4, device=dev),
    "twittertennis": lambda dev: TwitterTennisDatasetLoader(
        event_id="rg17").get_dataset(device=dev),
    "englandcovid": lambda dev: EnglandCovidDatasetLoader().get_dataset(
        lags=8, device=dev),
    "montevideobus": lambda dev: MontevideoBusDatasetLoader().get_dataset(
        lags=4, device=dev),
}


@functools.lru_cache(maxsize=None)
def _signals(dataset: str, device: str):
    """(train, test) stacked signals of a bundled dataset on ``device``."""
    train, test = temporal_signal_split(_LOADERS[dataset](device),
                                        TRAIN_RATIO)
    return StackedSignal.from_signal(train), StackedSignal.from_signal(test)


def _timed(device: torch.device, train: Callable) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    train()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _fit_snapshots(net, step, train, test, epochs, device,
                   init_carry=()) -> ProtocolRun:
    """The snapshot-loop protocol through :class:`SnapshotTrainer`."""
    trainer = SnapshotTrainer(net, step, lr=LR, device=device)
    losses = []
    seconds = _timed(device, lambda: trainer.fit(
        train, epochs, init_carry,
        callback=lambda epoch, loss: losses.append(loss)))
    return ProtocolRun(float(trainer.evaluate(test, init_carry)),
                       [float(v) for v in losses], seconds)


def _stacked_graph(sig: StackedSignal) -> Graph:
    return Graph(sig.senders, sig.receivers, sig.weights, sig.num_nodes,
                 sig.num_edges)


def _fit_sequence(net, train, test, epochs, device) -> ProtocolRun:
    """The full-sequence protocol: ``pred = net(xs, graph)`` over all
    snapshots at once, their MSE, one update per epoch."""
    optimizer = _adam(net.to(device), LR)
    graph, losses = _stacked_graph(train), []

    def fit():
        for _ in range(epochs):
            optimizer.zero_grad(set_to_none=True)
            loss = mse(net(train.features, graph), train.targets)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())

    seconds = _timed(device, fit)
    with torch.no_grad():
        test_mse = mse(net(test.features, _stacked_graph(test)),
                       test.targets)
    return ProtocolRun(float(test_mse), [float(v) for v in losses], seconds)


def _start(dataset, device, seed):
    device = resolve_device(device)
    train, test = _signals(dataset, str(device))
    return device, train, test, torch.Generator().manual_seed(seed)


def _stateless(dataset, make_cell, hidden, view=lambda x: x):
    """A run whose cell starts from a zero state at every snapshot."""

    def run(epochs, device=None, params=None, seed=0) -> ProtocolRun:
        device, train, test, gen = _start(dataset, device, seed)
        net = _Net(make_cell(train, device, gen), hidden, device, gen)
        if params is not None:
            net.params_from_flax(params)

        def step(carry, x, y, g):
            return mse(net.head(net.recurrent(view(x), g)), y), carry

        return _fit_snapshots(net, step, train, test, epochs, device)

    return run


def _pedalme_tgcn(epochs, device=None, params=None, seed=0) -> ProtocolRun:
    device, train, test, gen = _start("pedalme", device, seed)
    net = _Net(TGCN(4, 32, device=device, generator=gen), 32, device, gen)
    if params is not None:
        net.params_from_flax(params)

    def step(h, x, y, g):
        h = net.recurrent(x, g, h)
        return mse(net.head(h), y), h

    h0 = torch.zeros((train.num_nodes, 32), device=device)
    return _fit_snapshots(net, step, train, test, epochs, device, h0)


def _twitter_seq(make_cell):
    def run(epochs, device=None, params=None, seed=0) -> ProtocolRun:
        device, train, test, gen = _start("twittertennis", device, seed)
        f = train.features.shape[2]

        class SeqNet(_Net):
            def forward(self, xs, graph):
                return self.head(self.recurrent(xs, graph))

        net = SeqNet(make_cell(train.num_nodes, f, device, gen), f, device,
                     gen)
        if params is not None:
            net.params_from_flax(params)
        return _fit_sequence(net, train, test, epochs, device)

    return run


def _twitter_dygrae(epochs, device=None, params=None, seed=0) -> ProtocolRun:
    device, train, test, gen = _start("twittertennis", device, seed)
    # conv_out_channels follows the feature width (GatedGraphConv needs
    # in <= out; the encoded TwitterTennis features are 16 wide)
    cell = DyGrEncoder(
        conv_out_channels=train.features.shape[2], conv_num_layers=1,
        conv_aggr="mean", lstm_out_channels=32, lstm_num_layers=1,
        device=device, generator=gen)
    net = _Net(cell, 32, device, gen)
    if params is not None:
        net.params_from_flax(params)

    def step(carry, x, y, g):
        h_tilde, h, c = net.recurrent(x, g, *carry)
        return mse(net.head(h_tilde), y), (h, c)

    zero = torch.zeros((train.num_nodes, 32), device=device)
    return _fit_snapshots(net, step, train, test, epochs, device,
                          (zero, zero))


RUNS: Dict[str, Callable[..., ProtocolRun]] = {
    "pedalme_dcrnn": _stateless(
        "pedalme", lambda train, dev, gen: DCRNN(
            4, 32, K=1, device=dev, generator=gen), 32),
    "pedalme_tgcn": _pedalme_tgcn,
    # one feature, the four lags as periods
    "pedalme_a3tgcn": _stateless(
        "pedalme", lambda train, dev, gen: A3TGCN(
            1, 32, periods=4, device=dev, generator=gen), 32,
        view=lambda x: x[:, None, :]),
    "twittertennis_evolvegcno": _twitter_seq(
        lambda n, f, dev, gen: EvolveGCNOSeq(f, device=dev, generator=gen)),
    "twittertennis_evolvegcnh": _twitter_seq(
        lambda n, f, dev, gen: EvolveGCNHSeq(n, f, device=dev,
                                             generator=gen)),
    "twittertennis_dygrae": _twitter_dygrae,
    "englandcovid_dcrnn": _stateless(
        "englandcovid", lambda train, dev, gen: DCRNN(
            8, 16, K=1, device=dev, generator=gen), 16),
    "montevideobus_gconvgru": _stateless(
        "montevideobus", lambda train, dev, gen: GConvGRU(
            4, 32, K=1, device=dev, generator=gen), 32),
}


def _test_mses(epochs_by_run: Dict[str, int], device) -> Dict[str, float]:
    return {f"{name}_test_mse": RUNS[name](epochs, device).test_mse
            for name, epochs in epochs_by_run.items()}


def pedalme_accuracy(epochs_long: int = 200, epochs_short: int = 50,
                     device=None) -> Dict[str, float]:
    """DCRNN/TGCN/A3TGCN test MSE on bundled PedalMe."""
    return _test_mses({"pedalme_dcrnn": epochs_long,
                       "pedalme_tgcn": epochs_short,
                       "pedalme_a3tgcn": epochs_short}, device)


def twitter_tennis_accuracy(epochs: int = 200,
                            device=None) -> Dict[str, float]:
    """EvolveGCN-O/H + DyGrEncoder test MSE on bundled TwitterTennis rg17
    (dynamic-edge snapshots, a padded edge list per step)."""
    return _test_mses({"twittertennis_evolvegcno": epochs,
                       "twittertennis_evolvegcnh": epochs,
                       "twittertennis_dygrae": epochs}, device)


def extra_bundled_accuracy(epochs_covid: int = 100, epochs_bus: int = 50,
                           device=None) -> Dict[str, float]:
    """DCRNN on EnglandCovid (a graph per snapshot) and GConvGRU on
    MontevideoBus: test MSE."""
    return _test_mses({"englandcovid_dcrnn": epochs_covid,
                       "montevideobus_gconvgru": epochs_bus}, device)


if __name__ == "__main__":
    import json

    rec = {}
    rec.update(pedalme_accuracy())
    rec.update(twitter_tennis_accuracy())
    rec.update(extra_bundled_accuracy())
    print(json.dumps({k: round(v, 4) for k, v in rec.items()}))
