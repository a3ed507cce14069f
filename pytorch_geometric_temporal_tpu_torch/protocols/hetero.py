"""HeteroGCLSTM on a synthetic heterogeneous temporal signal.

Twin of the JAX package's ``examples/recurrent/hetero_example.py``: two
node types ("a": 12 nodes, 4 features; "b": 8 nodes, 3 features), typed
edges both ways, 24 snapshots split 0.8, a ``HeteroGCLSTM`` with 16
channels and a shared linear head on ReLU, (H, C) threaded across the
snapshots, the MSE summed over node types and averaged over snapshots,
one Adam(1e-2) update an epoch.  The data are the example's numpy draws;
training runs as a :class:`~..signal.StackedHeteroSignal` through
:class:`~..train.SnapshotTrainer`.

    python -m pytorch_geometric_temporal_tpu_torch.protocols.hetero
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..models import HeteroGCLSTM
from ..models._cells import Dense, FlaxModule, flax_params
from ..signal import (StackedHeteroSignal, StaticHeteroGraphTemporalSignal,
                      temporal_signal_split)
from ..train import SnapshotTrainer, mse

METADATA = (["a", "b"], [("a", "to", "b"), ("b", "to", "a")])
IN_CHANNELS = {"a": 4, "b": 3}
HIDDEN = 16
LR = 1e-2


def make_signal(rng, T=24, n_a=12, n_b=8, f_a=4, f_b=3, device=None):
    """The example's signal, drawn from the numpy generator ``rng``."""
    ei_ab = np.stack([rng.integers(0, n_a, 30), rng.integers(0, n_b, 30)])
    ei_ba = np.stack([rng.integers(0, n_b, 25), rng.integers(0, n_a, 25)])
    edge_index_dict = {("a", "to", "b"): ei_ab, ("b", "to", "a"): ei_ba}
    edge_weight_dict = {k: np.ones(v.shape[1])
                        for k, v in edge_index_dict.items()}
    feats = [
        {"a": rng.normal(size=(n_a, f_a)).astype(np.float32),
         "b": rng.normal(size=(n_b, f_b)).astype(np.float32)}
        for _ in range(T)
    ]
    targs = [{"a": f["a"].sum(-1) * 0.3, "b": f["b"].sum(-1) * 0.5}
             for f in feats]
    return StaticHeteroGraphTemporalSignal(
        edge_index_dict, edge_weight_dict, feats, targs, device=device)


class HeteroRegressor(FlaxModule):
    """HeteroGCLSTM + a head shared by the node types: forward ``(x_dict,
    edge_graphs, h_dict=None, c_dict=None) -> (preds, h, c)``."""

    def __init__(self, metadata, in_channels_dict, hidden=HIDDEN,
                 device=None, generator=None):
        super().__init__()
        self.cell = HeteroGCLSTM(in_channels_dict, hidden, metadata,
                                 device=device, generator=generator)
        self.head = Dense(hidden, 1, device=device, generator=generator)

    def params_from_flax(self, tree):
        """Load the flax tree of the example's ``HeteroRegressor``, whose
        cell flax names ``HeteroGCLSTM_0``."""
        p = flax_params(tree)
        self.cell.params_from_flax(p["HeteroGCLSTM_0"])
        self.head.params_from_flax(p["head"])
        return self

    def forward(self, x_dict, edge_graphs, h_dict=None, c_dict=None):
        h, c = self.cell(x_dict, edge_graphs, h_dict, c_dict)
        preds = {k: self.head(torch.relu(v))[..., 0] for k, v in h.items()}
        return preds, h, c


def main(epochs: int = 30, device=None, params=None, log=print):
    """Train; returns the training loss of every epoch (each before its
    update) and the test loss.  ``params`` is a flax parameter tree to
    start from in place of the seeded draw."""
    device = resolve_device(device)
    sig = make_signal(np.random.default_rng(0), device=device)
    train_sig, test_sig = temporal_signal_split(sig, 0.8)
    train = StackedHeteroSignal.from_signal(train_sig)
    test = StackedHeteroSignal.from_signal(test_sig)
    model = HeteroRegressor(METADATA, IN_CHANNELS, device=device,
                            generator=torch.Generator().manual_seed(0))
    if params is not None:
        model.params_from_flax(params)

    def step(carry, x_dict, y_dict, graphs):
        h, c = carry if carry else (None, None)
        preds, h, c = model(x_dict, graphs, h, c)
        loss = sum(mse(preds[k], y_dict[k]) for k in preds)
        return loss, (h, c)

    trainer = SnapshotTrainer(model, step, lr=LR, device=device)
    losses = []
    for e in range(epochs):
        losses.append(float(trainer.train_epoch(train, None)))
        if e % 10 == 0:
            log(f"epoch {e}: {losses[-1]:.4f}")
    log(f"final: {losses[-1]:.4f}")
    return losses, float(trainer.evaluate(test, None))


if __name__ == "__main__":
    main()
