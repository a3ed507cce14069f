"""Hungary chickenpox county-level weekly case counts.

Port of the JAX package's ``data/chickenpox.py``: 20 nodes, 102 edges,
unit edge weights, lagged weekly counts as features, next week as target;
with ``index=True`` also the index-batched loaders.
"""

from __future__ import annotations

import numpy as np

from ..signal import StaticGraphTemporalSignal
from ._common import lag_windows, make_index_loaders
from ._io import fetch_json

_URL = (
    "https://raw.githubusercontent.com/benedekrozemberczki/"
    "pytorch_geometric_temporal/master/dataset/chickenpox.json"
)


class ChickenpoxDatasetLoader:
    def __init__(self, index: bool = False):
        self._dataset = fetch_json("chickenpox.json", _URL)
        self.index = index

    def get_dataset(self, lags: int = 4,
                    device=None) -> StaticGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        edges = np.array(self._dataset["edges"]).T
        weights = np.ones(edges.shape[1])
        features, targets = lag_windows(np.array(self._dataset["FX"]), lags)
        return StaticGraphTemporalSignal(edges, weights, features, targets,
                                         device=device)

    def get_index_dataset(self, lags: int = 4, batch_size: int = 4,
                          shuffle: bool = False, ratio=(0.7, 0.1, 0.2),
                          world_size: int = 1, rank: int = 0, device=None):
        """Index-batched loaders: (train_loader, val_loader, test_loader,
        edges, edge_weights), windows gathered on ``device`` (CUDA unless
        "cpu")."""
        if not self.index:
            raise ValueError(
                "get_index_dataset requires 'index=True' in the constructor."
            )
        data = np.expand_dims(np.array(self._dataset["FX"]), axis=-1)
        edges = np.array(self._dataset["edges"], dtype=np.int64).T
        edge_weights = np.ones(edges.shape[1], dtype=np.float32)
        loaders = make_index_loaders(
            data, lags, batch_size, shuffle=shuffle, ratio=ratio,
            world_size=world_size, rank=rank, device=device,
        )
        return (*loaders, edges, edge_weights)
