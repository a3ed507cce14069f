"""Windmill energy output datasets — large (319 nodes), medium, small.

Port of the JAX package's ``data/windmill.py``: all three resolve through
the data search path and raise only when the file is unavailable.
"""

from __future__ import annotations

import numpy as np

from ..signal import StaticGraphTemporalSignal
from ._common import lag_windows, make_index_loaders, zscore
from ._io import fetch_json


class _WindmillBase:
    _filename: str
    _url: str

    def __init__(self, index: bool = False):
        self._dataset = fetch_json(self._filename, self._url)
        self.index = index

    def get_dataset(self, lags: int = 8,
                    device=None) -> StaticGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        edges = np.array(self._dataset["edges"]).T
        edge_weights = np.array(self._dataset["weights"]).T
        stacked = np.stack(self._dataset["block"])
        standardized = zscore(stacked, eps=1e-10)
        features, targets = lag_windows(standardized, lags)
        return StaticGraphTemporalSignal(edges, edge_weights, features,
                                         targets, device=device)

    def get_index_dataset(self, lags: int = 8, batch_size: int = 4,
                          shuffle: bool = False, ratio=(0.7, 0.1, 0.2),
                          world_size: int = 1, rank: int = 0, device=None):
        """Returns (train, val, test, edges, edge_weights), windows gathered
        on ``device`` (CUDA unless "cpu")."""
        if not self.index:
            raise ValueError(
                "get_index_dataset requires 'index=True' in the constructor."
            )
        stacked = np.stack(self._dataset["block"])
        data = np.expand_dims(zscore(stacked, eps=1e-10), -1)
        edges = np.array(self._dataset["edges"], dtype=np.int64).T
        edge_weights = np.array(self._dataset["weights"], dtype=np.float32).T
        loaders = make_index_loaders(data, lags, batch_size, shuffle, ratio,
                                     world_size, rank, device=device)
        return (*loaders, edges, edge_weights)


class WindmillOutputLargeDatasetLoader(_WindmillBase):
    _filename = "windmill_output.json"
    _url = "https://graphmining.ai/temporal_datasets/windmill_output.json"


class WindmillOutputMediumDatasetLoader(_WindmillBase):
    _filename = "windmill_output_medium.json"
    _url = "https://graphmining.ai/temporal_datasets/windmill_output_medium.json"


class WindmillOutputSmallDatasetLoader(_WindmillBase):
    _filename = "windmill_output_small.json"
    _url = "https://graphmining.ai/temporal_datasets/windmill_output_small.json"
