"""METR-LA traffic dataset: 207 loop detectors, 5-minute intervals.

Port of the JAX package's ``data/metr_la.py``: a zip (adj_mat.npy +
node_values.npy) resolved through the data search path, z-score per
feature as in the DCRNN paper, 12-in/12-out windows; the index path
returns a 7-tuple with means and stds and rank sharding.
"""

from __future__ import annotations

import io
from typing import Tuple

import numpy as np

from ..signal import StaticGraphTemporalSignal
from ._common import make_index_loaders
from ._io import add_search_path, fetch_zipped

_URL = "https://anl.app.box.com/shared/static/plgsv3te0akmqluiuqva34su60nn93c2"


def _dense_to_sparse(a: np.ndarray):
    r, c = np.nonzero(a)
    return np.stack([r, c]), a[r, c]


class METRLADatasetLoader:
    _zip = "METR-LA.zip"
    _adj = "adj_mat.npy"
    _values = "node_values.npy"
    _url = _URL

    def __init__(self, raw_data_dir=None, index: bool = False):
        self.index = index
        if raw_data_dir:
            add_search_path(raw_data_dir)
        self.A = np.load(io.BytesIO(fetch_zipped(self._zip, self._url,
                                                 self._adj)))
        self._X_raw = np.load(
            io.BytesIO(fetch_zipped(self._zip, self._url, self._values)))

    def _normalized_X(self):
        """(X (N, F, T) f32 z-scored per feature, means (F,), stds (F,))."""
        X = self._X_raw.transpose((1, 2, 0)).astype(np.float32)
        means = np.mean(X, axis=(0, 2))
        X = X - means.reshape(1, -1, 1)
        stds = np.std(X, axis=(0, 2))
        X = X / stds.reshape(1, -1, 1)
        return X, means, stds

    def _windows(self, num_timesteps_in, num_timesteps_out, target):
        X, _, _ = self._normalized_X()
        edges, edge_weights = _dense_to_sparse(self.A)
        span = num_timesteps_in + num_timesteps_out
        features, targets = [], []
        for i in range(X.shape[2] - span + 1):
            features.append(X[:, :, i : i + num_timesteps_in])
            targets.append(X[:, target, i + num_timesteps_in : i + span])
        return edges, edge_weights, features, targets

    def get_dataset(self, num_timesteps_in: int = 12,
                    num_timesteps_out: int = 12,
                    device=None) -> StaticGraphTemporalSignal:
        """Snapshots of (N, F, in) features and (N, out) speed targets on
        ``device`` (CUDA unless "cpu")."""
        return StaticGraphTemporalSignal(
            *self._windows(num_timesteps_in, num_timesteps_out, 0),
            device=device)

    def get_index_dataset(self, lags: int = 12, batch_size: int = 64,
                          shuffle: bool = False,
                          ratio: Tuple[float, float, float] = (0.7, 0.1, 0.2),
                          world_size: int = 1, rank: int = 0, device=None):
        """Returns (train, val, test, edges, edge_weights, means, stds)."""
        if not self.index:
            raise ValueError(
                "get_index_dataset requires 'index=True' in the constructor."
            )
        X, means, stds = self._normalized_X()
        data = X.transpose((2, 0, 1))  # (T, N, F)
        edges, edge_weights = _dense_to_sparse(self.A)
        loaders = make_index_loaders(data, lags, batch_size, shuffle, ratio,
                                     world_size, rank, device=device)
        return (*loaders, edges, edge_weights, means, stds)
