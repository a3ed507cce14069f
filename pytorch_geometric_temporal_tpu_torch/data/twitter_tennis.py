"""Twitter tennis mention graphs (RG17 / UO17) — dynamic-edge snapshots.

Port of the JAX package's ``data/twitter_tennis.py``: feature modes
None/'encoded'/'diagonal', log(1+degree) targets at t+offset.
"""

from __future__ import annotations

import numpy as np

from ..signal import DynamicGraphTemporalSignal
from ._common import binned_onehot
from ._io import fetch_json

_URL_BASE = (
    "https://raw.githubusercontent.com/ferencberes/"
    "pytorch_geometric_temporal/developer/dataset/"
)


def encode_features(X, log_degree_cutoff=4):
    """One-hot bins of (log-degree, transitivity) raw node features.

    Column 0 is binned as ``min(ceil(log1p(deg)), cutoff)`` into ``cutoff +
    1`` bins, column 1 as ``floor(10 * transitivity)`` into 11 bins, and the
    two one-hot blocks concatenate.
    """
    X = np.asarray(X, dtype=np.float64)
    deg_bins = np.minimum(np.ceil(np.log1p(X[:, 0])), log_degree_cutoff)
    trans_bins = np.floor(X[:, 1] * 10)
    return np.concatenate(
        (
            binned_onehot(deg_bins, log_degree_cutoff + 1),
            binned_onehot(trans_bins, 11),
        ),
        axis=1,
    )


class TwitterTennisDatasetLoader:
    def __init__(self, event_id="rg17", N=None, feature_mode="encoded",
                 target_offset=1):
        self.N = N
        self.target_offset = target_offset
        if event_id not in ("rg17", "uo17"):
            raise ValueError(
                "Invalid 'event_id'! Choose 'rg17' or 'uo17' to load the "
                "Roland-Garros 2017 or the USOpen 2017 Twitter tennis "
                "dataset respectively."
            )
        self.event_id = event_id
        if feature_mode not in (None, "diagonal", "encoded"):
            raise ValueError(
                "Choose feature_mode from values [None, 'diagonal', 'encoded']."
            )
        self.feature_mode = feature_mode
        fname = f"twitter_tennis_{event_id}.json"
        self._dataset = fetch_json(fname, _URL_BASE + fname)

    def get_dataset(self, device=None) -> DynamicGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        T = self._dataset["time_periods"]
        edges, edge_weights, features, targets = [], [], [], []
        for t in range(T):
            E = np.array(self._dataset[str(t)]["edges"])
            W = np.array(self._dataset[str(t)]["weights"])
            if self.N is not None:
                sel = np.where((E[:, 0] < self.N) & (E[:, 1] < self.N))
                E, W = E[sel], W[sel]
            edges.append(E.T)
            edge_weights.append(W)
            X = np.array(self._dataset[str(t)]["X"])
            if self.N is not None:
                X = X[: self.N]
            if self.feature_mode == "diagonal":
                X = np.identity(X.shape[0])
            elif self.feature_mode == "encoded":
                X = encode_features(X)
            features.append(X)
            snapshot_id = min(t + self.target_offset, T - 1)
            y = np.log(1.0 + np.array(self._dataset[str(snapshot_id)]["y"]))
            if self.N is not None:
                y = y[: self.N]
            targets.append(y)
        return DynamicGraphTemporalSignal(edges, edge_weights, features,
                                          targets, device=device)
