"""PedalMe London bicycle delivery demand.

Port of the JAX package's ``data/pedalme.py``: 15 nodes, weighted static
graph, lagged weekly demand as features, next week as target.
"""

from __future__ import annotations

import numpy as np

from ..signal import StaticGraphTemporalSignal
from ._common import lag_windows
from ._io import fetch_json

_URL = (
    "https://raw.githubusercontent.com/benedekrozemberczki/"
    "pytorch_geometric_temporal/master/dataset/pedalme_london.json"
)


class PedalMeDatasetLoader:
    def __init__(self):
        self._dataset = fetch_json("pedalme_london.json", _URL)

    def get_dataset(self, lags: int = 4,
                    device=None) -> StaticGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        edges = np.array(self._dataset["edges"]).T
        edge_weights = np.array(self._dataset["weights"]).T
        features, targets = lag_windows(np.array(self._dataset["X"]), lags)
        return StaticGraphTemporalSignal(edges, edge_weights, features,
                                         targets, device=device)
