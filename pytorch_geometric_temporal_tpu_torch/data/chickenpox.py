"""Hungary chickenpox county-level weekly case counts.

Port of the JAX package's ``data/chickenpox.py``: 20 nodes, 102 edges,
unit edge weights, lagged weekly counts as features, next week as target.
"""

from __future__ import annotations

import numpy as np

from ..signal import StaticGraphTemporalSignal
from ._common import lag_windows
from ._io import fetch_json

_URL = (
    "https://raw.githubusercontent.com/benedekrozemberczki/"
    "pytorch_geometric_temporal/master/dataset/chickenpox.json"
)


class ChickenpoxDatasetLoader:
    def __init__(self):
        self._dataset = fetch_json("chickenpox.json", _URL)

    def get_dataset(self, lags: int = 4,
                    device=None) -> StaticGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        edges = np.array(self._dataset["edges"]).T
        weights = np.ones(edges.shape[1])
        features, targets = lag_windows(np.array(self._dataset["FX"]), lags)
        return StaticGraphTemporalSignal(edges, weights, features, targets,
                                         device=device)
