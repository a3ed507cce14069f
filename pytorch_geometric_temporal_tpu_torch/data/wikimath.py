"""Wikipedia vital-mathematics daily visits.

Port of the JAX package's ``data/wikimath.py``: 731 daily periods, targets
z-score standardized per node, lagged visits as features.
"""

from __future__ import annotations

import numpy as np

from ..signal import StaticGraphTemporalSignal
from ._common import lag_windows, zscore
from ._io import fetch_json

_URL = (
    "https://raw.githubusercontent.com/benedekrozemberczki/"
    "pytorch_geometric_temporal/master/dataset/wikivital_mathematics.json"
)


class WikiMathsDatasetLoader:
    def __init__(self):
        self._dataset = fetch_json("wikivital_mathematics.json", _URL)

    def get_dataset(self, lags: int = 8,
                    device=None) -> StaticGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        edges = np.array(self._dataset["edges"]).T
        edge_weights = np.array(self._dataset["weights"]).T
        targets = np.stack(
            [
                np.array(self._dataset[str(t)]["y"])
                for t in range(self._dataset["time_periods"])
            ]
        )
        standardized = zscore(targets)
        features, targs = lag_windows(standardized, lags)
        return StaticGraphTemporalSignal(edges, edge_weights, features, targs,
                                         device=device)
