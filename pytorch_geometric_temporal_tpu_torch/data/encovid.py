"""England COVID-19 mobility dataset — dynamic daily graphs.

Port of the JAX package's ``data/encovid.py``: per-day directed weighted
mobility edges, z-scored case counts, lag-window features.
"""

from __future__ import annotations

import numpy as np

from ..signal import DynamicGraphTemporalSignal
from ._common import zscore
from ._io import fetch_json

_URL = (
    "https://raw.githubusercontent.com/benedekrozemberczki/"
    "pytorch_geometric_temporal/master/dataset/england_covid.json"
)


class EnglandCovidDatasetLoader:
    def __init__(self):
        self._dataset = fetch_json("england_covid.json", _URL)

    def get_dataset(self, lags: int = 8,
                    device=None) -> DynamicGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        T = self._dataset["time_periods"] - lags
        edges = [
            np.array(self._dataset["edge_mapping"]["edge_index"][str(t)]).T
            for t in range(T)
        ]
        edge_weights = [
            np.array(self._dataset["edge_mapping"]["edge_weight"][str(t)])
            for t in range(T)
        ]
        standardized = zscore(np.array(self._dataset["y"]), eps=1e-10)
        features = [standardized[i : i + lags].T for i in range(T)]
        targets = [standardized[i + lags].T for i in range(T)]
        return DynamicGraphTemporalSignal(edges, edge_weights, features,
                                          targets, device=device)
