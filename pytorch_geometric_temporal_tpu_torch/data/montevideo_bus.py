"""Montevideo bus passenger inflow.

Port of the JAX package's ``data/montevideo_bus.py``: 675 stops, weighted
static graph, z-scored hourly inflow, lag-window features.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..signal import StaticGraphTemporalSignal
from ._common import zscore
from ._io import fetch_json

_URL = (
    "https://raw.githubusercontent.com/benedekrozemberczki/"
    "pytorch_geometric_temporal/master/dataset/montevideo_bus.json"
)


class MontevideoBusDatasetLoader:
    def __init__(self):
        self._dataset = fetch_json("montevideo_bus.json", _URL)

    def _get_node_ids(self):
        return [node.get("bus_stop") for node in self._dataset["nodes"]]

    def get_dataset(self, lags: int = 4, target_var: str = "y",
                    feature_vars: Sequence[str] = ("y",),
                    device=None) -> StaticGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        node_ids = self._get_node_ids()
        node_id_map = dict(zip(node_ids, range(len(node_ids))))
        edges = np.array(
            [
                (node_id_map[d["source"]], node_id_map[d["target"]])
                for d in self._dataset["links"]
            ]
        ).T
        edge_weights = np.array([d["weight"] for d in self._dataset["links"]]).T

        feats = []
        for node in self._dataset["nodes"]:
            X = node.get("X")
            for fv in feature_vars:
                feats.append(np.array(X.get(fv)))
        stacked_features = zscore(np.stack(feats).T)
        features = [
            stacked_features[i : i + lags].T
            for i in range(len(stacked_features) - lags)
        ]

        targs = [np.array(node.get(target_var))
                 for node in self._dataset["nodes"]]
        stacked_targets = zscore(np.stack(targs).T)
        targets = [
            stacked_targets[i + lags].T
            for i in range(len(stacked_targets) - lags)
        ]
        return StaticGraphTemporalSignal(edges, edge_weights, features,
                                         targets, device=device)
