"""MTM-1 hand-motion classification dataset.

Port of the JAX package's ``data/mtm.py``: x (3, 21, frames) joint
coordinates, y one-hot (frames, 6) labels.
"""

from __future__ import annotations

import numpy as np

from ..signal import StaticGraphTemporalSignal
from ._io import fetch_json

_URL = (
    "https://raw.githubusercontent.com/benedekrozemberczki/"
    "pytorch_geometric_temporal/master/dataset/mtm_1.json"
)


class MTMDatasetLoader:
    def __init__(self):
        self._dataset = fetch_json("mtm_1.json", _URL)

    def get_dataset(self, frames: int = 16,
                    device=None) -> StaticGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        edges = np.array(self._dataset["edges"]).T
        edge_weights = np.ones(edges.shape[1])

        joints = [str(n) for n in range(21)]
        T = len(self._dataset["0"].values())
        feats = np.zeros((T, 21, 3))
        for j, joint in enumerate(joints):
            for t, xyz in enumerate(self._dataset[joint].values()):
                feats[t, j, :] = list(map(float, xyz.strip("()").split(",")))
        features = [feats[i : i + frames].T for i in range(T - frames)]

        labels = [y for _, y in self._dataset["LABEL"].items()]
        n_values = np.max(labels) + 1
        ohe = np.eye(n_values)[labels]
        targets = [ohe[i : i + frames] for i in range(len(ohe) - frames)]
        return StaticGraphTemporalSignal(edges, edge_weights, features,
                                         targets, device=device)
