"""Synthetic PDE simulation datasets on German NUTS3 regions.

Port of the JAX package's ``data/synthetic_pde.py`` (Starndt et al.,
synthetic temporal graph benchmarks): 400 nodes, 2088 edges; an ``.npy``
signal and a torch-serialized (E, 3) distance tensor (sender, receiver,
distance), read with ``weights_only=True``.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ..signal import StaticGraphTemporalSignal
from ._io import fetch_bytes

_BASE = (
    "https://raw.githubusercontent.com/Jostarndt/"
    "Synthetic_Datasets_for_Temporal_Graphs/main/data/"
)


def _load_distance_pt(filename: str, url: str):
    blob = fetch_bytes(filename, url)
    dist = torch.load(io.BytesIO(blob), map_location="cpu",
                      weights_only=True).T
    return dist[:2, :].numpy(), dist[2, :].numpy()


class _PDEBase:
    _signal_file: str
    _signal_url: str
    _adj_file = "nuts3_adjacent_distances.pt"
    _adj_subdir: str

    def __init__(self):
        self._dataset = np.load(
            io.BytesIO(fetch_bytes(self._signal_file, self._signal_url))
        )
        self._edges, self._edge_weights = _load_distance_pt(
            self._adj_file, _BASE + self._adj_subdir + "/" + self._adj_file
        )


class SIDiffusionDatasetLoader(_PDEBase):
    """Features (N, 2, lags) [S and I compartments]; targets infected only."""

    _signal_file = "SI_equation_dataset.npy"
    _signal_url = _BASE + "SI_diffusion_equation/SI_equation_dataset.npy"
    _adj_subdir = "SI_diffusion_equation"

    def get_dataset(self, lags: int = 4,
                    device=None) -> StaticGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        d = self._dataset
        features = [
            d[i : i + lags].transpose(1, 2, 0)
            for i in range(d.shape[0] - lags)
        ]
        targets = [d[i + lags, :, 1:2] for i in range(d.shape[0] - lags)]
        return StaticGraphTemporalSignal(
            self._edges, self._edge_weights, features, targets, device=device
        )


class _FlatPDEBase(_PDEBase):
    """Features reshaped to (N, lags·F)."""

    def get_dataset(self, lags: int = 4,
                    device=None) -> StaticGraphTemporalSignal:
        """The signal, its snapshots on ``device`` (CUDA unless "cpu")."""
        d = self._dataset
        features = [
            d[i : i + lags].transpose(1, 0, 2).reshape(d.shape[1], -1)
            for i in range(d.shape[0] - lags)
        ]
        targets = [d[i + lags] for i in range(d.shape[0] - lags)]
        return StaticGraphTemporalSignal(
            self._edges, self._edge_weights, features, targets, device=device
        )


class AdvectionDiffusionDatasetLoader(_FlatPDEBase):
    _signal_file = "advection_diffusion_dataset.npy"
    _signal_url = (
        _BASE + "advection_diffusion_equation/advection_diffusion_dataset.npy"
    )
    _adj_subdir = "advection_diffusion_equation"


class WaveEquationDatasetLoader(_FlatPDEBase):
    _signal_file = "wave_equation_dataset.npy"
    _signal_url = _BASE + "wave_equation/wave_equation_dataset.npy"
    _adj_file = "germany_coastline_adjacency.pt"
    _adj_subdir = "wave_equation"
