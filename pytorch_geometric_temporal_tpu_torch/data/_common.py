"""Shared dataset-construction helpers (lag windows, z-score, one-hot
bins); port of the JAX package's ``data/_common.py``."""

from __future__ import annotations

import numpy as np


def lag_windows(stacked: np.ndarray, lags: int):
    """features[i] = stacked[i:i+lags].T, targets[i] = stacked[i+lags].T."""
    features = [
        stacked[i : i + lags].T for i in range(stacked.shape[0] - lags)
    ]
    targets = [stacked[i + lags].T for i in range(stacked.shape[0] - lags)]
    return features, targets


def binned_onehot(bin_ids: np.ndarray, num_bins: int) -> np.ndarray:
    """One-hot rows for integer bin ids in ``[0, num_bins)`` (vectorized).

    Out-of-range ids raise (numpy fancy indexing would otherwise silently
    wrap a corrupt ``-1`` to the last bin).
    """
    ids = np.asarray(bin_ids, dtype=np.intp)
    if ids.size and (ids.min() < 0 or ids.max() >= num_bins):
        raise ValueError(
            f"bin ids out of range [0, {num_bins}): "
            f"min={ids.min()}, max={ids.max()}"
        )
    return np.eye(num_bins)[ids]


def zscore(stacked: np.ndarray, axis=0, eps: float = 0.0) -> np.ndarray:
    return (stacked - np.mean(stacked, axis=axis)) / (
        np.std(stacked, axis=axis) + eps
    )
