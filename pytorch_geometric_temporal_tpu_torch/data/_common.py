"""Shared dataset-construction helpers (lag windows, z-score, one-hot
bins, the index split); port of the JAX package's ``data/_common.py``."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..signal import DeviceWindower, IndexLoader


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


def make_index_loaders(
    data: np.ndarray,
    lags: int,
    batch_size: int,
    shuffle: bool = False,
    ratio: Tuple[float, float, float] = (0.7, 0.1, 0.2),
    world_size: int = 1,
    rank: int = 0,
    device=None,
):
    """The reference's index split (70/10/20 of the window starts by
    default) over one :class:`DeviceWindower` of the f32 series on
    ``device`` (CUDA unless given "cpu").

    Returns (train_loader, val_loader, test_loader).
    """
    if world_size in (-1, 0):
        world_size, rank = 1, 0
    if rank in (-1,):
        rank = 0
    num_samples = data.shape[0]
    x_i = np.arange(num_samples - (2 * lags - 1))
    n = x_i.shape[0]
    num_train = round(n * ratio[0])
    num_test = round(n * ratio[2])
    windower = DeviceWindower(np.asarray(data, dtype=np.float32), lags,
                              device=device)
    return tuple(
        IndexLoader(idx, windower, batch_size, shuffle=shuffle,
                    world_size=world_size, rank=rank)
        for idx in (x_i[:num_train], x_i[num_train : n - num_test],
                    x_i[-num_test:]))
