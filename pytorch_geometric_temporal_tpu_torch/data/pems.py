"""PeMS index-only traffic datasets: all-California (11160 nodes) and All-LA.

Port of the JAX package's ``data/pems.py``: an h5 speed table and a pickled
adjacency, resolved through the data search path; a time-of-day channel
(all-California), z-score normalization, index batching only (no snapshot
iterator).

The speed tables were written with pandas' ``DataFrame.to_hdf(key='df')``
in its "fixed" format; they are read here with ``h5py`` alone (imported
when a table is read, so importing this module needs neither h5py nor
pandas), and the time of day is computed with numpy's ``datetime64``
arithmetic — the numbers the JAX package's pandas path gives.
"""

from __future__ import annotations

import pickle
from typing import Tuple

import numpy as np

from ._common import make_index_loaders
from ._io import add_search_path, fetch_bytes, find_file


def _load_pkl_adj(filename: str, url: str):
    blob = fetch_bytes(filename, url)
    _, _, adj = pickle.loads(blob)
    r, c = np.nonzero(adj)
    return np.stack([r, c]), adj[r, c]


def _read_fixed_h5(path):
    """(values (T, N), index (T,) datetime64[ns]) of a pandas fixed-format
    table: group ``df`` holding ``axis1`` (int64 ns since the epoch) and
    ``block0_values`` (T, N)."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "reading the PeMS speed tables needs h5py (pip install h5py)"
        ) from exc
    with h5py.File(str(path), "r") as f:
        g = f["df"]
        values = g["block0_values"][...]
        index = g["axis1"][...].astype("datetime64[ns]")
    return values, index


def _load_h5(filename: str, url: str):
    p = find_file(filename)
    if p is None:
        fetch_bytes(filename, url)  # downloads into the cache
        p = find_file(filename)
    return _read_fixed_h5(p)


def _time_of_day(index: np.ndarray) -> np.ndarray:
    """Fraction of the day elapsed at each datetime64 stamp."""
    return (index - index.astype("datetime64[D]")) / np.timedelta64(1, "D")


class PemsDatasetLoader:
    """All-California PeMS (11160 nodes, speed + time-of-day channels)."""

    _files = {
        "pems_cali_adj_mat.pkl": "https://anl.app.box.com/shared/static/4143x1repqa1u26aiz7o2rvw3vpcu0wp",
        "pems_cali_speed.h5": "https://anl.app.box.com/shared/static/7jwy3bsgtcpw3me2cmnrtwnnc1389fjn",
    }

    def __init__(self, raw_data_dir=None, index: bool = True):
        if not index:
            raise NotImplementedError(
                "The PeMS dataset does not support batching without the "
                "index-method"
            )
        if raw_data_dir:
            add_search_path(raw_data_dir)
        self.index = index

    def _series(self, values, index) -> np.ndarray:
        num_samples, num_nodes = values.shape
        data = np.empty((num_samples, num_nodes, 2), dtype=np.float32)
        data[..., 0] = values
        data[..., 1] = np.tile(_time_of_day(index), [num_nodes, 1]).T
        return data

    def get_index_dataset(self, lags: int = 12, batch_size: int = 64,
                          shuffle: bool = False,
                          ratio: Tuple[float, float, float] = (0.7, 0.1, 0.2),
                          world_size: int = 1, rank: int = 0, device=None):
        """Returns (train, val, test, edges, edge_weights, means, stds),
        windows gathered on ``device`` (CUDA unless "cpu")."""
        (adj_name, adj_url), (h5_name, h5_url) = self._files.items()
        edges, edge_weights = _load_pkl_adj(adj_name, adj_url)
        data = self._series(*_load_h5(h5_name, h5_url))
        means = np.mean(data, axis=(0, 1))
        stds = np.std(data, axis=(0, 1))
        data = (data - means) / stds
        loaders = make_index_loaders(data, lags, batch_size, shuffle, ratio,
                                     world_size, rank, device=device)
        return (*loaders, edges, edge_weights, means, stds)


class PemsAllLADatasetLoader(PemsDatasetLoader):
    """All-LA PeMS subset (speed channel only)."""

    _files = {
        "pems_AllLA_adj_mat.pkl": "https://anl.app.box.com/shared/static/9qc2lc1147xzh8kmq3j4fuo4buiksxua",
        "pems_AllLA_speed.h5": "https://anl.app.box.com/shared/static/crzf75ein8s839de8fklpubauddv1p6w",
    }

    def _series(self, values, index) -> np.ndarray:
        return np.expand_dims(values.astype(np.float32), -1)
