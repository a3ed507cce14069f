"""PEMS-BAY traffic dataset: 325 sensors, Bay Area.

Port of the JAX package's ``data/pems_bay.py`` — METR-LA's structure with
other archive members, and targets that keep every feature.
"""

from __future__ import annotations

from ..signal import StaticGraphTemporalSignal
from .metr_la import METRLADatasetLoader


class PemsBayDatasetLoader(METRLADatasetLoader):
    _zip = "PEMS-BAY.zip"
    _adj = "pems_adj_mat.npy"
    _values = "pems_node_values.npy"
    _url = "https://anl.app.box.com/shared/static/7ealcaw862pm12sglyt5g71743eu7s5l"

    def get_dataset(self, num_timesteps_in: int = 12,
                    num_timesteps_out: int = 12,
                    device=None) -> StaticGraphTemporalSignal:
        """Unlike METR-LA's speed-only targets, the reference's PEMS-BAY
        targets keep ALL features: y = X[:, :, t_in:span]."""
        return StaticGraphTemporalSignal(
            *self._windows(num_timesteps_in, num_timesteps_out, slice(None)),
            device=device)
