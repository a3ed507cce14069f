"""Shared engine behind the temporal-signal iterator classes.

Port of the JAX package's ``signal/base.py``: one mixin provides the
iterator protocol, slicing, consistency checks and the numpy→tensor
conversion, and each public class only declares how to fetch its per-step
pieces.  The raw inputs stay numpy on the host; snapshots come out as
:class:`~.snapshot.Snapshot` objects of tensors on the signal's ``device``
(CUDA unless the constructor was given ``device="cpu"``).

- Dynamic-edge variants pad every snapshot's edge list to the
  sequence-wide maximum, so every step has the same shapes.
- Graphs are built lazily and cached per time step.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .._device import resolve_device
from ..ops.graph import Graph
from .snapshot import Snapshot, convert_array


class BaseSignal:
    """Iterator protocol + slicing, shared by all signal classes."""

    snapshot_count: int

    def _check_temporal_consistency(self):
        raise NotImplementedError

    def _make_snapshot(self, t: int):
        raise NotImplementedError

    def _slice(self, s: slice):
        raise NotImplementedError

    def __len__(self):
        return self.snapshot_count

    def __getitem__(self, time_index):
        if isinstance(time_index, slice):
            return self._slice(time_index)
        if time_index < 0:
            time_index += self.snapshot_count
        return self._make_snapshot(time_index)

    def __next__(self):
        if self.t < self.snapshot_count:
            snapshot = self[self.t]
            self.t += 1
            return snapshot
        self.t = 0
        raise StopIteration

    def __iter__(self):
        self.t = 0
        return self


def _assert_equal_len(a, b):
    assert len(a) == len(b), "Temporal dimension inconsistency."


class HomoSignalMixin(BaseSignal):
    """Implements snapshot assembly for homogeneous signals.

    Subclasses set: ``_graph_dynamic`` (bool), ``_signal_static`` (bool),
    ``_has_batch`` (bool), and store the raw numpy inputs under the
    reference attribute names.
    """

    _graph_dynamic = False
    _signal_static = False
    _has_batch = False

    def _init_common(self, kwargs, device=None):
        self.device = resolve_device(device)
        self.additional_feature_keys = []
        for key, value in kwargs.items():
            setattr(self, key, value)
            self.additional_feature_keys.append(key)
        self._check_temporal_consistency()
        self._set_snapshot_count()
        self._graph_cache: Dict[int, Optional[Graph]] = {}
        self._edge_pad = self._compute_edge_pad()

    # --- raw accessors -------------------------------------------------

    def _raw_edge_index(self, t):
        return self.edge_indices[t] if self._graph_dynamic else self.edge_index

    def _raw_edge_weight(self, t):
        return self.edge_weights[t] if self._graph_dynamic else self.edge_weight

    def _raw_features(self, t):
        return self.feature if self._signal_static else self.features[t]

    def _raw_targets(self, t):
        return self.targets[t]

    def _raw_batch(self, t):
        if not self._has_batch:
            return None
        return self.batches[t] if self._graph_dynamic else self.batches

    def _num_time_steps(self):
        if self._signal_static:
            return len(self.targets)
        return len(self.features)

    # --- consistency ----------------------------------------------------

    def _check_temporal_consistency(self):
        n = self._num_time_steps()
        assert n == len(self.targets), "Temporal dimension inconsistency."
        if self._graph_dynamic:
            assert n == len(self.edge_indices), "Temporal dimension inconsistency."
            assert n == len(self.edge_weights), "Temporal dimension inconsistency."
            if self._has_batch:
                assert n == len(self.batches), "Temporal dimension inconsistency."
        for key in self.additional_feature_keys:
            assert n == len(getattr(self, key)), "Temporal dimension inconsistency."

    def _set_snapshot_count(self):
        self.snapshot_count = self._num_time_steps()

    def _compute_edge_pad(self) -> Optional[int]:
        if not self._graph_dynamic:
            return None
        pad = 1
        for ei in self.edge_indices:
            if ei is not None:
                pad = max(pad, np.asarray(ei).shape[1])
        return pad

    # --- snapshot assembly ---------------------------------------------

    def _graph_at(self, t: int) -> Optional[Graph]:
        ckey = t if self._graph_dynamic else -1
        if ckey in self._graph_cache:
            return self._graph_cache[ckey]
        ei = self._raw_edge_index(t)
        if ei is None:
            g = None
        else:
            ew = self._raw_edge_weight(t)
            num_nodes = self._infer_num_nodes(t, ei)
            g = Graph.from_edge_index(
                ei, ew, num_nodes=num_nodes, pad_to=self._edge_pad,
                device=self.device,
            )
        self._graph_cache[ckey] = g
        return g

    def _infer_num_nodes(self, t, ei) -> int:
        x = self._raw_features(t)
        if x is not None:
            return int(np.asarray(x).shape[0])
        # fall back to the max over the whole sequence for stability
        if not hasattr(self, "_cached_num_nodes"):
            n = int(np.asarray(ei).max()) + 1
            if self._graph_dynamic:
                for e2 in self.edge_indices:
                    if e2 is not None and np.asarray(e2).size:
                        n = max(n, int(np.asarray(e2).max()) + 1)
            self._cached_num_nodes = n
        return self._cached_num_nodes

    def _make_snapshot(self, t: int) -> Snapshot:
        dev = self.device
        additional = {
            key: convert_array(getattr(self, key)[t], dev)
            for key in self.additional_feature_keys
        }
        return Snapshot(
            x=convert_array(self._raw_features(t), dev),
            graph=self._graph_at(t),
            y=convert_array(self._raw_targets(t), dev),
            batch=convert_array(self._raw_batch(t), dev),
            additional=additional,
        )

    def _slice_kwargs(self, s: slice):
        return {
            key: getattr(self, key)[s] for key in self.additional_feature_keys
        }
