"""The six heterogeneous temporal-signal iterator classes.

Port of the JAX package's ``signal/heterogeneous.py``; constructor
signatures and iteration semantics match, with one keyword added:
``device`` (CUDA unless ``"cpu"``), where the snapshots' tensors live.

- ``StaticHeteroGraphTemporalSignal``
- ``DynamicHeteroGraphTemporalSignal``
- ``DynamicHeteroGraphStaticSignal``
- ``StaticHeteroGraphTemporalSignalBatch``
- ``DynamicHeteroGraphTemporalSignalBatch``
- ``DynamicHeteroGraphStaticSignalBatch``

Each emits :class:`~.snapshot.HeteroSnapshot` objects with one bipartite
:class:`~..ops.graph.Graph` per edge type.  None-valued dict entries are
skipped; a node type's count comes from its features, else from the
largest index of an edge type that touches it; dynamic edge sets are
padded per edge type to that type's largest step; graphs are cached per
time step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .._device import resolve_device
from ..ops.graph import Graph
from .base import BaseSignal
from .snapshot import HeteroSnapshot, convert_array


def _convert_dict(d, device):
    if d is None:
        return {}
    return {k: convert_array(v, device) for k, v in d.items()
            if v is not None}


class HeteroSignalMixin(BaseSignal):
    """Snapshot assembly for heterogeneous signals.

    Subclasses set ``_graph_dynamic``, ``_signal_static`` and
    ``_has_batch`` and store the raw inputs under the reference attribute
    names.
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
        self._graph_cache: Dict[int, dict] = {}
        self._edge_pads = self._compute_edge_pads()
        self._node_counts = self._compute_node_counts()

    # --- raw accessors --------------------------------------------------

    def _raw_edges(self, t):
        if self._graph_dynamic:
            return self.edge_index_dicts[t], self.edge_weight_dicts[t]
        return self.edge_index_dict, self.edge_weight_dict

    def _raw_features(self, t):
        return self.feature_dict if self._signal_static else self.feature_dicts[t]

    def _raw_batch(self, t):
        if not self._has_batch:
            return None
        return self.batch_dicts[t] if self._graph_dynamic else self.batch_dict

    def _num_time_steps(self):
        if self._signal_static:
            return len(self.target_dicts)
        return len(self.feature_dicts)

    def _check_temporal_consistency(self):
        n = self._num_time_steps()
        assert n == len(self.target_dicts), "Temporal dimension inconsistency."
        if self._graph_dynamic:
            assert n == len(self.edge_index_dicts), "Temporal dimension inconsistency."
            assert n == len(self.edge_weight_dicts), "Temporal dimension inconsistency."
            if self._has_batch:
                assert n == len(self.batch_dicts), "Temporal dimension inconsistency."
        for key in self.additional_feature_keys:
            assert n == len(getattr(self, key)), "Temporal dimension inconsistency."

    def _set_snapshot_count(self):
        self.snapshot_count = self._num_time_steps()

    # --- static structure -----------------------------------------------

    def _compute_edge_pads(self):
        pads: Dict[tuple, int] = {}
        if not self._graph_dynamic:
            return pads  # one static edge dict needs no padding
        for t in range(self.snapshot_count):
            ei_dict, _ = self._raw_edges(t)
            if ei_dict is None:
                continue
            for k, ei in ei_dict.items():
                if ei is None:
                    continue
                pads[k] = max(pads.get(k, 1), np.asarray(ei).shape[1])
        return pads

    def _compute_node_counts(self):
        counts: Dict[str, int] = {}
        for t in range(self.snapshot_count):
            fd = self._raw_features(t)
            if fd:
                for nt, x in fd.items():
                    if x is not None:
                        counts[nt] = max(counts.get(nt, 0),
                                         np.asarray(x).shape[0])
            if self._signal_static:
                break
        # types without features: the largest index of their edge types
        for t in range(self.snapshot_count):
            ei_dict, _ = self._raw_edges(t)
            if ei_dict:
                for (src, _, dst), ei in ei_dict.items():
                    if ei is None or np.asarray(ei).size == 0:
                        continue
                    ei = np.asarray(ei)
                    counts[src] = max(counts.get(src, 0),
                                      int(ei[0].max()) + 1)
                    counts[dst] = max(counts.get(dst, 0),
                                      int(ei[1].max()) + 1)
            if not self._graph_dynamic:
                break
        return counts

    # --- assembly --------------------------------------------------------

    def _graphs_at(self, t: int):
        ckey = t if self._graph_dynamic else -1
        if ckey in self._graph_cache:
            return self._graph_cache[ckey]
        ei_dict, ew_dict = self._raw_edges(t)
        graphs = {}
        if ei_dict:
            for k, ei in ei_dict.items():
                if ei is None:
                    continue
                src, _, dst = k
                ew = None if ew_dict is None else ew_dict.get(k)
                graphs[k] = Graph.from_edge_index(
                    ei, ew,
                    num_nodes=self._node_counts.get(dst),
                    num_src=self._node_counts.get(src),
                    pad_to=self._edge_pads.get(k),
                    device=self.device,
                )
        self._graph_cache[ckey] = graphs
        return graphs

    def _make_snapshot(self, t: int) -> HeteroSnapshot:
        dev = self.device
        additional = {key: _convert_dict(getattr(self, key)[t], dev)
                      for key in self.additional_feature_keys}
        return HeteroSnapshot(
            x_dict=_convert_dict(self._raw_features(t), dev),
            edge_graphs=self._graphs_at(t),
            y_dict=_convert_dict(self.target_dicts[t], dev),
            batch_dict=_convert_dict(self._raw_batch(t), dev),
            additional=additional,
        )

    def _slice_kwargs(self, s: slice):
        kw = {key: getattr(self, key)[s]
              for key in self.additional_feature_keys}
        kw["device"] = self.device
        return kw


class StaticHeteroGraphTemporalSignal(HeteroSignalMixin):
    def __init__(self, edge_index_dict, edge_weight_dict, feature_dicts,
                 target_dicts, device=None, **kwargs):
        self.edge_index_dict = edge_index_dict
        self.edge_weight_dict = edge_weight_dict
        self.feature_dicts = feature_dicts
        self.target_dicts = target_dicts
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return StaticHeteroGraphTemporalSignal(
            self.edge_index_dict, self.edge_weight_dict,
            self.feature_dicts[s], self.target_dicts[s],
            **self._slice_kwargs(s))


class DynamicHeteroGraphTemporalSignal(HeteroSignalMixin):
    _graph_dynamic = True

    def __init__(self, edge_index_dicts, edge_weight_dicts, feature_dicts,
                 target_dicts, device=None, **kwargs):
        self.edge_index_dicts = edge_index_dicts
        self.edge_weight_dicts = edge_weight_dicts
        self.feature_dicts = feature_dicts
        self.target_dicts = target_dicts
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return DynamicHeteroGraphTemporalSignal(
            self.edge_index_dicts[s], self.edge_weight_dicts[s],
            self.feature_dicts[s], self.target_dicts[s],
            **self._slice_kwargs(s))


class DynamicHeteroGraphStaticSignal(HeteroSignalMixin):
    _graph_dynamic = True
    _signal_static = True

    def __init__(self, edge_index_dicts, edge_weight_dicts, feature_dict,
                 target_dicts, device=None, **kwargs):
        self.edge_index_dicts = edge_index_dicts
        self.edge_weight_dicts = edge_weight_dicts
        self.feature_dict = feature_dict
        self.target_dicts = target_dicts
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return DynamicHeteroGraphStaticSignal(
            self.edge_index_dicts[s], self.edge_weight_dicts[s],
            self.feature_dict, self.target_dicts[s],
            **self._slice_kwargs(s))


class StaticHeteroGraphTemporalSignalBatch(HeteroSignalMixin):
    _has_batch = True

    def __init__(self, edge_index_dict, edge_weight_dict, feature_dicts,
                 target_dicts, batch_dict, device=None, **kwargs):
        self.edge_index_dict = edge_index_dict
        self.edge_weight_dict = edge_weight_dict
        self.feature_dicts = feature_dicts
        self.target_dicts = target_dicts
        self.batch_dict = batch_dict
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return StaticHeteroGraphTemporalSignalBatch(
            self.edge_index_dict, self.edge_weight_dict,
            self.feature_dicts[s], self.target_dicts[s], self.batch_dict,
            **self._slice_kwargs(s))


class DynamicHeteroGraphTemporalSignalBatch(HeteroSignalMixin):
    _graph_dynamic = True
    _has_batch = True

    def __init__(self, edge_index_dicts, edge_weight_dicts, feature_dicts,
                 target_dicts, batch_dicts, device=None, **kwargs):
        self.edge_index_dicts = edge_index_dicts
        self.edge_weight_dicts = edge_weight_dicts
        self.feature_dicts = feature_dicts
        self.target_dicts = target_dicts
        self.batch_dicts = batch_dicts
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return DynamicHeteroGraphTemporalSignalBatch(
            self.edge_index_dicts[s], self.edge_weight_dicts[s],
            self.feature_dicts[s], self.target_dicts[s], self.batch_dicts[s],
            **self._slice_kwargs(s))


class DynamicHeteroGraphStaticSignalBatch(HeteroSignalMixin):
    _graph_dynamic = True
    _signal_static = True
    _has_batch = True

    def __init__(self, edge_index_dicts, edge_weight_dicts, feature_dict,
                 target_dicts, batch_dicts, device=None, **kwargs):
        self.edge_index_dicts = edge_index_dicts
        self.edge_weight_dicts = edge_weight_dicts
        self.feature_dict = feature_dict
        self.target_dicts = target_dicts
        self.batch_dicts = batch_dicts
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return DynamicHeteroGraphStaticSignalBatch(
            self.edge_index_dicts[s], self.edge_weight_dicts[s],
            self.feature_dict, self.target_dicts[s], self.batch_dicts[s],
            **self._slice_kwargs(s))
