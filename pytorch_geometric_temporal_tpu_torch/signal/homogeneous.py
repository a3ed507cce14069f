"""The six homogeneous temporal-signal iterator classes.

Port of the JAX package's ``signal/homogeneous.py``; constructor
signatures and iteration semantics match, with one keyword added:
``device`` (CUDA unless ``"cpu"``), where the snapshots' tensors live.
Further keyword arguments are additional per-step feature arrays.

Snapshots are :class:`~.snapshot.Snapshot` objects; the ``batch``
node→graph index vector plays the role of PyG ``Batch.batch``.
"""

from __future__ import annotations

from .base import HomoSignalMixin


class StaticGraphTemporalSignal(HomoSignalMixin):
    """Static graph, temporal features and targets."""

    _graph_dynamic = False
    _signal_static = False
    _has_batch = False

    def __init__(self, edge_index, edge_weight, features, targets,
                 device=None, **kwargs):
        self.edge_index = edge_index
        self.edge_weight = edge_weight
        self.features = features
        self.targets = targets
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return StaticGraphTemporalSignal(
            self.edge_index,
            self.edge_weight,
            self.features[s],
            self.targets[s],
            device=self.device,
            **self._slice_kwargs(s),
        )


class DynamicGraphTemporalSignal(HomoSignalMixin):
    """Per-step edge lists and weights, temporal features and targets."""

    _graph_dynamic = True
    _signal_static = False
    _has_batch = False

    def __init__(self, edge_indices, edge_weights, features, targets,
                 device=None, **kwargs):
        self.edge_indices = edge_indices
        self.edge_weights = edge_weights
        self.features = features
        self.targets = targets
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return DynamicGraphTemporalSignal(
            self.edge_indices[s],
            self.edge_weights[s],
            self.features[s],
            self.targets[s],
            device=self.device,
            **self._slice_kwargs(s),
        )


class DynamicGraphStaticSignal(HomoSignalMixin):
    """Per-step edges; one shared node feature matrix."""

    _graph_dynamic = True
    _signal_static = True
    _has_batch = False

    def __init__(self, edge_indices, edge_weights, feature, targets,
                 device=None, **kwargs):
        self.edge_indices = edge_indices
        self.edge_weights = edge_weights
        self.feature = feature
        self.targets = targets
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return DynamicGraphStaticSignal(
            self.edge_indices[s],
            self.edge_weights[s],
            self.feature,
            self.targets[s],
            device=self.device,
            **self._slice_kwargs(s),
        )


class StaticGraphTemporalSignalBatch(HomoSignalMixin):
    """Static graph + static node→graph batch vector."""

    _graph_dynamic = False
    _signal_static = False
    _has_batch = True

    def __init__(self, edge_index, edge_weight, features, targets, batches,
                 device=None, **kwargs):
        self.edge_index = edge_index
        self.edge_weight = edge_weight
        self.features = features
        self.targets = targets
        self.batches = batches
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return StaticGraphTemporalSignalBatch(
            self.edge_index,
            self.edge_weight,
            self.features[s],
            self.targets[s],
            self.batches,
            device=self.device,
            **self._slice_kwargs(s),
        )


class DynamicGraphTemporalSignalBatch(HomoSignalMixin):
    """Per-step edges, features and batch vectors."""

    _graph_dynamic = True
    _signal_static = False
    _has_batch = True

    def __init__(self, edge_indices, edge_weights, features, targets, batches,
                 device=None, **kwargs):
        self.edge_indices = edge_indices
        self.edge_weights = edge_weights
        self.features = features
        self.targets = targets
        self.batches = batches
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return DynamicGraphTemporalSignalBatch(
            self.edge_indices[s],
            self.edge_weights[s],
            self.features[s],
            self.targets[s],
            self.batches[s],
            device=self.device,
            **self._slice_kwargs(s),
        )


class DynamicGraphStaticSignalBatch(HomoSignalMixin):
    """Per-step edges and batch vectors; one shared feature matrix."""

    _graph_dynamic = True
    _signal_static = True
    _has_batch = True

    def __init__(self, edge_indices, edge_weights, feature, targets, batches,
                 device=None, **kwargs):
        self.edge_indices = edge_indices
        self.edge_weights = edge_weights
        self.feature = feature
        self.targets = targets
        self.batches = batches
        self._init_common(kwargs, device)

    def _slice(self, s: slice):
        return DynamicGraphStaticSignalBatch(
            self.edge_indices[s],
            self.edge_weights[s],
            self.feature,
            self.targets[s],
            self.batches[s],
            device=self.device,
            **self._slice_kwargs(s),
        )
