"""Device-resident stacked signals: the training pipeline's input.

Port of the JAX package's ``signal/stacked.py``: the whole sequence is
stacked into tensors on one device once, so an epoch touches no host data.
``StackedSignal.from_signal`` consumes any of the six homogeneous signal
iterators, ``StackedHeteroSignal.from_signal`` any of the six
heterogeneous ones; dynamic graphs become (T, E_pad) stacked edge tensors
(already padded to a common E_pad by the signal layer).  ``scan`` runs the
snapshots through a step function in a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..ops.graph import Graph, pad_graphs
from .snapshot import convert_array


def _stack_outputs(outs):
    """Stack the per-step outputs as ``lax.scan`` stacks its ys: tensors
    along a new leading axis, containers leaf by leaf, ``()``/None as is."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_outputs([o[i] for o in outs])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack_outputs([o[k] for o in outs]) for k in first}
    return first


@dataclasses.dataclass(frozen=True)
class StackedSignal:
    """Whole temporal signal as stacked tensors on one device.

    features: (T, N, F) — static-signal variants are broadcast over T.
    targets:  (T, ...)
    senders/receivers/weights: (E,) when the graph is static, (T, E) when
        dynamic (padded to a common E).
    additional: dict of (T, ...) stacked extra features.
    batches: node→graph assignment from the *Batch signal variants — (N,)
        for a static graph, (T, N) when dynamic; None for plain signals.
        When present, ``scan``'s step receives it as a 5th argument.
    """

    features: torch.Tensor
    targets: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    weights: torch.Tensor
    additional: Dict[str, torch.Tensor]
    num_nodes: int
    num_edges: int
    graph_dynamic: bool
    batches: Optional[torch.Tensor] = None

    @property
    def snapshot_count(self) -> int:
        return self.targets.shape[0]

    @property
    def device(self) -> torch.device:
        return self.features.device

    def graph(self, t: Optional[int] = None) -> Graph:
        """The static graph, or (for dynamic graphs) the graph at step t.

        Each is built once and kept on the signal, so the operators that
        models derive from a graph (memoized on the instance) are built in
        the first epoch only, and a captured epoch finds them built."""
        key = None if not self.graph_dynamic else int(t)
        cache = self.__dict__.setdefault("_graphs", {})
        g = cache.get(key)
        if g is None:
            if key is None:
                g = Graph(self.senders, self.receivers, self.weights,
                          self.num_nodes, self.num_edges)
            else:
                g = Graph(self.senders[t], self.receivers[t],
                          self.weights[t], self.num_nodes, self.num_edges)
            cache[key] = g
        return g

    @staticmethod
    def from_signal(signal, device=None) -> "StackedSignal":
        """Stack any homogeneous signal iterator into tensors on ``device``
        (default: the signal's)."""
        device = signal.device if device is None else resolve_device(device)
        T = signal.snapshot_count
        feats = np.stack(
            [np.asarray(signal._raw_features(t)) for t in range(T)])
        targets = np.stack(
            [np.asarray(signal._raw_targets(t)) for t in range(T)])
        additional = {
            key: np.stack([np.asarray(getattr(signal, key)[t])
                           for t in range(T)])
            for key in signal.additional_feature_keys
        }
        graph_dynamic = bool(signal._graph_dynamic)
        if graph_dynamic:
            graphs = [signal._graph_at(t) for t in range(T)]
            senders = torch.stack([g.senders for g in graphs])
            receivers = torch.stack([g.receivers for g in graphs])
            weights = torch.stack([g.masked_weights() for g in graphs])
            num_nodes = graphs[0].num_nodes
            num_edges = max(g.num_edges for g in graphs)
        else:
            g = signal._graph_at(0)
            senders, receivers, weights = g.senders, g.receivers, g.weights
            num_nodes, num_edges = g.num_nodes, g.num_edges
        batches = None
        if signal._has_batch:
            if graph_dynamic:
                batches = convert_array(
                    np.stack([np.asarray(signal._raw_batch(t))
                              for t in range(T)]), device)
            else:
                batches = convert_array(np.asarray(signal._raw_batch(0)),
                                        device)
        return StackedSignal(
            batches=batches,
            features=convert_array(feats, device),
            targets=convert_array(targets, device),
            senders=senders.to(device),
            receivers=receivers.to(device),
            weights=weights.to(device),
            additional={k: convert_array(v, device)
                        for k, v in additional.items()},
            num_nodes=num_nodes,
            num_edges=num_edges,
            graph_dynamic=graph_dynamic,
        )

    @staticmethod
    def from_arrays(features, targets, edge_indices, edge_weights=None,
                    num_nodes: Optional[int] = None,
                    device=None) -> "StackedSignal":
        """Raw arrays straight to a stacked signal on ``device`` (CUDA
        unless ``"cpu"``).

        ``edge_indices``: one (2, E) array for a static graph, or a
        length-T sequence of ragged (2, E_t) arrays for a dynamic graph —
        per-step edge lists are padded to a common maximum internally.
        ``edge_weights`` matches (None means unit weights).  ``features``
        is (T, N, ...) and ``targets`` (T, ...).
        """
        device = resolve_device(device)
        feats = np.asarray(features)
        targs = np.asarray(targets)
        T = feats.shape[0]
        if targs.shape[0] != T:
            raise ValueError(
                f"features have {T} steps but targets have {targs.shape[0]}")
        dynamic = not (hasattr(edge_indices, "ndim")
                       and np.asarray(edge_indices).ndim == 2)
        if num_nodes is None:
            num_nodes = feats.shape[1]
        if dynamic:
            if len(edge_indices) != T:
                raise ValueError(
                    f"dynamic edge list has {len(edge_indices)} steps, "
                    f"features have {T}")
            graphs = pad_graphs([
                Graph.from_edge_index(
                    ei, None if edge_weights is None else edge_weights[t],
                    num_nodes=num_nodes, device=device)
                for t, ei in enumerate(edge_indices)
            ])
            senders = torch.stack([g.senders for g in graphs])
            receivers = torch.stack([g.receivers for g in graphs])
            weights = torch.stack([g.masked_weights() for g in graphs])
            num_edges = max(g.num_edges for g in graphs)
        else:
            g = Graph.from_edge_index(edge_indices, edge_weights,
                                      num_nodes=num_nodes, device=device)
            senders, receivers, weights = g.senders, g.receivers, g.weights
            num_edges = g.num_edges
        return StackedSignal(
            features=convert_array(feats, device),
            targets=convert_array(targs, device),
            senders=senders,
            receivers=receivers,
            weights=weights,
            additional={},
            num_nodes=int(num_nodes),
            num_edges=int(num_edges),
            graph_dynamic=dynamic,
        )

    def scan(self, step: Callable, init_carry):
        """Run ``step(carry, x_t, y_t, graph_t) -> (carry, out)`` over all
        snapshots in order; returns ``(carry, outs)`` with the per-step
        outputs stacked along a new leading axis.  A static graph is built
        once and handed to every step.

        For *Batch signals (``batches is not None``) the step instead takes
        ``step(carry, x_t, y_t, graph_t, batch_t)``.
        """
        has_batch = self.batches is not None
        g_static = None if self.graph_dynamic else self.graph()
        carry, outs = init_carry, []
        for t in range(self.snapshot_count):
            args = (carry, self.features[t], self.targets[t],
                    self.graph(t) if self.graph_dynamic else g_static)
            if has_batch:
                args += (self.batches[t] if self.graph_dynamic
                         else self.batches,)
            carry, out = step(*args)
            outs.append(out)
        return carry, (_stack_outputs(outs) if outs else ())


@dataclasses.dataclass(frozen=True)
class StackedHeteroSignal:
    """Whole heterogeneous temporal signal as stacked tensors on one device.

    x_dicts / y_dicts: {node_type: (T, n_t, ...)}.
    edge_*: {edge_type: (E,) or (T, E)} tensors; ``edge_meta`` maps each
    edge type to (num_nodes_dst, num_edges, num_src).
    batch_dicts: {node_type: (n_t,) or (T, n_t)} node→graph assignment from
    the hetero *Batch variants (empty for plain signals).  When non-empty,
    ``scan``'s step receives it as a 5th argument.

    Every step must carry the same node and edge types (None-skipping is a
    feature of the iterators; stacking needs uniform presence).
    """

    x_dicts: Dict[str, torch.Tensor]
    y_dicts: Dict[str, torch.Tensor]
    edge_senders: Dict[tuple, torch.Tensor]
    edge_receivers: Dict[tuple, torch.Tensor]
    edge_weights: Dict[tuple, torch.Tensor]
    edge_meta: tuple  # sorted ((edge_type, (n_dst, n_edges, n_src)), ...)
    graph_dynamic: bool
    batch_dicts: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    @property
    def _meta(self) -> dict:
        return dict(self.edge_meta)

    @property
    def snapshot_count(self) -> int:
        return next(iter(self.y_dicts.values())).shape[0]

    def edge_graphs(self, t: Optional[int] = None):
        """The static graphs, or (dynamic) the graphs at step ``t``."""
        out = {}
        meta = self._meta
        for k in self.edge_senders:
            n_dst, n_edges, n_src = meta[k]
            if self.graph_dynamic:
                out[k] = Graph(self.edge_senders[k][t],
                               self.edge_receivers[k][t],
                               self.edge_weights[k][t], n_dst, n_edges, n_src)
            else:
                out[k] = Graph(self.edge_senders[k], self.edge_receivers[k],
                               self.edge_weights[k], n_dst, n_edges, n_src)
        return out

    @staticmethod
    def from_signal(signal, device=None) -> "StackedHeteroSignal":
        """Stack any heterogeneous signal iterator into tensors on
        ``device`` (default: the signal's)."""
        device = signal.device if device is None else resolve_device(device)
        T = signal.snapshot_count
        snaps = [signal[t] for t in range(T)]
        keys_x, keys_y = set(snaps[0].x_dict), set(snaps[0].y_dict)
        for s in snaps:
            if set(s.x_dict) != keys_x or set(s.y_dict) != keys_y:
                raise ValueError(
                    "StackedHeteroSignal requires uniform node-type keys "
                    "across all snapshots")
        x_dicts = {nt: torch.stack([s.x_dict[nt] for s in snaps]).to(device)
                   for nt in keys_x}
        y_dicts = {nt: torch.stack([s.y_dict[nt] for s in snaps]).to(device)
                   for nt in keys_y}
        graph_dynamic = bool(signal._graph_dynamic)
        senders, receivers, weights, meta = {}, {}, {}, {}
        for k, g in snaps[0].edge_graphs.items():
            if graph_dynamic:
                steps = [s.edge_graphs[k] for s in snaps]
                meta[k] = (g.num_nodes, max(h.num_edges for h in steps),
                           g.num_src)
                senders[k] = torch.stack([h.senders for h in steps])
                receivers[k] = torch.stack([h.receivers for h in steps])
                weights[k] = torch.stack([h.masked_weights() for h in steps])
            else:
                meta[k] = (g.num_nodes, g.num_edges, g.num_src)
                senders[k], receivers[k], weights[k] = (
                    g.senders, g.receivers, g.weights)
        batch_dicts = {}
        if snaps[0].batch_dict:
            if graph_dynamic:
                batch_dicts = {nt: torch.stack([s.batch_dict[nt]
                                                for s in snaps])
                               for nt in snaps[0].batch_dict}
            else:
                batch_dicts = dict(snaps[0].batch_dict)
        return StackedHeteroSignal(
            x_dicts=x_dicts, y_dicts=y_dicts,
            edge_senders={k: v.to(device) for k, v in senders.items()},
            edge_receivers={k: v.to(device) for k, v in receivers.items()},
            edge_weights={k: v.to(device) for k, v in weights.items()},
            edge_meta=tuple(sorted(meta.items())),
            graph_dynamic=graph_dynamic,
            batch_dicts={k: v.to(device) for k, v in batch_dicts.items()},
        )

    def scan(self, step: Callable, init_carry):
        """Run ``step(carry, x_dict, y_dict, edge_graphs) -> (carry, out)``
        over all snapshots in order; returns ``(carry, outs)`` with the
        per-step outputs stacked along a new leading axis.  Static graphs
        are built once and handed to every step.  For hetero *Batch
        signals (``batch_dicts`` non-empty) the step instead takes
        ``step(carry, x_dict, y_dict, edge_graphs, batch_dict)``."""
        has_batch = bool(self.batch_dicts)
        static = None if self.graph_dynamic else self.edge_graphs()
        carry, outs = init_carry, []
        for t in range(self.snapshot_count):
            args = (carry, {k: v[t] for k, v in self.x_dicts.items()},
                    {k: v[t] for k, v in self.y_dicts.items()},
                    self.edge_graphs(t) if self.graph_dynamic else static)
            if has_batch:
                args += ({k: v[t] for k, v in self.batch_dicts.items()}
                         if self.graph_dynamic else self.batch_dicts,)
            carry, out = step(*args)
            outs.append(out)
        return carry, (_stack_outputs(outs) if outs else ())
