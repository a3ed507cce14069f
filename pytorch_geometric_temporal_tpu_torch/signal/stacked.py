"""Device-resident stacked signals: the training pipeline's input.

Port of ``StackedSignal`` of the JAX package's ``signal/stacked.py``: the
whole sequence is stacked into tensors on one device once, so an epoch
touches no host data.  ``StackedSignal.from_signal`` consumes any of the
six homogeneous signal iterators; dynamic graphs become (T, E_pad) stacked
edge tensors (already padded to a common E_pad by the signal layer).
``scan`` runs the snapshots through a step function in a Python loop.
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
        """The static graph, or (for dynamic graphs) the graph at step t."""
        if not self.graph_dynamic:
            return Graph(self.senders, self.receivers, self.weights,
                         self.num_nodes, self.num_edges)
        return Graph(self.senders[t], self.receivers[t], self.weights[t],
                     self.num_nodes, self.num_edges)

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
