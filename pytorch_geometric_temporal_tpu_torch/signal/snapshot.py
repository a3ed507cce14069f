"""Snapshots — the counterpart of PyG ``Data``.

Port of the JAX package's ``signal/snapshot.py``.  A snapshot bundles one
time step's node features, graph, targets, optional batch vector and
additional feature arrays as tensors on one device; a
:class:`HeteroSnapshot` holds them per node type and edge type.

Dtype rule: float arrays → float32, integer arrays → int64 (torch's index
type; the JAX package, which defaults to 32 bits, uses int32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.graph import Graph


def convert_array(value, device="cpu"):
    """numpy → tensor on ``device`` with the dtype rule above; None passes
    through."""
    if value is None:
        return None
    arr = np.asarray(value)
    if arr.dtype.kind in "iu":
        return torch.as_tensor(arr.astype(np.int64), device=device)
    if arr.dtype.kind == "f":
        return torch.as_tensor(arr.astype(np.float32), device=device)
    return torch.as_tensor(arr, device=device)


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One homogeneous temporal snapshot (≈ PyG ``Data``)."""

    x: Optional[torch.Tensor] = None
    graph: Optional[Graph] = None
    y: Optional[torch.Tensor] = None
    batch: Optional[torch.Tensor] = None
    additional: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def edge_index(self):
        if self.graph is None:
            return None
        return torch.stack([self.graph.senders, self.graph.receivers])

    @property
    def edge_attr(self):
        return None if self.graph is None else self.graph.weights

    @property
    def edge_weight(self):
        return self.edge_attr

    def __getattr__(self, name):
        add = object.__getattribute__(self, "additional")
        if name in add:
            return add[name]
        raise AttributeError(name)


@dataclasses.dataclass(frozen=True)
class HeteroSnapshot:
    """One heterogeneous snapshot (≈ PyG ``HeteroData``).

    ``edge_graphs`` maps edge-type tuples (src, rel, dst) to bipartite
    :class:`Graph` objects; ``x_dict``/``y_dict`` map node types to tensors.
    """

    x_dict: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    edge_graphs: Dict[Tuple[str, str, str], Graph] = dataclasses.field(
        default_factory=dict)
    y_dict: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    batch_dict: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    additional: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)

    @property
    def edge_index_dict(self):
        return {k: torch.stack([g.senders, g.receivers])
                for k, g in self.edge_graphs.items()}

    @property
    def edge_weight_dict(self):
        return {k: g.weights for k, g in self.edge_graphs.items()}
