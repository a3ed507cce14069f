"""Snapshots — the counterpart of PyG ``Data``.

Port of the homogeneous part of the JAX package's ``signal/snapshot.py``.
A snapshot bundles one time step's node features, graph, targets, optional
batch vector and additional feature arrays as tensors on one device.

Dtype rule: float arrays → float32, integer arrays → int64 (torch's index
type; the JAX package, which defaults to 32 bits, uses int32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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
