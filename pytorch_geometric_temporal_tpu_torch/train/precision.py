"""Dtype policies: where parameters live and where compute happens.

Port of the ``Policy`` casts of the JAX package's ``train/precision.py``:
f32 master parameters, bf16 compute.  The casts are explicit (no autocast)
and touch only floating-point tensors; index tensors pass through.  They
walk tensors, dicts, lists, tuples and dataclass instances (a
:class:`~..ops.graph.Graph` gets its weights cast).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def _cast_floats(tree: Any, dtype) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {
            f.name: _cast_floats(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)
        }
        return dataclasses.replace(tree, **changes)
    return tree


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype policy: where params live, where compute happens."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    output_dtype: Any = torch.float32

    def cast_to_compute(self, tree):
        return _cast_floats(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return _cast_floats(tree, self.param_dtype)

    def cast_output(self, tree):
        return _cast_floats(tree, self.output_dtype)


bf16_policy = Policy()
f32_policy = Policy(compute_dtype=torch.float32)
