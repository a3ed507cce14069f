"""Mixed-precision training: dtype policies, a dynamic loss scale and the
mixed-precision step.

Port of the JAX package's ``train/precision.py``:

- **master parameters in f32** (the optimizer's state too),
- **compute in bf16** (or f16): the step casts the parameters and the
  batch's float tensors once, inside the differentiated function, and the
  models follow their input's dtype,
- **gradients in f32**: the casts are differentiated, so each gradient
  comes back through a cast to its master parameter's dtype.

The casts are explicit — no ``torch.autocast``, whose per-op casting
differs — and touch only floating-point tensors; index tensors pass
through.  They walk tensors, dicts, lists, tuples and dataclass instances
(a :class:`~..ops.graph.Graph` gets its weights cast; an operator's tiles,
held one level down, keep their dtype).  :class:`DynamicLossScale` is the
JAX class's grow/shrink schedule (not ``torch.amp.GradScaler``'s), needed
for f16 only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .state import TrainState, apply_gradients


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
        if all(v is getattr(tree, k) for k, v in changes.items()):
            return tree  # keeps the instance's cached operators
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
f16_policy = Policy(compute_dtype=torch.float16)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _float_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _float_leaves(v)]
    return []


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """AMP-style dynamic loss scale (needed for f16, not for bf16).

    Multiply the loss by ``scale`` before differentiation, divide the
    gradients by it after; on non-finite gradients shrink the scale (and
    skip the update), after ``growth_interval`` consecutive finite steps
    grow it.  ``scale`` (f32) and ``steps_since_growth`` (int32) are
    0-d tensors, and :meth:`adjust` computes on their device.
    """

    scale: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(2.0 ** 15, dtype=torch.float32))
    steps_since_growth: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(0, dtype=torch.int32))
    growth_factor: float = 2.0
    shrink_factor: float = 0.5
    growth_interval: int = 2000

    def scale_loss(self, loss):
        return loss * self.scale.to(loss.device, loss.dtype)

    def unscale(self, grads):
        inv = (1.0 / self.scale).to(torch.float32)
        return _tree_map(lambda g: g * inv.to(g.device, g.dtype), grads)

    def adjust(self, grads_finite) -> "DynamicLossScale":
        finite = torch.as_tensor(grads_finite, device=self.scale.device)
        grew = self.steps_since_growth + 1 >= self.growth_interval
        new_scale = torch.where(
            finite,
            torch.where(grew, self.scale * self.growth_factor, self.scale),
            self.scale * self.shrink_factor)
        new_counter = torch.where(
            finite & ~grew, self.steps_since_growth + 1,
            torch.zeros_like(self.steps_since_growth))
        return dataclasses.replace(self, scale=new_scale,
                                   steps_since_growth=new_counter)


def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every float tensor of ``tree`` is finite."""
    leaves = [torch.isfinite(x).all() for x in _float_leaves(tree)]
    if not leaves:
        return torch.tensor(True)
    return torch.stack(leaves).all()


def make_mixed_precision_step(
    loss_fn: Callable,
    optimizer: Optional[torch.optim.Optimizer] = None,
    policy: Policy = bf16_policy,
    dynamic_scale: bool = False,
):
    """Build a mixed-precision training step.

    ``loss_fn(params, *batch) -> scalar`` takes the parameters as a dict by
    name (run the module on them with ``torch.func.functional_call``).  The
    step casts the state's f32 master parameters and the float tensors of
    the batch to ``policy.compute_dtype`` inside the differentiated
    function, so the gradients arrive in f32, and steps the optimizer in
    f32.  ``optimizer`` defaults to the state's (and must be it when
    given).

    Returns ``step(state, *batch) -> (state, loss)`` or, with
    ``dynamic_scale=True``, ``step(state, loss_scale, *batch) -> (state,
    loss_scale, loss)``: a step whose gradients are not all finite leaves
    the parameters, the optimizer's moments and step counts and
    ``state.step`` unchanged, and the scale adapts.  That decision reads
    one flag from the device: the scaled step syncs with the host once a
    step.  A parameter the loss does not reach gets a zero gradient, as
    under ``jax.grad``.
    """

    def grads_of(state, scale, batch):
        master = dict(state.params.named_parameters())
        loss = loss_fn(policy.cast_to_compute(master),
                       *(policy.cast_to_compute(b) for b in batch)).float()
        target = loss if scale is None else scale.scale_loss(loss)
        grads = torch.autograd.grad(target, list(master.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(master.items(), grads)}
        return policy.cast_to_param(grads), loss.detach()

    if not dynamic_scale:

        def step(state: TrainState, *batch):
            grads, loss = grads_of(state, None, batch)
            return apply_gradients(state, grads, optimizer), loss

        return step

    def step_scaled(state: TrainState, scale: DynamicLossScale, *batch):
        grads, loss = grads_of(state, scale, batch)
        grads = scale.unscale(grads)
        finite = all_finite(grads)
        if bool(finite):  # the one host sync of the step
            apply_gradients(state, grads, optimizer)
        return state, scale.adjust(finite), loss

    return step_scaled
