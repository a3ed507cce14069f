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
for f16 only; it is a pytree node, as the JAX class is, so its two tensors
are a step's inputs and outputs.  On a CUDA state the step runs as replays
of CUDA graphs, one a signature of its inputs, as the JAX step compiles
under ``jax.jit`` once a signature.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .state import TrainState, apply_gradients, check_capturable
from .trainer import _DeviceGraphs, _Id


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


pytree.register_pytree_node(
    DynamicLossScale,
    lambda s: ([s.scale, s.steps_since_growth],
               (s.growth_factor, s.shrink_factor, s.growth_interval)),
    lambda leaves, ctx: DynamicLossScale(*leaves, *ctx),
    serialized_type_name=f"{__name__}.DynamicLossScale")


def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every float tensor of ``tree`` is finite.  It lies
    on the device of the tree's tensors (the CPU for a tree of none)."""
    leaves = [torch.isfinite(x).all() for x in _float_leaves(tree)]
    if not leaves:
        found = [t for t in pytree.tree_leaves(tree)
                 if isinstance(t, torch.Tensor)]
        return torch.ones((), dtype=torch.bool,
                          device=found[0].device if found else None)
    return torch.stack(leaves).all()


def _state_tensors(state: TrainState) -> list:
    """Every tensor an update writes: the step, the parameters and the
    optimizer's state."""
    return ([state.step] + list(state.params.parameters())
            + [t for s in state.opt_state.state.values()
               for t in s.values() if isinstance(t, torch.Tensor)])


class _Kept:
    """The values a state had before a scaled step's update, in buffers
    that every step on that state reuses (a captured step writes them in
    place): a skipped update puts them back, with ``torch.where`` on the
    device's flag, as optax's ``apply_if_finite`` keeps the old state."""

    def __init__(self):
        self.tensors, self.buffers = [], []

    def save(self, state: TrainState) -> None:
        tensors = _state_tensors(state)
        if (len(tensors) != len(self.tensors)
                or any(a is not b for a, b in zip(tensors, self.tensors))):
            self.tensors = tensors
            self.buffers = [torch.empty_like(t) for t in tensors]
        with torch.no_grad():
            for b, t in zip(self.buffers, self.tensors):
                b.copy_(t)

    def restore_unless(self, finite: torch.Tensor) -> None:
        with torch.no_grad():
            for b, t in zip(self.buffers, self.tensors):
                torch.where(finite.to(t.device), t, b, out=t)


def make_mixed_precision_step(
    loss_fn: Callable,
    optimizer: Optional[torch.optim.Optimizer] = None,
    policy: Policy = bf16_policy,
    dynamic_scale: bool = False,
    capture: Optional[bool] = None,
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
    the parameters, the optimizer's state and ``state.step`` unchanged, and
    the scale adapts.  The update runs and ``torch.where`` on the device's
    finite flag keeps the new or the old value of each of those tensors,
    as the JAX step's ``jnp.where`` does: no step reads anything on the
    host.  A parameter the loss does not reach gets a zero gradient, as
    under ``jax.grad``.

    ``capture``: on a CUDA state the step runs as replays of CUDA graphs
    (``capture=None``, the default there; ``capture=False`` runs every
    operation from Python, as on the CPU; True on the CPU raises), as the
    trainers' steps do: a signature's first call runs eagerly, the second
    captures, later ones replay.  A signature is the batch's and the
    scale's shapes, strides and dtypes and the identity of the state, its
    module, optimizer and step: a graph reads and writes their tensors in
    place (load into them with ``TrainState.load_state_dict``, which
    copies).  The optimizer must be capturable (``TrainState.create``
    turns Adam's ``capturable`` on for CUDA parameters); keep the scale on
    the state's device.  ``step.graphs.captures`` and ``.replays`` count
    the graphs and replays.
    """
    name = ("make_mixed_precision_step" if not dynamic_scale
            else "make_mixed_precision_step(dynamic_scale=True)")
    graphs = _DeviceGraphs(name, capture)
    kept = {}       # a state's _Kept, by the state's identity

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

    def update(state, scale, batch):
        grads, loss = grads_of(state, scale, batch)
        if scale is None:
            apply_gradients(state, grads, optimizer)
            return loss
        grads = scale.unscale(grads)
        finite = all_finite(grads)
        keep = kept.setdefault(_Id(state), _Kept())
        keep.save(state)
        apply_gradients(state, grads, optimizer)
        keep.restore_unless(finite)
        return scale.adjust(finite), loss

    def run(state, args, fn):
        device = next(state.params.parameters()).device
        if graphs.captures_on(device):
            check_capturable(state, name)
        return graphs(device, fn, args, held=(
            state, state.params, state.opt_state, state.step))

    if not dynamic_scale:

        def step(state: TrainState, *batch):
            return state, run(state, batch,
                              lambda *b: update(state, None, b))

    else:

        def step(state: TrainState, scale: DynamicLossScale, *batch):
            new_scale, loss = run(state, (scale,) + batch,
                                  lambda s, *b: update(state, s, b))
            return state, new_scale, loss

    step.graphs = graphs
    return step
