"""Data-parallel training step (replaces Dask-DDP).

Port of the JAX package's ``parallel/data_parallel.py``.  Reference
equivalent: ``DistributedSampler`` shards window indices and DDP
all-reduces gradients (``pems_ddp.py:83-85``, ``metr_la.py:220-228``).
The JAX step differentiates the loss of the whole sharded batch; here each
rank holds its block of the batch (:func:`~.mesh.shard_batch`, or
``IndexLoader(world_size=..., rank=...)``), parameters are replicated
(:func:`~.mesh.replicate`), and the step all-reduces over the mesh axis
what makes the result the JAX one.

A loss that is a mean over entries is not the mean of the ranks' means
when the ranks count different entries: ``masked_mae_loss`` divides by the
mask's count, and PeMS and METR-LA have zeros in y, so shards differ.  Each
rank's loss is therefore weighted by its share of the global count
(``weight_fn``, summed over the ranks before the backward pass and
detached), and the weighted losses and their gradients are summed: the
global loss and its gradient.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from .._device import resolve_device
from ..train.state import TrainState, apply_gradients
from .collectives import all_reduce_


def make_dp_train_step(
    loss_fn: Callable,
    mesh: DeviceMesh,
    axis_name="dp",
    weight_fn: Optional[Callable] = None,
):
    """Build a data-parallel train step.

    Args:
        loss_fn: ``(params, x, y) -> scalar`` with ``params`` the module
            being trained (the loss already includes the model), a mean
            over the entries of this rank's block.
        mesh: a mesh with the ``axis_name`` axis (a name or a tuple of
            names: gradients are summed over each).
        weight_fn: ``(x, y) -> count`` of the entries ``loss_fn`` averages
            over on this rank; default ``y.numel()``.  For a masked loss
            pass the mask's count, e.g. ``lambda x, y: (y != 0).sum()``
            for ``masked_mae_loss``.

    Returns:
        ``step(state, x, y) -> (state, loss)``: one update of the
        replicated :class:`~..train.state.TrainState` in place by its own
        optimizer (JAX's ``optimizer`` argument lives in the state), and the
        loss of the global batch (the same on every rank).  Two
        all-reduces a step: the entry count, then the gradients and the
        loss in one flat buffer.
    """
    resolve_device(mesh.device_type)
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    groups = [mesh.get_group(n) for n in names]
    if weight_fn is None:
        weight_fn = lambda x, y: y.numel()  # noqa: E731

    def step(state: TrainState, x, y):
        params = list(state.params.parameters())
        count = torch.as_tensor(weight_fn(x, y), dtype=torch.float64,
                                device=params[0].device).reshape(1).clone()
        total = all_reduce_(count.clone(), groups)
        share = (count / total.clamp(min=1.0)).float()
        loss = loss_fn(state.params, x, y) * share.to(params[0].dtype)[0]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for p, g in zip(params, grads)]
                         + [loss.detach().reshape(1).to(params[0].dtype)])
        all_reduce_(flat, groups)
        named, offset = {}, 0
        for (name, p) in state.params.named_parameters():
            named[name] = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        apply_gradients(state, named)
        return state, flat[-1]

    return step
