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

On CUDA over NCCL the step runs as replays of CUDA graphs, one a signature
of its batch (the JAX step is ``jax.jit``-compiled), NCCL's all-reduces
inside them.  gloo's collectives go through the host and cannot be
captured: over gloo the step runs eagerly.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._device import resolve_device
from ..train.state import TrainState, apply_gradients, check_capturable
from ..train.trainer import _DeviceGraphs
from .collectives import all_reduce_


def _resolve_dp_capture(capture, device, names, groups) -> bool:
    backends = [str(dist.get_backend(g)) for g in groups]
    over = [f"{n!r} over {b}" for n, b in zip(names, backends) if b != "nccl"]
    if capture is None:
        return device.type == "cuda" and not over
    if capture and over:
        raise ValueError(
            f"capture=True needs NCCL process groups: CUDA graphs capture "
            f"NCCL's collectives, not gloo's, which go through the host "
            f"({', '.join(over)}); pass capture=False")
    return capture


def make_dp_train_step(
    loss_fn: Callable,
    mesh: DeviceMesh,
    axis_name="dp",
    weight_fn: Optional[Callable] = None,
    capture: Optional[bool] = None,
):
    """Build a data-parallel train step.

    Args:
        loss_fn: ``(params, x, y) -> scalar`` with ``params`` the module
            being trained (the loss already includes the model), a mean
            over the entries of this rank's block.
        mesh: a mesh with the ``axis_name`` axis (a name or a tuple of
            names: gradients are summed over each).
        weight_fn: ``(x, y) -> count`` of the entries ``loss_fn`` averages
            over on this rank, a tensor or a number; default
            ``y.numel()``.  For a masked loss pass the mask's count, e.g.
            ``lambda x, y: (y != 0).sum()`` for ``masked_mae_loss``.  A
            captured step takes a number as fixed for the batch's shape.
        capture: run the step as replays of CUDA graphs, one a signature
            of (x, y) and the state (default: when the mesh is CUDA and
            every group it reduces over is NCCL; True over gloo or on the
            CPU raises).  The state's optimizer must be capturable
            (``TrainState.create`` turns Adam's ``capturable`` on for CUDA
            parameters); a graph reads and writes the state's tensors in
            place.

    Returns:
        ``step(state, x, y) -> (state, loss)``: one update of the
        replicated :class:`~..train.state.TrainState` in place by its own
        optimizer (JAX's ``optimizer`` argument lives in the state), and the
        loss of the global batch (the same on every rank).  Two
        all-reduces a step: the entry count, then the gradients and the
        loss in one flat buffer.  ``step.graphs.captures`` and
        ``.replays`` count the graphs and replays.
    """
    device = resolve_device(mesh.device_type)
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    groups = [mesh.get_group(n) for n in names]
    if weight_fn is None:
        weight_fn = lambda x, y: y.numel()  # noqa: E731
    graphs = _DeviceGraphs("make_dp_train_step",
                           _resolve_dp_capture(capture, device, names,
                                               groups))

    def update(state, x, y):
        params = list(state.params.parameters())
        w = weight_fn(x, y)
        dev = params[0].device
        # built on the device: a capture cannot copy a host number over
        count = (torch.as_tensor(w, dtype=torch.float64, device=dev)
                 .reshape(1).clone() if isinstance(w, torch.Tensor)
                 else torch.full((1,), float(w), dtype=torch.float64,
                                 device=dev))
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
        return flat[-1]

    def step(state: TrainState, x, y):
        dev = next(state.params.parameters()).device
        if graphs.captures_on(dev):
            check_capturable(state, "make_dp_train_step")
        return state, graphs(dev, lambda xb, yb: update(state, xb, yb),
                             (x, y), held=(state, state.params,
                                           state.opt_state, state.step))

    step.graphs = graphs
    return step
