"""Process-group initialization and a cross-rank consistency check.

Port of the JAX package's ``parallel/multihost.py``.  The reference's
multi-worker story is Dask spawning torch-DDP processes
(``examples/indexBatching/DCRNN/pems_ddp.py:198-207``); here every rank is
one process driving one device, joined by ``torch.distributed``.  Data is
fed per rank: each rank loads its own slice of window indices
(``IndexLoader(world_size=..., rank=...)``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from .._device import resolve_device
from .mesh import release_group_of_one


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> dict:
    """Join the process group (a no-op for a single process).

    With ``num_processes > 1``, ``init_process_group`` at
    ``coordinator_address`` (``host:port``, or any ``torch.distributed``
    init method such as ``file://…``) as rank ``process_id``, on
    ``backend`` (default NCCL on CUDA, gloo on the CPU); a CUDA rank takes
    card ``process_id % device_count``.  Returns ``rank`` and
    ``world_size`` for the index loaders, and ``local_devices`` /
    ``global_devices``: one device a process.  A group of one that
    :func:`~.mesh.make_mesh` made before is destroyed first (its meshes
    with it).
    """
    if num_processes is not None and num_processes > 1:
        device = resolve_device(device)
        release_group_of_one()
        if device.type == "cuda":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=_init_method(coordinator_address),
            world_size=num_processes, rank=process_id)
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return {
        "rank": dist.get_rank() if up else 0,
        "world_size": world,
        "local_devices": 1,
        "global_devices": world,
    }


def _tensors(leaf) -> list:
    if isinstance(leaf, torch.nn.Module):
        return [*leaf.parameters(), *leaf.buffers()]
    return [leaf] if isinstance(leaf, torch.Tensor) else []


def assert_same_across_hosts(x) -> None:
    """Cheap cross-rank check that replicated values (a module, tensors in
    containers) agree on every rank: all-gathers one f32 checksum per rank
    and raises AssertionError unless all are close to the first
    (``allclose``'s defaults).  A no-op without a process group or for a
    group of one."""
    leaves = [t for leaf in tree_leaves(
        x, is_leaf=lambda n: isinstance(n, torch.nn.Module))
        for t in _tensors(leaf)]
    if not leaves or not dist.is_initialized() or dist.get_world_size() == 1:
        return
    s = sum(leaf.detach().float().sum() for leaf in leaves).reshape(1)
    gathered = [torch.empty_like(s) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, s)
    host = torch.cat(gathered).cpu()
    if not bool(torch.allclose(host, host[:1].expand_as(host))):
        raise AssertionError("replicated value differs across hosts")
