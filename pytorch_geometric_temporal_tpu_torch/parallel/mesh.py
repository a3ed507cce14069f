"""Device meshes over process groups.

Port of the JAX package's ``parallel/mesh.py``.  A JAX mesh names the axes
of an array of devices and ``jit`` places arrays by ``PartitionSpec``; here
one process drives one device, a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, and placing a batch means each rank keeping its own block:
``shard_batch`` returns this rank's block of the leading dim, as
``PartitionSpec(axis)`` splits it, and ``replicate`` broadcasts from the
group's first rank.  ``named_sharding`` returns the ``torch.distributed.
tensor`` placements of a spec, for callers that build ``DTensor``s.
"""

from __future__ import annotations

import atexit
import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._pytree import tree_map

from .._device import resolve_device

_group_of_one = None    # the default group make_mesh made, while it stands


def release_group_of_one() -> None:
    """Destroy the group of one :func:`make_mesh` made, if it is still the
    default group (at exit, and before joining a real group)."""
    global _group_of_one
    if (_group_of_one is not None and dist.is_initialized()
            and dist.group.WORLD is _group_of_one):
        dist.destroy_process_group()
    _group_of_one = None


atexit.register(release_group_of_one)


def make_mesh(axes: Dict[str, int], device=None) -> DeviceMesh:
    """A mesh with named axes over the ranks, e.g. ``make_mesh({'dp': 2,
    'graph': 2})``; its device type is ``device``'s (CUDA unless given
    ``device="cpu"``).

    An axis size of -1 absorbs the remaining ranks; a mesh smaller than the
    world takes its first ranks (the others hold no coordinate in it).
    Every rank of the default group makes each mesh, in the same order.
    With no process group yet, a single process gets a group of one (in
    memory: no address, no network), as a single JAX process has a mesh
    of its local devices.  That group becomes the process's default group
    (NCCL on CUDA, gloo on the CPU) until
    :func:`~.multihost.initialize` joins a real one or the process exits.
    """
    global _group_of_one
    device = resolve_device(device)
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
        _group_of_one = dist.group.WORLD
    world = dist.get_world_size()
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        sizes[sizes.index(-1)] = world // known
    total = math.prod(sizes)
    if total > world or total < 1:
        raise ValueError(f"mesh needs {total} devices, have {world}")
    return init_device_mesh(device.type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh[axis_name].size()


def named_sharding(mesh: DeviceMesh, *spec) -> tuple:
    """The ``torch.distributed.tensor`` placements of a ``PartitionSpec``:
    one per mesh dim, ``Shard(i)`` where the spec names that dim at tensor
    dim i (alone or in a tuple), ``Replicate()`` where it names it nowhere.
    ``named_sharding(mesh)`` replicates."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for i, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is None:
                continue
            if name not in mesh.mesh_dim_names:
                raise ValueError(f"{name!r} is not an axis of the mesh "
                                 f"{mesh.mesh_dim_names}")
            where[name] = i
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in mesh.mesh_dim_names)


def _broadcast(t: torch.Tensor, groups: Sequence) -> None:
    for group in groups:
        dist.broadcast(t, src=dist.get_process_group_ranks(group)[0],
                       group=group)


def replicate(tree, mesh: DeviceMesh):
    """Every rank of the mesh takes the first rank's values.

    A module's parameters and buffers are overwritten in place and the
    module returned; tensors and numpy arrays in dicts, lists and tuples
    come back as new tensors on the mesh's device.  The broadcast runs
    along each mesh dim from its coordinate 0, so after the last one every
    rank holds the values of the rank at (0, …, 0).
    """
    device = resolve_device(mesh.device_type)
    groups = [mesh.get_group(i) for i in range(mesh.ndim)]
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                _broadcast(t.data, groups)
        return tree

    def put(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        t = torch.as_tensor(x).to(device, copy=True).contiguous()
        _broadcast(t, groups)
        return t

    return tree_map(put, tree)


def shard_batch(tree, mesh: DeviceMesh, axis_name: str = "dp"):
    """This rank's block of every array's leading dim over ``axis_name``
    (data parallel), on the mesh's device: the rank at coordinate i along
    the axis of size P takes rows [i·B/P, (i+1)·B/P).  Raises when P does
    not divide the leading dim, as the JAX placement does."""
    device = resolve_device(mesh.device_type)
    p = axis_size(mesh, axis_name)
    i = mesh.get_local_rank(axis_name)

    def put(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        n = x.shape[0]
        if n % p:
            raise ValueError(f"leading dim {n} does not split over "
                             f"{axis_name!r} of size {p}")
        return torch.as_tensor(x[i * (n // p):(i + 1) * (n // p)]).to(device)

    return tree_map(put, tree)
