"""Collectives over a process group, differentiable where a model needs
them, with a counter of the bytes each rank sends.

The JAX package leaves its collectives to XLA (``all_gather``,
``psum_scatter``, ``all_to_all`` inside ``shard_map``, and the gradient
all-reduce a sharded ``jit`` emits).  Here each is a ``torch.distributed``
call: the three exchanges of :func:`~.partition.spmm_partitioned` are
autograd functions whose backward is the transposed collective (all-gather
and reduce-scatter are each other's transpose, all-to-all is its own), and
:func:`all_reduce_` sums gradients for the data-parallel step.

``collective_bytes`` counts, by collective, the bytes this rank sends under
the ring algorithm (the count ``PartitionedGraph.ici_bytes_per_step``
predicts), whatever the fabric or backend: an all-gather of a local (n, F)
block over P ranks sends (P-1)·n·F elements, a reduce-scatter of (P·n, F)
partials the same, an all-to-all of P blocks every block but its own, an
all-reduce of B bytes 2·(P-1)·B/P.  Each call adds to the count where it
issues its collective, backward passes included; a group of one sends
nothing.  The count is process-wide, like the kernels' launch counters:
read it after the work and reset it with :func:`reset_collective_bytes`.
A captured step's collectives are counted at each replay (``_counters``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .. import _counters

collective_bytes = {"all_gather": 0, "reduce_scatter": 0, "all_to_all": 0,
                    "all_reduce": 0}

# ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` were renamed
# ``all_gather_single`` and ``reduce_scatter_single`` (the old names warn
# from torch 2.13 on, and older releases have only them)
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def reset_collective_bytes() -> None:
    for key in collective_bytes:
        collective_bytes[key] = 0


def _add_collective_bytes(delta) -> None:
    for key, d in zip(collective_bytes, delta):
        collective_bytes[key] += d


_counters.register("collective_bytes",
                   lambda: tuple(collective_bytes.values()),
                   _add_collective_bytes)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    p = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((p * x.shape[0],) + x.shape[1:])
    _all_gather_single(out, x, group=group)
    collective_bytes["all_gather"] += (p - 1) * x.numel() * x.element_size()
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    p = dist.get_world_size(group)
    if x.shape[0] % p:
        raise ValueError(f"reduce-scatter of {x.shape[0]} rows over {p} "
                         f"ranks")
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // p,) + x.shape[1:])
    _reduce_scatter_single(out, x, group=group)
    collective_bytes["reduce_scatter"] += ((p - 1) * out.numel()
                                           * out.element_size())
    return out


def _swap(x: torch.Tensor, group) -> torch.Tensor:
    p = dist.get_world_size(group)
    if x.shape[0] != p:
        raise ValueError(f"all-to-all of {x.shape[0]} blocks over {p} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    collective_bytes["all_to_all"] += ((p - 1) * (x.numel() // p)
                                       * x.element_size())
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _swap(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _swap(grad, ctx.group), None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) on each rank -> (P·n, ...), the ranks' blocks in group
    order.  Backward: reduce-scatter of the gradient."""
    return _AllGather.apply(x, group)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """(P·n, ...) partials on each rank -> this rank's (n, ...) block of
    their sum.  Backward: all-gather of the gradient."""
    return _ReduceScatter.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(P, ...) blocks on each rank: block q goes to rank q, and block q of
    the result came from rank q.  Backward: the same exchange."""
    return _AllToAll.apply(x, group)


def all_reduce_(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """Sum ``x`` in place over each group in turn (over every rank of the
    mesh dims the groups span); not differentiable."""
    for group in groups:
        p = dist.get_world_size(group)
        dist.all_reduce(x, group=group)
        collective_bytes["all_reduce"] += (2 * (p - 1) * x.numel()
                                           * x.element_size() // p)
    return x
