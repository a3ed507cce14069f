"""Node-partitioned DCRNN: the north-star model parallelism.

Port of the JAX package's ``parallel/partitioned_dcrnn.py``.  The
reference's only distributed story replicates the graph on every worker and
shards window indices (Dask-DDP); here the graph's nodes are partitioned
across the 'graph' mesh axis, every diffusion hop runs through
:func:`~.partition.spmm_partitioned` with the halo all-to-all exchange, and
the GRU gating is purely local.

Layout is node-leading: each rank holds its (nodes_per_part, B, F) block of
the (N_pad, B, F) features, so every elementwise and gate op is
node-parallel.

Parameter compatibility: :class:`DCRNNPartitioned` is
:class:`~..models.recurrent.dcrnn.DCRNN` with another basis, so its
parameters have DCRNN's names and shapes: a flax tree of a single-device
DCRNN loads with ``params_from_flax``, and a single-device module's
``state_dict`` with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models._cells import FlaxModule
from ..models.recurrent.dcrnn import DCRNN
from ..ops.graph import Graph
from ..ops.operators import host_diffusion_norms
from .partition import PartitionedGraph, spmm_partitioned


class PartitionedDiffusionOperators:
    """Host-built bidirectional diffusion operators, halo-partitioned.

    Build once from the raw graph; the normalized P_fwd / P_bwd edge sets
    are each partitioned by receiver with the interior/boundary halo split.
    """

    def __init__(self, p_fwd: PartitionedGraph, p_bwd: PartitionedGraph):
        self.p_fwd = p_fwd
        self.p_bwd = p_bwd

    @staticmethod
    def from_graph(graph: Graph, num_parts: int
                   ) -> "PartitionedDiffusionOperators":
        """Normalize on the host (``host_diffusion_norms``) and partition;
        the arrays go to the graph's device."""
        f, b = host_diffusion_norms(graph)
        return PartitionedDiffusionOperators(
            PartitionedGraph.from_graph(f, num_parts, by="halo"),
            PartitionedGraph.from_graph(b, num_parts, by="halo"),
        )

    @property
    def padded_nodes(self) -> int:
        return self.p_fwd.padded_nodes

    def pad_features(self, x) -> torch.Tensor:
        """Pad NODE-LEADING features (N, ...) to (N_pad, ...)."""
        return self.p_fwd.pad_features(x, node_axis=0)

    def shard_features(self, x, mesh: DeviceMesh,
                       axis_name: str = "graph") -> torch.Tensor:
        """Pad NODE-LEADING features (N, ...) and take this rank's block."""
        return self.p_fwd.shard_features(x, mesh, axis_name, node_axis=0)


def partitioned_diffusion_basis(pops: PartitionedDiffusionOperators,
                                x: torch.Tensor, K: int, mesh: DeviceMesh,
                                axis_name: str = "graph") -> torch.Tensor:
    """Stacked bidirectional diffusion basis over the partitioned operators.

    Same math and layout as :func:`~..models.recurrent.dcrnn.
    diffusion_basis` (``[T_0^f .. T_{K-1}^f | T_0^b .. T_{K-1}^b]`` on the
    feature axis), but node-leading: x is this rank's (npp, ..., F) block,
    and every hop is one halo-exchange aggregation.
    """
    out = []
    for p in (pops.p_fwd, pops.p_bwd):
        tx = [x]
        if K > 1:
            tx.append(spmm_partitioned(p, x, mesh, axis_name, "halo"))
        for _ in range(2, K):
            tx.append(2.0 * spmm_partitioned(p, tx[-1], mesh, axis_name,
                                             "halo") - tx[-2])
        out.extend(tx)
    return torch.cat(out, dim=-1)


class DCRNNPartitioned(DCRNN):
    """Diffusion-convolutional GRU cell over a node-partitioned graph.

    forward: (X (npp, B, F), pops, mesh, H=None) -> H (npp, B, C), this
    rank's node block throughout.  Parameters are interchangeable with
    :class:`~..models.recurrent.dcrnn.DCRNN`'s.
    """

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 use_bias: bool = True, axis_name: str = "graph",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, K, use_bias,
                         device=device, generator=generator)
        self.axis_name = axis_name

    def forward(self, x: torch.Tensor, pops: PartitionedDiffusionOperators,
                mesh: DeviceMesh,
                h: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.update(x, h, lambda z: partitioned_diffusion_basis(
            pops, z, self.K, mesh, self.axis_name))


class DCRNNPartitionedSeq(FlaxModule):
    """Sequence-to-sequence partitioned DCRNN over (T, npp, B, F) inputs
    (this rank's node block of (T, N_pad, B, F)).

    Node-leading counterpart of :class:`~..models.recurrent.dcrnn.DCRNNSeq`
    (time leads so each step is a contiguous slice); returns all hidden
    states (T, npp, B, C).  Its parameters are ``cell.*``, as DCRNNSeq's.
    """

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 use_bias: bool = True, axis_name: str = "graph",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = out_channels
        self.cell = DCRNNPartitioned(in_channels, out_channels, K, use_bias,
                                     axis_name, device=device,
                                     generator=generator)

    def forward(self, x: torch.Tensor, pops: PartitionedDiffusionOperators,
                mesh: DeviceMesh,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(
                f"DCRNNPartitionedSeq expects input (T, N_pad, B, F); got "
                f"shape {tuple(x.shape)}")
        T, N, B, _ = x.shape
        h = h0 if h0 is not None else x.new_zeros((N, B, self.out_channels))
        hs = []
        for t in range(T):
            h = self.cell(x[t], pops, mesh, h)
            hs.append(h)
        return torch.stack(hs)
