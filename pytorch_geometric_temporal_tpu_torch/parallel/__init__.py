"""Multi-process training: meshes over process groups, the data-parallel
step, node-partitioned graphs and the partitioned DCRNN — the JAX package's
13 names — and the byte counter of the port's collectives."""

from .collectives import collective_bytes, reset_collective_bytes
from .data_parallel import make_dp_train_step
from .mesh import make_mesh, named_sharding, replicate, shard_batch
from .multihost import assert_same_across_hosts, initialize as initialize_multihost
from .partition import PartitionedGraph, spmm_partitioned
from .partitioned_dcrnn import (
    DCRNNPartitioned,
    DCRNNPartitionedSeq,
    PartitionedDiffusionOperators,
    partitioned_diffusion_basis,
)

__all__ = [
    "make_dp_train_step",
    "make_mesh",
    "named_sharding",
    "replicate",
    "shard_batch",
    "PartitionedGraph",
    "assert_same_across_hosts",
    "initialize_multihost",
    "spmm_partitioned",
    "DCRNNPartitioned",
    "DCRNNPartitionedSeq",
    "PartitionedDiffusionOperators",
    "partitioned_diffusion_basis",
    "collective_bytes",
    "reset_collective_bytes",
]
