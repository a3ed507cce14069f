"""Graph operators: Graph, normalizations, spmm backends, BCSR kernels."""

from .bcsr import BCSRMatrix, StackedBCSR, bcsr_spmm, stack_bcsr
from .graph import (
    Graph,
    cheb_norm,
    diffusion_norms,
    gcn_norm,
    lambda_max,
    laplacian,
    pad_graphs,
    reorder_graph,
    stack_graphs,
)
from .operators import (
    DiffusionOperators,
    Prenormalized,
    PreparedGraph,
    host_cheb_norm,
    host_diffusion_norms,
    host_gcn_norm,
    prenormalize_cheb,
    prenormalize_gcn,
    prepare_graph,
    stack_bcsr_gcn,
)
from .spmm import sddmm, spmm, spmm_dense, spmm_segment

__all__ = [
    "BCSRMatrix",
    "DiffusionOperators",
    "Graph",
    "Prenormalized",
    "PreparedGraph",
    "StackedBCSR",
    "bcsr_spmm",
    "cheb_norm",
    "diffusion_norms",
    "gcn_norm",
    "host_cheb_norm",
    "host_diffusion_norms",
    "host_gcn_norm",
    "lambda_max",
    "laplacian",
    "pad_graphs",
    "prenormalize_cheb",
    "prenormalize_gcn",
    "prepare_graph",
    "reorder_graph",
    "sddmm",
    "spmm",
    "spmm_dense",
    "spmm_segment",
    "stack_bcsr",
    "stack_bcsr_gcn",
]
