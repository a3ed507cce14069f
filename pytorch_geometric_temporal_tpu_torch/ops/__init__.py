"""Graph operators: Graph, diffusion norms, spmm backends, BCSR kernels."""

from .bcsr import BCSRMatrix, bcsr_spmm
from .graph import Graph, diffusion_norms
from .operators import DiffusionOperators, host_diffusion_norms
from .spmm import spmm, spmm_dense, spmm_segment

__all__ = [
    "BCSRMatrix",
    "DiffusionOperators",
    "Graph",
    "bcsr_spmm",
    "diffusion_norms",
    "host_diffusion_norms",
    "spmm",
    "spmm_dense",
    "spmm_segment",
]
