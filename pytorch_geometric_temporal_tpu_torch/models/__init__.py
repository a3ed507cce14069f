"""Model zoo (so far: the DCRNN family, ChebConv/GCNConv and GConvGRU)."""

from .conv import ChebConv, GCNConv, cheb_basis, gcn_conv_fixed_w
from .recurrent import DCRNN, DCRNNSeq, DConv, GConvGRU, diffusion_basis

__all__ = ["ChebConv", "DCRNN", "DCRNNSeq", "DConv", "GCNConv", "GConvGRU",
           "cheb_basis", "diffusion_basis", "gcn_conv_fixed_w"]
