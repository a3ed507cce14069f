"""Model zoo (this slice: the DCRNN family)."""

from .recurrent import DCRNN, DCRNNSeq, DConv, diffusion_basis

__all__ = ["DCRNN", "DCRNNSeq", "DConv", "diffusion_basis"]
