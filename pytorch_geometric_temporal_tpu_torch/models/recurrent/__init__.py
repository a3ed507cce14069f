"""Recurrent graph models."""

from .dcrnn import DCRNN, DCRNNSeq, DConv, diffusion_basis
from .gconv_gru import GConvGRU

__all__ = ["DCRNN", "DCRNNSeq", "DConv", "GConvGRU", "diffusion_basis"]
