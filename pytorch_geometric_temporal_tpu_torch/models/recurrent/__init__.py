"""Recurrent graph models."""

from .dcrnn import DCRNN, DCRNNSeq, DConv, diffusion_basis

__all__ = ["DCRNN", "DCRNNSeq", "DConv", "diffusion_basis"]
