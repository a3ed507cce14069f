"""Recurrent graph models."""

from .agcrn import AGCRN
from .attentiontemporalgcn import A3TGCN, A3TGCN2
from .dcrnn import (DCRNN, DCRNNSeq, DConv, diffusion_basis,
                    diffusion_basis_reference)
from .dygrae import DyGrEncoder
from .evolvegcn import EvolveGCNH, EvolveGCNHSeq, EvolveGCNO, EvolveGCNOSeq
from .gc_lstm import GCLSTM
from .gconv_gru import GConvGRU
from .gconv_lstm import GConvLSTM
from .lrgcn import LRGCN, split_relations
from .mpnn_lstm import MPNNLSTM
from .temporalgcn import TGCN, TGCN2

BatchedDCRNN = DCRNNSeq

__all__ = [
    "AGCRN", "A3TGCN", "A3TGCN2", "DConv", "DCRNN", "DCRNNSeq", "BatchedDCRNN",
    "DyGrEncoder", "EvolveGCNH", "EvolveGCNHSeq", "EvolveGCNO", "EvolveGCNOSeq",
    "GCLSTM", "GConvGRU", "GConvLSTM", "LRGCN", "split_relations", "MPNNLSTM",
    "TGCN", "TGCN2", "diffusion_basis", "diffusion_basis_reference",
]
