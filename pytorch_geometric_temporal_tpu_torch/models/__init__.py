"""Model zoo: the convolutions, the recurrent cells, the attention family
and the heterogeneous models."""

from . import attention, conv, hetero  # noqa: F401
from .attention import *  # noqa: F401,F403
from .conv import (
    AVWGCN,
    ChebConv,
    GatedGraphConv,
    GCNConv,
    RGCNConv,
    SAGEConv,
    cheb_basis,
    gcn_conv_fixed_w,
    topk_pool,
)
from .hetero import HeteroGCLSTM
from .recurrent import (
    AGCRN,
    A3TGCN,
    A3TGCN2,
    DConv,
    DCRNN,
    DCRNNSeq,
    DyGrEncoder,
    EvolveGCNH,
    EvolveGCNHSeq,
    EvolveGCNO,
    EvolveGCNOSeq,
    GCLSTM,
    GConvGRU,
    GConvLSTM,
    LRGCN,
    MPNNLSTM,
    TGCN,
    TGCN2,
    diffusion_basis,
    diffusion_basis_reference,
    split_relations,
)

__all__ = list(attention.__all__) + [
    "AGCRN", "A3TGCN", "A3TGCN2", "AVWGCN", "ChebConv", "DCRNN", "DCRNNSeq",
    "DConv", "DyGrEncoder", "EvolveGCNH", "EvolveGCNHSeq", "EvolveGCNO",
    "EvolveGCNOSeq", "GCLSTM", "GCNConv", "GConvGRU", "GConvLSTM",
    "GatedGraphConv", "HeteroGCLSTM", "LRGCN", "MPNNLSTM", "RGCNConv",
    "SAGEConv", "TGCN", "TGCN2",
    "cheb_basis", "diffusion_basis", "diffusion_basis_reference",
    "gcn_conv_fixed_w", "split_relations", "topk_pool",
]
