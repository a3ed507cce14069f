"""The attention family: STGCN, MSTGCN, ASTGCN (dense and edge mode), GMAN,
MTGNN, 2s-AGCN and DNNTSP."""

from .astgcn import (
    ASTGCN,
    ASTGCNBlock,
    ChebConvAttention,
    EdgeScores,
    SpatialAttention,
    SpatialAttentionSparse,
    TemporalAttention,
)
from .dnntsp import (
    DNNTSP,
    GlobalGatedUpdater,
    MaskedSelfAttention,
    WeightedGCNBlock,
)
from .gman import (
    GMAN,
    FullyConnected,
    GatedFusion,
    SpatioTemporalAttention,
    SpatioTemporalEmbedding,
    TransformAttention,
)
from .mstgcn import MSTGCN, MSTGCNBlock
from .mtgnn import (
    MTGNN,
    DilatedInception,
    GraphConstructor,
    MixProp,
    MTGNNLayer,
)
from .stgcn import STConv, TemporalConv
from .tsagcn import AAGCN, GraphAAGCN, UnitGCN, UnitTCN

__all__ = [
    "ASTGCN", "ASTGCNBlock", "ChebConvAttention", "EdgeScores",
    "SpatialAttention", "SpatialAttentionSparse",
    "TemporalAttention", "DNNTSP", "GlobalGatedUpdater",
    "MaskedSelfAttention", "WeightedGCNBlock", "GMAN", "FullyConnected",
    "GatedFusion", "SpatioTemporalAttention", "SpatioTemporalEmbedding",
    "TransformAttention", "MSTGCN", "MSTGCNBlock", "MTGNN",
    "DilatedInception", "GraphConstructor", "MixProp", "MTGNNLayer",
    "STConv", "TemporalConv", "AAGCN", "GraphAAGCN", "UnitGCN", "UnitTCN",
]
