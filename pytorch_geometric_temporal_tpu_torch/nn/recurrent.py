"""Alias of the recurrent model family (reference ``nn/recurrent``)."""

from ..models.recurrent import *  # noqa: F401,F403
from ..models.recurrent import DCRNNSeq as BatchedDCRNN  # noqa: F401
