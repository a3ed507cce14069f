"""Heterogeneous-graph models (port of the JAX package's ``models/hetero``)."""

from .heterogclstm import HeteroGCLSTM

__all__ = ["HeteroGCLSTM"]
