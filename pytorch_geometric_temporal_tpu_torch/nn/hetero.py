"""Alias of the heterogeneous model family (reference ``nn/hetero``)."""

from ..models.hetero import *  # noqa: F401,F403
