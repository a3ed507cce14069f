"""Alias of the attention model family (reference ``nn/attention``)."""

from ..models.attention import *  # noqa: F401,F403
