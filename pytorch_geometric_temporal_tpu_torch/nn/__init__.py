"""Alias of :mod:`..models` in the reference's layout (``nn.recurrent``,
``nn.attention``, ``nn.hetero``)."""

from . import attention, hetero, recurrent  # noqa: F401
from ..models import *  # noqa: F401,F403
