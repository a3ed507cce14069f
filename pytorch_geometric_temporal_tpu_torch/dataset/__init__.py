"""Alias of :mod:`..data` in the reference's layout (``dataset``)."""

from ..data import *  # noqa: F401,F403
