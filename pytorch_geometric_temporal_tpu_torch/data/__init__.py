"""Dataset loaders (this slice: Chickenpox, from the package's own bundle)."""

from .chickenpox import ChickenpoxDatasetLoader

__all__ = ["ChickenpoxDatasetLoader"]
