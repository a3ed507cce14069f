"""Profiling and observability (port of the JAX package's ``utils/``)."""

from .profiling import StepTimer, device_memory_stats, trace

__all__ = ["StepTimer", "device_memory_stats", "trace"]
