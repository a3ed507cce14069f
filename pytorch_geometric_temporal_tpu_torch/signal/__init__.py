"""Temporal signals: snapshot iterators, the train/test split and the
stacked device-resident signal the snapshot trainer consumes."""

from .homogeneous import (
    DynamicGraphStaticSignal,
    DynamicGraphStaticSignalBatch,
    DynamicGraphTemporalSignal,
    DynamicGraphTemporalSignalBatch,
    StaticGraphTemporalSignal,
    StaticGraphTemporalSignalBatch,
)
from .snapshot import Snapshot
from .split import temporal_signal_split
from .stacked import StackedSignal

__all__ = [
    "DynamicGraphStaticSignal",
    "DynamicGraphStaticSignalBatch",
    "DynamicGraphTemporalSignal",
    "DynamicGraphTemporalSignalBatch",
    "StaticGraphTemporalSignal",
    "StaticGraphTemporalSignalBatch",
    "Snapshot",
    "temporal_signal_split",
    "StackedSignal",
]
