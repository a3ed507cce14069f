"""Temporal signals: homogeneous and heterogeneous snapshot iterators, the
train/test split, the stacked device-resident signals the snapshot trainer
consumes, and index batching (windows gathered from start indices, on the
device or streamed from disk)."""

from .heterogeneous import (
    DynamicHeteroGraphStaticSignal,
    DynamicHeteroGraphStaticSignalBatch,
    DynamicHeteroGraphTemporalSignal,
    DynamicHeteroGraphTemporalSignalBatch,
    StaticHeteroGraphTemporalSignal,
    StaticHeteroGraphTemporalSignalBatch,
)
from .homogeneous import (
    DynamicGraphStaticSignal,
    DynamicGraphStaticSignalBatch,
    DynamicGraphTemporalSignal,
    DynamicGraphTemporalSignalBatch,
    StaticGraphTemporalSignal,
    StaticGraphTemporalSignalBatch,
)
from .index_dataset import (
    DeviceWindower,
    IndexDataset,
    IndexLoader,
    StreamingWindower,
    load_time_shard,
    iter_index_batches,
)
from .snapshot import HeteroSnapshot, Snapshot
from .split import temporal_signal_split
from .stacked import StackedHeteroSignal, StackedSignal

__all__ = [
    "DynamicGraphStaticSignal",
    "DynamicGraphStaticSignalBatch",
    "DynamicGraphTemporalSignal",
    "DynamicGraphTemporalSignalBatch",
    "StaticGraphTemporalSignal",
    "StaticGraphTemporalSignalBatch",
    "DynamicHeteroGraphStaticSignal",
    "DynamicHeteroGraphStaticSignalBatch",
    "DynamicHeteroGraphTemporalSignal",
    "DynamicHeteroGraphTemporalSignalBatch",
    "StaticHeteroGraphTemporalSignal",
    "StaticHeteroGraphTemporalSignalBatch",
    "DeviceWindower",
    "IndexDataset",
    "IndexLoader",
    "StreamingWindower",
    "load_time_shard",
    "iter_index_batches",
    "HeteroSnapshot",
    "Snapshot",
    "temporal_signal_split",
    "StackedHeteroSignal",
    "StackedSignal",
]
