"""Temporal signals: snapshot iterators, the train/test split, the
stacked device-resident signal the snapshot trainer consumes, and index
batching (windows gathered from start indices, on the device or streamed
from disk)."""

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
    "DeviceWindower",
    "IndexDataset",
    "IndexLoader",
    "StreamingWindower",
    "load_time_shard",
    "iter_index_batches",
    "Snapshot",
    "temporal_signal_split",
    "StackedSignal",
]
