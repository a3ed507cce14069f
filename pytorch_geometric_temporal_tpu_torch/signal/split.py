"""Train/test split for temporal signal iterators (port of the JAX
package's ``signal/split.py``): slices a signal at
``k = int(train_ratio * snapshot_count)``."""

from __future__ import annotations


def temporal_signal_split(data_iterator, train_ratio: float = 0.8):
    """Split a temporal signal iterator into a train and a test iterator."""
    train_snapshots = int(train_ratio * data_iterator.snapshot_count)
    train_iterator = data_iterator[0:train_snapshots]
    test_iterator = data_iterator[train_snapshots:]
    return train_iterator, test_iterator
