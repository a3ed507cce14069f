"""Index-batched windowed datasets (the PGT-I memory-efficiency idea).

Port of the JAX package's ``signal/index_dataset.py``: a dataset over
*window start indices* rather than materialized windows —
``x = data[i : i+horizon]``, ``y = data[i+horizon : i+2*horizon]``.

:class:`IndexDataset` keeps the raw numpy semantics for host iteration;
:class:`DeviceWindower` puts the whole series on the device once and
gathers each batch's windows with one indexing kernel, so a batch moves
only its start indices from the host.

Out-of-core path: series too large for host RAM live on disk as ``.npy``
and are opened memory-mapped.  ``IndexDataset(indices, path, horizon,
lazy=True)`` reads only the touched windows; :class:`StreamingWindower` is
the matching device feeder — it gathers each batch's windows from the
mapped file into one reused host buffer and copies it to the device,
re-opening the map periodically so clean page-cache residency never
accumulates in the process RSS.  :func:`load_time_shard` gives one process
the contiguous time range its indices touch.

Starts are validated on the host before anything reaches the device: on
CUDA an out-of-range index is a device-side assert that poisons the
context, and a negative one wraps to the series' tail silently.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .. import _counters
from .._device import resolve_device

PathLike = Union[str, "os.PathLike[str]"]

# The JAX package turns host arrays into 32-bit device arrays (its 64-bit
# mode is off); the windowers hand out the same dtypes.
_NARROW = {np.dtype(np.float64): np.dtype(np.float32),
           np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32),
           np.dtype(np.complex128): np.dtype(np.complex64)}


def _device_dtype(dtype) -> np.dtype:
    dtype = np.dtype(dtype)
    return _NARROW.get(dtype, dtype)


def _open_series(data, lazy: bool):
    """ndarray | memmap | .npy path -> array-like (mapped when lazy)."""
    if isinstance(data, (str, os.PathLike)):
        return np.load(data, mmap_mode="r" if lazy else None)
    return data


def _check_starts(idx: np.ndarray, length: int, h2: int) -> None:
    """Raise unless every start leaves ``h2`` steps inside the series."""
    if not idx.size:
        return
    if int(idx.max()) + h2 > length:
        bad = int(idx[int(np.argmax(idx))])
        raise ValueError(
            f"window start {bad} + 2*horizon ({h2}) overruns the series "
            f"(length {length}); valid starts are [0, {length - h2}]")
    if int(idx.min()) < 0:
        bad = int(idx[int(np.argmin(idx))])
        raise ValueError(
            f"negative window start {bad}: numpy would wrap it to the "
            f"series tail; valid starts are [0, {length - h2}]")


class IndexDataset:
    """Host-side windowed dataset over indices.

    ``data`` may be an ndarray, an ``np.memmap``, or a path to a ``.npy``
    file.  With ``lazy=True`` a path is opened memory-mapped and an
    ndarray is left untouched — ``__getitem__`` then materializes only the
    two requested windows.
    """

    def __init__(self, indices, data, horizon: int, lazy: bool = False):
        self.indices = np.asarray(indices)
        self.data = _open_series(data, lazy)
        self.horizon = int(horizon)
        self.lazy = lazy

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, x) -> Tuple[np.ndarray, np.ndarray]:
        idx = self.indices[x]
        h = self.horizon
        return (
            np.asarray(self.data[idx : idx + h]),
            np.asarray(self.data[idx + h : idx + 2 * h]),
        )


class DeviceWindower:
    """Device-resident window gather.

    The host array ``data`` (T, ...) is copied to ``device`` (CUDA unless
    given "cpu") once, 64-bit types narrowed to 32 bits as the JAX package
    does; a batch of host start indices is checked, uploaded and turned
    into one gather producing (B, 2·horizon, ...), split into inputs and
    targets (views of the gathered block).
    """

    def __init__(self, data, horizon: int, device=None):
        self.horizon = int(horizon)
        self.device = resolve_device(device)
        arr = np.asarray(data)
        self.data = torch.tensor(arr.astype(_device_dtype(arr.dtype),
                                            copy=False), device=self.device)
        self._steps = torch.arange(2 * self.horizon, device=self.device)

    def __call__(self, start_indices) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x, y) for host (numpy-convertible) start indices."""
        span = _counters.span
        h = self.horizon
        with span("loader.check"):
            idx = np.asarray(start_indices, dtype=np.int64)
            _check_starts(idx, self.data.shape[0], 2 * h)
        with span("loader.upload"):
            start = torch.from_numpy(idx)
            if self.device.type == "cuda":
                # from pinned memory the upload does not wait for the work
                # already queued on the stream
                start = start.pin_memory().to(self.device, non_blocking=True)
        with span("loader.gather"):
            win = self.data[start[:, None] + self._steps[None, :]]
        return win[:, :h], win[:, h:]


class StreamingWindower:
    """Out-of-core window feeder: memory-mapped host series → device batches.

    The disk-resident counterpart of :class:`DeviceWindower` for series
    that fit neither in device memory nor in host RAM (all-California
    PeMS: 11160 nodes × a year of 5-min steps ≈ 9.4 GB f32).  Holds a
    *path* to a ``.npy`` file; per batch it gathers the requested windows
    from the memory map into one contiguous (B, 2h, ...) host buffer and
    copies it to ``device`` (CUDA unless given "cpu").  Only the touched pages are ever read, and the
    map is re-opened every ``reopen_every`` batches so clean file-backed
    pages don't accumulate in the process RSS across an epoch.

    Same ``__call__`` contract as :class:`DeviceWindower`, so
    :class:`IndexLoader` drives either interchangeably.
    """

    def __init__(self, path: PathLike, horizon: int, device=None,
                 reopen_every: int = 64):
        self.path = os.fspath(path)
        self.horizon = int(horizon)
        self.device = device  # resolved per call: host_batch needs none
        self.reopen_every = int(reopen_every)
        self._mm = None
        self._batches_since_open = 0
        self._buf = None  # reused host batch buffer (avoids malloc churn)
        # validate header once (shape/dtype live in the .npy header)
        mm = np.load(self.path, mmap_mode="r")
        self.shape = mm.shape
        self.dtype = mm.dtype
        del mm

    def _map(self):
        if self._mm is None or self._batches_since_open >= self.reopen_every:
            self._mm = np.load(self.path, mmap_mode="r")
            self._batches_since_open = 0
        self._batches_since_open += 1
        return self._mm

    def host_batch(self, start_indices) -> np.ndarray:
        """(B, 2·horizon, ...) contiguous host buffer for these starts.

        The returned array is a REUSED internal buffer (overwritten by the
        next call) — copy it if you need to hold more than one batch.
        ``__call__`` copies it before returning.
        """
        h2 = 2 * self.horizon
        idx = np.asarray(start_indices)
        _check_starts(idx, self.shape[0], h2)
        mm = self._map()
        shape = (len(idx), h2) + self.shape[1:]
        if self._buf is None or self._buf.shape != shape:
            self._buf = np.empty(shape, self.dtype)
        out = self._buf
        for j, i in enumerate(idx):
            out[j] = mm[i : i + h2]
        return out

    def __call__(self, start_indices) -> Tuple[torch.Tensor, torch.Tensor]:
        with _counters.span("loader.read"):
            buf = self.host_batch(start_indices)
            buf = buf.astype(_device_dtype(buf.dtype), copy=False)
        with _counters.span("loader.upload"):
            # a blocking copy that always copies (to the CPU too): the next
            # host_batch overwrites the buffer
            win = torch.from_numpy(buf).to(resolve_device(self.device),
                                           copy=True)
        h = self.horizon
        return win[:, :h], win[:, h:]


def load_time_shard(data, indices, horizon: int, lazy: bool = True):
    """Per-process time shard: the contiguous slice these indices touch.

    Multi-process index batching gives each process a disjoint index slice
    (``iter_index_batches(world_size, rank)``); the process then needs only
    ``[min(idx), max(idx) + 2·horizon)`` of the series.  Returns
    ``(shard, shifted_indices)`` where ``shard`` is a view of the mapped
    file (``lazy=True``) or an in-RAM copy, and ``shifted_indices`` index
    into it.
    """
    indices = np.asarray(indices)
    if indices.size == 0:
        raise ValueError("load_time_shard needs at least one index "
                         "(this rank's index slice is empty)")
    series = _open_series(data, lazy=True)
    lo = int(indices.min())
    hi = min(int(indices.max()) + 2 * horizon, series.shape[0])
    shard = series[lo:hi]
    if not lazy:
        shard = np.array(shard)
    return shard, indices - lo


class IndexLoader:
    """Minimal DataLoader equivalent over window start indices.

    Iterating yields ``(x, y)`` device batches of shape (B, horizon, ...)
    gathered by a shared windower (:class:`DeviceWindower` or
    :class:`StreamingWindower`).  The epoch order is the JAX package's for
    the same arguments: one ``np.random.default_rng(seed)`` permuting the
    indices once an epoch.
    """

    def __init__(self, indices, windower, batch_size: int,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False,
                 world_size: int = 1, rank: int = 0):
        self.indices = np.asarray(indices)
        self.windower = windower
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.world_size = world_size
        self.rank = rank
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self):
        # Must agree with iteration: the iterator shards
        # ``indices[rank::world_size]``, whose length is rank-dependent
        # when ``len(indices) % world_size != 0``.
        n = len(self.indices)
        if self.world_size > 1:
            n = len(range(self.rank, n, self.world_size))
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        self._epoch += 1
        for batch in iter_index_batches(
            self.indices, self.batch_size, shuffle=self.shuffle,
            rng=self._rng, drop_last=self.drop_last,
            world_size=self.world_size, rank=self.rank,
        ):
            # yielded unbound: a suspended generator holding the batch
            # would keep it alive while the next one is gathered
            yield self._window(batch)

    def _window(self, batch):
        with _counters.span("loader.batch"):
            return self.windower(batch)


def iter_index_batches(
    indices,
    batch_size: int,
    *,
    shuffle: bool = True,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = True,
    world_size: int = 1,
    rank: int = 0,
) -> Iterator[np.ndarray]:
    """Yield batches of window start indices, optionally sharded by rank.

    With ``world_size > 1`` each rank sees a disjoint 1/world_size slice
    per epoch, like ``DistributedSampler(shuffle=...)``.
    """
    indices = np.asarray(indices)
    if shuffle:
        rng = rng or np.random.default_rng(0)
        indices = rng.permutation(indices)
    if world_size > 1:
        indices = indices[rank::world_size]
    n = len(indices)
    stop = n - (n % batch_size) if drop_last else n
    for i in range(0, stop, batch_size):
        yield indices[i : i + batch_size]
