"""The port's tracing: process-wide counters of the work it issues, spans of
its host work, and a record of each step's counts.

**Counters.** ``ops/bcsr.py`` counts the kernels' launches and
``parallel/collectives.py`` the bytes each collective sends, each where it
issues the work.  A CUDA graph's capture runs that Python and executes
none of the work; each replay executes it and runs no Python.  Every
counter registers its reader and its adder here, and
:class:`~.train.trainer._StepGraphs` takes what a capture counted back out
and adds it again at every replay, so the counters stay counts of work
executed.

**Spans.** :func:`span` marks host work as a ``torch.profiler``
``record_function`` range named ``pgtt.<name>``, so it lands in the
profiler's trace on the clock of the device's records (and in the Chrome
trace that :func:`~.utils.profiling.trace` writes).  With no profiler
session on, a span costs one ``_profiler_enabled()`` check and returns a
shared null context.  The port's spans:

- ``loader.batch``: the windower's call for each batch an
  :class:`~.signal.IndexLoader` yields; inside it, a
  :class:`~.signal.DeviceWindower`'s ``loader.check`` (the starts checked
  on the host), ``loader.upload`` (the starts to the device, pinned and
  copied without blocking on CUDA) and ``loader.gather`` (the window
  index and its gather); a :class:`~.signal.StreamingWindower`'s
  ``loader.read`` (the windows gathered from the memory map on the host)
  and ``loader.upload``;
- ``step.<fn>``: each call of a step function — ``train_step``,
  ``eval_step``, ``train_epoch``, ``evaluate``, or the name of the
  function that made the step (``make_dp_train_step``).
  Inside a captured step: ``step.warm`` (a signature's first, eager call),
  ``step.capture``, ``step.copy_in`` (the static inputs), ``step.replay``
  (the graph's launch) and ``step.clone_out``; inside an eager
  ``BatchTrainer`` step: ``step.forward`` (the model and the loss),
  ``step.backward`` and ``step.optimizer``.  A replay runs no Python, so
  nothing inside a captured model is spanned.

**Step records.** While a profiler session is on, each top-level step call
(:func:`step`) also keeps a :class:`StepRecord`: the step function's name
and what every counter gained over the call (:func:`counted_since`), so a
replay's record holds the launches its graph executed.  The last
:data:`MAX_STEP_RECORDS` are kept: :func:`step_records`,
:func:`clear_step_records`.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Dict, NamedTuple, Tuple

import torch

_COUNTERS: Dict[str, Tuple[Callable, Callable]] = {}

SPAN_PREFIX = "pgtt."
MAX_STEP_RECORDS = 4096

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


def register(name: str, read: Callable[[], tuple],
             add: Callable[[tuple], None]) -> None:
    """``read()`` returns the counts as a tuple of ints; ``add(delta)``
    adds such a tuple to them."""
    _COUNTERS[name] = (read, add)


def read() -> dict:
    """Every registered counter's counts, by name."""
    return {name: tuple(r()) for name, (r, _) in _COUNTERS.items()}


def counted_since(before: dict) -> dict:
    """What each counter gained since :func:`read` returned ``before``."""
    return {name: tuple(a - b for a, b in zip(
        now, before.get(name, (0,) * len(now))))
        for name, now in read().items()}


def add(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (as :func:`counted_since` gives it)."""
    for name, d in delta.items():
        _COUNTERS[name][1](tuple(sign * v for v in d))


def span(name: str):
    """A context that marks its block as ``pgtt.<name>`` in a running
    profiler session; the shared null context when none runs."""
    if not _profiler_enabled():
        return _NULL
    return torch.profiler.record_function(SPAN_PREFIX + name)


class StepRecord(NamedTuple):
    name: str           # the step function's name
    counted: dict       # counter name -> what it gained over the call


_records = collections.deque(maxlen=MAX_STEP_RECORDS)
_nesting = threading.local()


class _Step:
    """The span ``step.<name>``; at the top level also the call's record."""

    __slots__ = ("name", "range", "before")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(
            SPAN_PREFIX + "step." + name)
        self.before = None

    def __enter__(self):
        self.range.__enter__()
        depth = getattr(_nesting, "depth", 0)
        if depth == 0:
            self.before = read()
        _nesting.depth = depth + 1
        return self

    def __exit__(self, exc_type, exc, tb):
        _nesting.depth -= 1
        if self.before is not None and exc_type is None:
            _records.append(StepRecord(self.name, counted_since(self.before)))
        return self.range.__exit__(exc_type, exc, tb)


def step(name: str):
    """The span of one call of the step function ``name``
    (``step.<name>``), which keeps the call's :class:`StepRecord` when it
    is not inside another step; the shared null context when no profiler
    session runs."""
    if not _profiler_enabled():
        return _NULL
    return _Step(name)


def step_records() -> list:
    """The kept :class:`StepRecord` s, oldest first."""
    return list(_records)


def clear_step_records() -> None:
    _records.clear()
