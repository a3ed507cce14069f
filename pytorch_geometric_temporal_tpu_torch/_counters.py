"""Process-wide counters of work the port issues from Python.

``ops/bcsr.py`` counts the kernels' launches and ``parallel/collectives.py``
the bytes each collective sends, each where it issues the work.  A CUDA
graph's capture runs that Python and executes none of the work; each
replay executes it and runs no Python.  Every counter registers its reader
and its adder here, and :class:`~.train.trainer._StepGraphs` takes what a
capture counted back out and adds it again at every replay, so the counters
stay counts of work executed.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

_COUNTERS: Dict[str, Tuple[Callable, Callable]] = {}


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
