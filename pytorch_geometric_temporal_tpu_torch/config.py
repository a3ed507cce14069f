"""Global configuration for aggregation backend selection.

The aggregation backend is picked per graph:

- ``dense``   : one matmul against the (N, N) adjacency.  Default for
                ``num_nodes <= dense_threshold``.
- ``segment`` : gather + ``index_add_``.  The reference path; serves large
                graphs on the CPU.
- ``bcsr``    : hybrid block-sparse SpMM for large graphs on the card —
                dense 128x128 tiles through the tile kernel, edges of
                sparse blocks through the remainder kernel (``ops/bcsr.py``).

Unknown backend or reorder names raise instead of falling back silently.
"""

from __future__ import annotations

import contextlib
import dataclasses

BACKENDS = ("auto", "dense", "segment", "bcsr")
REORDERS = ("auto", "off")


@dataclasses.dataclass
class Config:
    # Graphs with at most this many nodes use the dense path by default.
    dense_threshold: int = 4096
    # 'auto' | 'dense' | 'segment' | 'bcsr'
    spmm_backend: str = "auto"
    # Node reordering for auto-built BCSR operators: 'auto' runs the
    # shortcut-filtered RCM pass and keeps it only when the BCSR cost
    # model says it wins (ops/bcsr.py: _reorder_pays_off); 'off' keeps the
    # caller's ordering.
    spmm_reorder: str = "auto"

    def __post_init__(self):
        if self.spmm_backend not in BACKENDS:
            raise ValueError(f"spmm_backend must be one of {BACKENDS}, "
                             f"got {self.spmm_backend!r}")
        if self.spmm_reorder not in REORDERS:
            raise ValueError(f"spmm_reorder must be one of {REORDERS}, "
                             f"got {self.spmm_reorder!r}")


_config = Config()


def get_config() -> Config:
    return _config


@contextlib.contextmanager
def config_override(**kwargs):
    """Temporarily override config fields (e.g. spmm_backend='segment')."""
    global _config
    for k in kwargs:
        if not hasattr(_config, k):
            raise ValueError(f"unknown config field {k!r}")
    new = dataclasses.replace(_config, **kwargs)  # validates
    old, _config = _config, new
    try:
        yield _config
    finally:
        _config = old
