"""Native (C++) host-side graph preprocessing, loaded via ctypes.

The port's own copy of the JAX package's native layer: the block-sparse
structure pass, the tile fill and the bandwidth-reduction ordering that
``ops/bcsr.py`` runs on the host, the counting-sort CSR build, and the edge
grouping by node part that ``parallel/partition.py`` runs.  The library is compiled with g++ on first
use into ``build/native/`` beside this package (listed in ``.gitignore``),
under a file name that carries a hash of the source.  It is written to a
temporary file first and moved into place with ``os.replace``, so processes
that build at the same time never load a half-written library.

This is host code: where g++ is missing every entry point keeps its numpy
path, which gives the same arrays (tiles in sorted (row_block, col_block)
order in both).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SOURCE = Path(__file__).parent / "graph_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"


def _lib_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libgraph_ops.{digest}.so"


def _build() -> Optional[Path]:
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", str(_SOURCE), "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None when it cannot be built."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    lib.csr_from_coo.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, i64p, i64p,
    ]
    lib.csr_from_coo.restype = None
    lib.bcsr_structure.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        i64p, i64p, i32p, i32p,
    ]
    lib.bcsr_structure.restype = ctypes.c_int64
    lib.bcsr_fill.argtypes = [
        i32p, i32p, f32p, i64p, ctypes.c_int64, ctypes.c_int32, f32p,
    ]
    lib.bcsr_fill.restype = None
    lib.rcm_order.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32,
                              i32p]
    lib.rcm_order.restype = None
    lib.edge_triangle_support.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, i32p,
    ]
    lib.edge_triangle_support.restype = None
    lib.partition_edges.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i64p, i64p,
    ]
    lib.partition_edges.restype = None
    _LIB = lib
    return _LIB


def csr_from_coo(receivers, num_nodes: int):
    """(indptr, order): counting-sort CSR over receivers; ``order`` sorts
    the edges by receiver, stable."""
    receivers = np.ascontiguousarray(receivers, np.int32)
    e = len(receivers)
    lib = get_lib()
    if lib is not None:
        indptr = np.zeros(num_nodes + 1, np.int64)
        order = np.zeros(e, np.int64)
        lib.csr_from_coo(receivers, e, num_nodes, indptr, order)
        return indptr, order
    order = np.argsort(receivers, kind="stable").astype(np.int64)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(receivers, minlength=num_nodes), out=indptr[1:])
    return indptr, order


def bcsr_structure(senders, receivers, block: int, grid_cols: int):
    """(nnzb, block_of_edge, tile_rows, tile_cols), tiles in sorted
    (row_block, col_block) order."""
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    e = len(senders)
    lib = get_lib()
    if lib is not None and e > 0:
        block_of_edge = np.zeros(e, np.int64)
        order = np.zeros(e, np.int64)
        max_tiles = min(e, grid_cols * grid_cols)
        tile_rows = np.zeros(max_tiles, np.int32)
        tile_cols = np.zeros(max_tiles, np.int32)
        nnzb = lib.bcsr_structure(
            senders, receivers, e, block, grid_cols,
            block_of_edge, order, tile_rows, tile_cols,
        )
        return int(nnzb), block_of_edge, tile_rows[:nnzb], tile_cols[:nnzb]
    keys = (receivers // block).astype(np.int64) * grid_cols + senders // block
    uniq, inv = np.unique(keys, return_inverse=True)
    return (
        len(uniq),
        inv.astype(np.int64),
        (uniq // grid_cols).astype(np.int32),
        (uniq % grid_cols).astype(np.int32),
    )


def bcsr_fill(senders, receivers, weights, block_of_edge, block: int,
              nnzb: int) -> np.ndarray:
    """Dense (max(nnzb, 1), block, block) f32 tiles, edges summed in order."""
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    weights = np.ascontiguousarray(weights, np.float32)
    block_of_edge = np.ascontiguousarray(block_of_edge, np.int64)
    tiles = np.zeros((max(nnzb, 1), block, block), np.float32)
    lib = get_lib()
    if lib is not None and len(senders) > 0:
        lib.bcsr_fill(senders, receivers, weights, block_of_edge,
                      len(senders), block, tiles)
        return tiles
    np.add.at(
        tiles, (block_of_edge, receivers % block, senders % block), weights
    )
    return tiles


def rcm_order(senders, receivers, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee node ordering on the symmetrized graph.

    Returns ``perm`` (int32, ``perm[new_id] = old_id``).  Without the
    native library: scipy's ``reverse_cuthill_mckee``, then a numpy BFS.
    """
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    e = len(senders)
    if num_nodes <= 1 or e == 0:
        return np.arange(num_nodes, dtype=np.int32)
    lib = get_lib()
    if lib is not None:
        perm = np.zeros(num_nodes, np.int32)
        lib.rcm_order(senders, receivers, e, num_nodes, perm)
        return perm
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:
        return _rcm_numpy(senders, receivers, num_nodes)
    adj = coo_matrix(
        (np.ones(e, np.int8), (senders, receivers)),
        shape=(num_nodes, num_nodes),
    ).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=False),
                      np.int32)


def _rcm_numpy(senders, receivers, num_nodes: int) -> np.ndarray:
    """Cuthill-McKee BFS from min-degree seeds, neighbours visited in
    increasing-degree order, result reversed."""
    indptr = np.zeros(num_nodes + 1, np.int64)
    both_r = np.concatenate([receivers, senders])
    both_s = np.concatenate([senders, receivers])
    order = np.argsort(both_r, kind="stable")
    np.cumsum(np.bincount(both_r, minlength=num_nodes), out=indptr[1:])
    nbrs = both_s[order]
    degree = (indptr[1:] - indptr[:-1]).astype(np.int64)
    visited = np.zeros(num_nodes, bool)
    perm = np.empty(num_nodes, np.int32)
    out = 0
    seeds = np.argsort(degree, kind="stable")
    seed_cursor = 0
    while out < num_nodes:
        while visited[seeds[seed_cursor]]:
            seed_cursor += 1
        seed = seeds[seed_cursor]
        visited[seed] = True
        head = out
        perm[out] = seed
        out += 1
        while head < out:
            u = perm[head]
            head += 1
            cand = nbrs[indptr[u]:indptr[u + 1]]
            cand = cand[~visited[cand]]
            if len(cand):
                cand = np.unique(cand)
                cand = cand[np.argsort(degree[cand], kind="stable")]
                visited[cand] = True
                perm[out:out + len(cand)] = cand
                out += len(cand)
    return perm[::-1].copy()


def edge_triangle_support(senders, receivers, num_nodes: int) -> np.ndarray:
    """Per-edge common-neighbour count |N(s) ∩ N(r)| (symmetrized graph).

    Without the native library: scipy's sparse ``A @ A``, then all ones
    (the shortcut filter becomes a no-op).
    """
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    e = len(senders)
    if e == 0:
        return np.zeros(0, np.int32)
    lib = get_lib()
    if lib is not None:
        support = np.zeros(e, np.int32)
        lib.edge_triangle_support(senders, receivers, e, num_nodes, support)
        return support
    try:
        from scipy.sparse import coo_matrix
    except ImportError:
        return np.ones(e, np.int32)
    both_s = np.concatenate([senders, receivers])
    both_r = np.concatenate([receivers, senders])
    adj = coo_matrix(
        (np.ones(2 * e, np.float32), (both_s, both_r)),
        shape=(num_nodes, num_nodes),
    ).tocsr()
    adj.data[:] = 1.0
    a2 = adj @ adj
    return np.asarray(a2[senders, receivers]).ravel().astype(np.int32)


def bandwidth_reduction_order(senders, receivers, num_nodes: int,
                              min_support: int = 2) -> np.ndarray:
    """Shortcut-robust RCM: drop low-triangle-support edges from the
    ORDERING graph (they stay in the operator), then order.  Falls back to
    unfiltered RCM when the filter would remove most edges."""
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    if len(senders) == 0:
        return rcm_order(senders, receivers, num_nodes)  # identity
    support = edge_triangle_support(senders, receivers, num_nodes)
    keep = support >= min_support
    if keep.mean() < 0.5:  # unclustered graph: the signal is meaningless
        return rcm_order(senders, receivers, num_nodes)
    return rcm_order(senders[keep], receivers[keep], num_nodes)


def partition_edges(receivers, nodes_per_part: int, num_parts: int):
    """(counts, order): edges grouped by the part of ``receivers``
    (``receivers // nodes_per_part``), stable within a part.  Pass the
    senders to group by sender part."""
    receivers = np.ascontiguousarray(receivers, np.int32)
    e = len(receivers)
    lib = get_lib()
    if lib is not None:
        counts = np.zeros(num_parts, np.int64)
        order = np.zeros(e, np.int64)
        lib.partition_edges(receivers, e, nodes_per_part, num_parts, counts,
                            order)
        return counts, order
    part = receivers // nodes_per_part
    counts = np.bincount(part, minlength=num_parts).astype(np.int64)
    order = np.argsort(part, kind="stable").astype(np.int64)
    return counts, order
