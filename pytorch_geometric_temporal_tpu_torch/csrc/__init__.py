"""Build and load the port's CUDA kernels (``*.cu`` beside this file).

The sources are compiled with nvcc for Hopper (``sm_90a``), one nvcc
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes.  The build runs at
first use, into ``build/kernels/`` beside the package (listed in
``.gitignore``), under a file name keyed by a hash of the sources and the
flags; it is written to a temporary file and moved into place with
``os.replace``.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

SOURCES = sorted(Path(__file__).parent.glob("*.cu"))
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _Q, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# The library's C interface: each ``pgtt_*`` entry point's argument types in
# order (pointers and the stream as void*, then int, int64_t and float as
# they are declared in the sources); every one returns an int, 0 or a CUDA
# error.
SIGNATURES = {
    "pgtt_tile_spmm": (_P, _I, _P, _P, _P, _P, _I, _I, _P),
    "pgtt_rem_scatter": (_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P),
    "pgtt_hybrid_spmm": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                         _I, _P, _I, _P),
    "pgtt_weighted_hop_fwd": (_P, _Q, _Q, _P, _Q, _Q, _P, _P, _P, _P, _Q,
                              _Q, _I, _I, _I, _I, _I, _I, _I, _P),
    "pgtt_weighted_hop_bwd": (_P, _Q, _Q, _P, _Q, _Q, _P, _Q, _Q, _P, _P,
                              _P, _P, _Q, _Q, _P, _Q, _I, _I, _I, _I, _I,
                              _I, _I, _P),
    "pgtt_block_tail_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    "pgtt_block_tail_bwd": (_P, _Q, _Q, _Q, _I, _I, _P, _P, _P, _P, _P, _P,
                            _P, _P, _I, _I, _F, _I, _P),
}

_LIB: Optional[ctypes.CDLL] = None
# what the last build (or cache hit) reported: seconds and nvcc's output
build_info = {"seconds": None, "log": "", "path": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpgtt_kernels.{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs, failed = [], []
        try:
            for src, proc in zip(SOURCES, procs):
                stdout, stderr = proc.communicate(timeout=600)
                logs.append(stdout + stderr)
                if proc.returncode != 0:
                    failed.append(f"{src.name} ({proc.returncode}):\n{stderr}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                               *objs], capture_output=True, text=True,
                              timeout=600)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(lib, out)
    build_info.update(seconds=time.perf_counter() - t0,
                      log="".join(logs), path=str(out))


def declare(lib: ctypes.CDLL, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """Give ``lib``'s entry points ``names`` their types from
    :data:`SIGNATURES` (a library built from one source holds only that
    source's); returns ``lib``."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = list(SIGNATURES[name])
        fn.restype = _I
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built first if no build of these sources exists."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = _lib_path()
    if out.exists():
        build_info.update(seconds=0.0, log="(cached build)", path=str(out))
    else:
        _build(out)
    _LIB = declare(ctypes.CDLL(str(out)))
    return _LIB
