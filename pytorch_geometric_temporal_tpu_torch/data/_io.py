"""Dataset file resolution and download.

Port of the JAX package's ``data/_io.py``.  Files resolve through a search
path first (env ``PGT_TPU_DATA``, ``~/.cache/pgt_tpu``), then the datasets
bundled with this package (``data/bundled/*.json.gz``), and only then fall
back to URL download into the cache.  Environments without network access
therefore work out of the box for the bundled sets and with pre-staged
files for the rest.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import ssl
import urllib.request
import zipfile
from pathlib import Path
from typing import List, Optional

_BUNDLED = Path(__file__).parent / "bundled"
_EXTRA_PATHS: List[Path] = []


def add_search_path(directory) -> None:
    """Register an additional directory to resolve dataset files from
    (highest priority; e.g. a loader's ``raw_data_dir`` argument)."""
    p = Path(directory)
    if p not in _EXTRA_PATHS:
        _EXTRA_PATHS.insert(0, p)


def data_search_paths() -> List[Path]:
    paths = list(_EXTRA_PATHS)
    env = os.environ.get("PGT_TPU_DATA")
    if env:
        paths.append(Path(env))
    paths.append(Path.home() / ".cache" / "pgt_tpu")
    return paths


def cache_dir() -> Path:
    env = os.environ.get("PGT_TPU_DATA")
    p = Path(env) if env else Path.home() / ".cache" / "pgt_tpu"
    p.mkdir(parents=True, exist_ok=True)
    return p


def find_file(filename: str) -> Optional[Path]:
    for base in data_search_paths():
        p = base / filename
        if p.is_file():
            return p
    return None


def available(filename: str) -> bool:
    """True when ``filename`` resolves offline (staged or package-bundled)."""
    return find_file(filename) is not None or _bundled_bytes(filename) is not None


def _bundled_bytes(filename: str) -> Optional[bytes]:
    """Package-bundled datasets (small public JSONs, stored gzipped)."""
    gz = _BUNDLED / (filename + ".gz")
    if gz.is_file():
        return gzip.decompress(gz.read_bytes())
    plain = _BUNDLED / filename
    if plain.is_file():
        return plain.read_bytes()
    return None


def fetch_bytes(filename: str, url: str) -> bytes:
    """Resolve a dataset file locally or download it into the cache."""
    p = find_file(filename)
    if p is not None:
        return p.read_bytes()
    bundled = _bundled_bytes(filename)
    if bundled is not None:
        return bundled
    try:
        context = ssl._create_unverified_context()
        data = urllib.request.urlopen(url, context=context).read()
    except Exception as exc:  # pragma: no cover - zero-egress environments
        raise RuntimeError(
            f"dataset file {filename!r} not found in {data_search_paths()} "
            f"and download from {url} failed ({exc}). Stage the file into "
            f"$PGT_TPU_DATA or ~/.cache/pgt_tpu."
        ) from exc
    out = cache_dir() / filename
    out.write_bytes(data)
    return data


def fetch_json(filename: str, url: str):
    return json.loads(fetch_bytes(filename, url))


def fetch_zipped(filename: str, url: str, member: str) -> bytes:
    """Fetch a zip archive and return one member's bytes (cached unzipped)."""
    cached = find_file(member)
    if cached is not None:
        return cached.read_bytes()
    blob = fetch_bytes(filename, url)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        data = zf.read(member)
    out = cache_dir() / member
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(data)
    return data
