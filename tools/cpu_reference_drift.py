"""pytest plugin: does the CPU reference of a card test drift within a run?

    PYTHONPATH=tools python -m pytest --noconftest -p no:cacheprovider \
        -p cpu_reference_drift tests/test_torch_cuda.py -m cuda -q -s

Run as a script (``PYTHONPATH=. python tools/cpu_reference_drift.py``), it
computes the same CPU reference with every tensor that numpy allocated —
the input and the operators' arrays, which ``torch.from_numpy`` shares on
the CPU — moved to each offset from 0 to 60 bytes off a 64-byte boundary,
and prints each offset's largest difference from the aligned run: numpy's
buffers lie wherever the heap puts them, so their alignment follows the
process's history.

Just before ``tests/test_torch_cuda.py::test_model_on_card_matches_cpu``
runs in the full card-test session, it runs that test's computation
(DCRNNSeq(4, 8, K=2) over f32 BCSR diffusion operators of a 900-node banded
graph, two batches of three steps) on the CPU and on the card several times
and prints, on lines that start with ``DRIFT``:

- the host's CPU model, the precision flags, the thread counts and the MKL /
  OpenMP environment;
- four CPU runs on torch's default thread count and four on one thread
  (``torch.set_num_threads(1)``): the operators each run built (a digest
  of every tensor they hold) and where the input and the operators' float
  tensors lie mod 64 bytes, against the first run of its kind, and its
  outputs' largest difference from that run;
- one thread against the default threads, and two card runs against the
  first one-thread CPU run (the largest difference and how many outputs
  differ by more than the test's 1e-5).

The CPU runs are made again when the session ends, after every card test,
against the runs made before the test.  A drift in the operators' digest
points at the host build; a drift with equal digests at the forward pass.
"""

import dataclasses
import hashlib
import os

import numpy as np
import torch

RUNS = 4


def _build(dev, banded):
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import (
        DiffusionOperators, Graph)

    n = 900
    ei, w = banded(n, 12000, seed=2)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=dev)
    ops = DiffusionOperators.from_graph(g, bcsr=True, device=dev)
    model = DCRNNSeq(4, 8, 2, device=dev,
                     generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, n, 4)).astype(np.float32)).to(dev)
    return ops, model, x


def _digest(tree, h=None):
    """SHA-256 over every tensor reachable through dataclass fields,
    attributes, dicts, lists and tuples, in a fixed order."""
    h = h or hashlib.sha256()
    if isinstance(tree, torch.Tensor):
        h.update(str((tree.dtype, tuple(tree.shape))).encode())
        h.update(tree.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes() if tree.numel() else b"")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _digest(getattr(tree, f.name), h)
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            _digest(tree[k], h)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _digest(v, h)
    elif hasattr(tree, "__dict__"):
        _digest(vars(tree), h)
    return h


def _run(dev, banded):
    """(operators' digest and where numpy's buffers lie mod 64, outputs on
    the host)."""
    ops, model, x = _build(dev, banded)
    with torch.no_grad():
        out = model(x, ops).cpu()
    where = [x.data_ptr() % 64] + [t.data_ptr() % 64
                                    for _, _, t in _numpy_owned(ops)]
    return f"{_digest(ops).hexdigest()[:16]} at {where}", out


def _cpu_runs(banded, threads):
    saved = torch.get_num_threads()
    torch.set_num_threads(threads or saved)
    try:
        runs = [_run("cpu", banded) for _ in range(RUNS)]
    finally:
        torch.set_num_threads(saved)
    label = f"{threads} thread" if threads else f"{saved} threads (default)"
    d0, o0 = runs[0]
    for i, (d, o) in enumerate(runs[1:], 1):
        print(f"DRIFT CPU on {label}, run {i} against run 0: operators "
              f"{d} against {d0}, outputs largest difference "
              f"{float((o - o0).abs().max()):.3e}", flush=True)
    return o0


_SEEN = {}


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name")), "unknown")
    except OSError:
        return "unknown"


def _precision():
    out = {}
    for path in ("backends.fp32_precision", "backends.mkldnn.fp32_precision",
                 "backends.mkldnn.matmul.fp32_precision"):
        obj = torch
        try:
            for name in path.split("."):
                obj = getattr(obj, name)
            out[path] = obj
        except AttributeError:
            out[path] = "n/a"
    return out


def pytest_runtest_call(item):
    if item.name != "test_model_on_card_matches_cpu":
        return
    banded = item.module.banded
    env = {k: os.environ.get(k) for k in ("MKL_CBWR", "MKL_DYNAMIC",
                                          "MKL_NUM_THREADS",
                                          "OMP_NUM_THREADS", "OMP_DYNAMIC")}
    print(f"\nDRIFT CPU {_cpu_model()}; matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}"
          f", cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, float32 "
          f"matmul precision {torch.get_float32_matmul_precision()}, CPU "
          f"threads {torch.get_num_threads()} (interop "
          f"{torch.get_num_interop_threads()}), environment {env}, "
          f"{_precision()}", flush=True)
    default = _cpu_runs(banded, None)
    one = _cpu_runs(banded, 1)
    _SEEN.update(banded=banded, default=default, one=one)
    print(f"DRIFT CPU one thread against the default threads: largest "
          f"difference {float((one - default).abs().max()):.3e}", flush=True)
    for i in range(2):
        d = (_run("cuda", banded)[1] - one).abs()
        print(f"DRIFT card run {i} against the first one-thread CPU run: "
              f"largest {float(d.max()):.3e}, {int((d > 1e-5).sum())} "
              f"outputs over 1e-5", flush=True)


def pytest_sessionfinish(session):
    if not _SEEN:
        return
    print(f"\nDRIFT at the session's end: {_precision()}", flush=True)
    for threads, key in ((None, "default"), (1, "one")):
        out = _cpu_runs(_SEEN["banded"], threads)
        print(f"DRIFT at the session's end, {key} threads, against the same "
              f"runs before the test: largest difference "
              f"{float((out - _SEEN[key]).abs().max()):.3e}", flush=True)


def _numpy_owned(tree, seen=None):
    """(owner, attribute name or key, tensor) of every float tensor reachable
    through dataclass fields, attributes and dicts."""
    seen = set() if seen is None else seen
    if id(tree) in seen:
        return []
    seen.add(id(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif hasattr(tree, "__dict__"):
        items = list(vars(tree).items())
    else:
        return []
    out = []
    for name, value in items:
        if isinstance(value, torch.Tensor) and value.is_floating_point():
            out.append((tree, name, value))
        elif not isinstance(value, (torch.Tensor, str, bytes, int, float)):
            out.extend(_numpy_owned(value, seen))
    return out


def _at_offset(t, offset):
    """A copy of ``t`` whose data starts ``offset`` bytes past a 64-byte
    boundary."""
    size = t.element_size()
    buf = torch.empty(t.numel() + 64 // size + 1, dtype=t.dtype)
    start = ((64 - buf.data_ptr() % 64) % 64 + offset) // size
    view = buf[start:start + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 64 == offset
    return view


def alignment_probe(banded):
    ops, model, x = _build("cpu", banded)
    owned = _numpy_owned(ops)
    print(f"DRIFT alignment: {len(owned)} float tensors in the operators, "
          f"the input at {x.data_ptr() % 64} mod 64, the operators' at "
          f"{sorted({t.data_ptr() % 64 for _, _, t in owned})}", flush=True)
    outs = {}
    for offset in range(0, 64, 4):
        for owner, name, t in owned:
            object.__setattr__(owner, name, _at_offset(t, offset))
        with torch.no_grad():
            outs[offset] = model(_at_offset(x, offset), ops)
        d = (outs[offset] - outs[0]).abs()
        print(f"DRIFT alignment {offset:2d} bytes off 64: largest difference "
              f"from the aligned run {float(d.max()):.3e}, "
              f"{int((d > 1e-5).sum())} outputs over 1e-5", flush=True)


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tests"))
    from test_torch_cuda import banded as _banded

    alignment_probe(_banded)
