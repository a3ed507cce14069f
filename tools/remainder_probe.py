#!/usr/bin/env python3
"""The fused kernel alone on the remainder's operators, timed on one NVIDIA card.

    python3 tools/remainder_probe.py [--root DIR] [--tag NAME] [--check]
                                     [--variants FILE.json] [--watchdog S]

``--root`` is a checkout of this repository (default: the one that holds
this script).  Its package and its ``chip_smoke.py`` are imported and its
kernels built from its ``csrc/``, so an older checkout unpacked with ``git
archive`` into a gitignored directory is timed by the same code; to compare
two, run them in one call: parent, this, this, parent.  ``--check`` first
runs that ``chip_smoke.py``'s phase 2 (every kernel case against its plain
version, and the f32 digest) and prints phase 15's f32 digest.  Then the
fused kernel is timed cold (``chip_smoke.fused_report``: L2 flushed; the
bound, the plain version and ``torch.sparse.mm`` beside it), one ``TIME``
line each, on:

- the scrambled-id PeMS stand-in's first diffusion operator as the ids
  come, f32 tiles, min_block_edges 32, F=256 (phase 21's variant (ii));
- the raw PeMS band, f32 tiles, F=256 (phase 15);
- the N=20,000 recovery draw in bf16 at F=64: at θ=75, with every edge
  spilled (θ past every block) and RCM-reordered at θ=22 (phase 22);
- the 50,000-node DCRNN slice's first diffusion operator, bf16, F=96;
- one row of 20,000 edges beside a banded 5,000-node graph, every edge
  spilled, bf16, F=64.

``--variants`` names a JSON object ``{name: [[old, new], ...]}`` or ``{name:
"path/to/source.cu"}``: each variant is a copy of the checkout's
``hybrid_spmm.cu`` rewritten by those text substitutions (or that whole
file), built beside it (one nvcc each, in parallel) and timed on the same
halves in the order base, the variants, base (``VAR`` lines).  A copy that
leaves out work computes garbage and is read for its time only.  Prints the
card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path


def parse():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--variants")
    ap.add_argument("--watchdog", type=float, default=420.0)
    return ap.parse_args()


def halves(torch, cs, np):
    """(label, half, F) of the operators the module docstring lists."""
    from pytorch_geometric_temporal_tpu_torch.ops import (
        BCSRMatrix, DiffusionOperators, Graph)
    from pytorch_geometric_temporal_tpu_torch.ops.operators import (
        host_diffusion_norms)

    c = cs.PEMS
    ei, w = cs.pems_graph(c)
    n = c["n"]
    sigma = np.random.default_rng(cs.PEMS_SCRAMBLE_SEED).permutation(n)
    gs = Graph.from_edge_index(sigma[ei], w, num_nodes=n, device="cpu")
    p = host_diffusion_norms(gs, device="cuda")[0]
    yield ("scrambled-pems op0 fwd",
           BCSRMatrix.from_graph(p, dtype=None, min_block_edges=32).fwd, 256)
    g = Graph.from_edge_index(ei, w, num_nodes=n)
    yield ("pems native raw fwd",
           BCSRMatrix.from_graph(g, dtype=torch.float32).fwd, 256)
    gr, _ = cs.recovery_graph(torch)
    for label, kw in (("recovery plain theta75", dict(min_block_edges=75)),
                      ("recovery all-remainder",
                       dict(min_block_edges=10**9)),
                      ("recovery reordered theta22 (all tiles)",
                       dict(min_block_edges=22, reorder="rcm"))):
        yield (label + " bf16",
               BCSRMatrix.from_graph(gr, dtype=torch.bfloat16, **kw).fwd, 64)
    ei2, w2 = cs.slice_graph(np.random.default_rng(cs.SLICE["seed"]))
    g2 = Graph.from_edge_index(ei2, w2, num_nodes=cs.SLICE["n"])
    ops = DiffusionOperators.from_graph(g2, bcsr=True, dtype=torch.bfloat16)
    yield "dcrnn-large-n p_fwd.fwd bf16", ops.p_fwd.fwd, 96
    rng = np.random.default_rng(5)
    nh, e = 5000, 50_000
    s = rng.integers(0, nh, e)
    r = np.clip(s + rng.integers(-40, 41, e), 0, nh - 1)
    s = np.concatenate([s, rng.integers(0, nh, 20_000)])
    r = np.concatenate([r, np.full(20_000, 77)])
    gh = Graph.from_edge_index(
        np.stack([s, r]), rng.uniform(0.1, 1, len(s)).astype(np.float32),
        num_nodes=nh)
    yield ("hub all-remainder bf16",
           BCSRMatrix.from_graph(gh, dtype=torch.bfloat16,
                                 min_block_edges=10**9).fwd, 64)


def main():
    args = parse()
    root = Path(args.root).resolve()
    here = Path.cwd()
    sys.path.insert(0, str(root))
    os.chdir(root)
    timer = threading.Timer(args.watchdog, lambda: (
        print("probe: watchdog", flush=True), os._exit(124)))
    timer.daemon = True
    timer.start()

    import numpy as np
    import torch

    import chip_smoke as cs
    from pytorch_geometric_temporal_tpu_torch import csrc
    from pytorch_geometric_temporal_tpu_torch.ops import BCSRMatrix, Graph, bcsr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    t0 = time.perf_counter()
    src = root / "pytorch_geometric_temporal_tpu_torch" / "csrc" / "hybrid_spmm.cu"
    variants = (json.loads((here / args.variants).read_text())
                if args.variants else {})
    started = {}
    out_dir = root / "pytorch_geometric_temporal_tpu_torch" / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, subs in variants.items():
        if isinstance(subs, str):  # a whole source file
            text = (here / subs).read_text()
        else:
            text = src.read_text()
            for old, new in subs:
                if old not in text:
                    raise SystemExit(f"variant {name}: text not found: {old!r}")
                text = text.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        started[name] = cs.start_hybrid_build(str(path), f"probe_{name}")
    csrc.load()
    libs = {name: cs.finish_hybrid_build(s) for name, s in started.items()}
    print(f"== {args.tag} at {root}: built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if args.check:
        cs.phase_kernel_cases(torch)
        c = cs.PEMS
        ei, w = cs.pems_graph(c)
        raw = BCSRMatrix.from_graph(
            Graph.from_edge_index(ei, w, num_nodes=c["n"]),
            dtype=torch.float32).fwd
        print(f"  phase-15 digest nnzb={raw.nnzb} rem={raw.num_rem}: "
              f"{cs.f32_digest(torch, [raw], [64 * 2 * c['f']], cs.DIGEST_SEED)}",
              flush=True)
    for label, half, f in halves(torch, cs, np):
        x = torch.randn(half.num_cols, f, device="cuda").to(half.blocks.dtype)
        k = cs.fused_report(torch, half, x)
        items = ""
        if hasattr(half, "items"):
            items = (f" items={half.num_block_items}+"
                     f"{half.items.shape[0] - half.num_block_items}")
        print(f"TIME {args.tag} {label} F={f} nnzb={half.nnzb} "
              f"rem={half.num_rem}{items}: {k['ms']:.4f} ms, "
              f"torch.sparse.mm {k['library_ms']:.4f}, bound "
              f"{k['bound_ms']:.4f} (share {k['bound_ms'] / k['ms']:.3f}), "
              f"plain {k['plain_ms']:.4f}, err {k['max_abs_err']:.2e}",
              flush=True)
        if libs:
            row = [f"base {cs.cold_ms(torch, lambda: bcsr.hybrid_spmm(half, x)):.4f}"]
            for name, lib in libs.items():
                ms = cs.cold_ms(torch, lambda: cs.hybrid_with(torch, lib, half, x))
                row.append(f"{name} {ms:.4f}")
            row.append(f"base {cs.cold_ms(torch, lambda: bcsr.hybrid_spmm(half, x)):.4f}")
            print(f"VAR {args.tag} {label} F={f}: " + ", ".join(row), flush=True)
        del half
    print(f"== {args.tag} done in {time.perf_counter() - t0:.1f} s", flush=True)
    os._exit(0)


if __name__ == "__main__":
    main()
