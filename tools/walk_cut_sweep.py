#!/usr/bin/env python3
"""The fused kernel's two f32 tile paths on one NVIDIA card: the same bits
either way, and the tile fill at which walking a tile's nonzeros stops
paying (``ops/bcsr.py`` ``F32_WALK_MAX_NNZ``).

    python3 tools/walk_cut_sweep.py [--skip-sweep] [--variants FILE.json]
                                    [--watchdog S]

1. ``SAME`` lines: on the PeMS stand-in (chip_smoke.py's ``PEMS`` graph:
   ordered, and with its ids scrambled as phase 21 does), on a banded graph
   whose tiles hold 1,800-2,000 nonzeros and on a graph whose tiles mix
   walked and dense ones, each half of the operator as the program builds
   it against the same operator built with every tile dense
   (``F32_WALK_MAX_NNZ = -1``), bit for bit, and against the plain version
   within chip_smoke.py's tolerance, at F in {4, 13, 24, 256, 4224}.
2. ``SWEEP`` lines: 88 row blocks of one diagonal tile of n nonzeros each,
   drawn uniformly (``uniform``) or as a band (``band``: a row's nonzeros
   next to its diagonal), walked and dense, cold L2 (chip_smoke.py
   ``cold_ms``), at F = 96 and 256; then where the walked time's line
   crosses the dense path's median (``CUT`` lines).
3. ``PEMS`` lines: the ordered operator at F = 256 and 4,224 and the
   scrambled one at F = 256, walked and dense, with chip_smoke.py's
   ``fused_report`` (the bound, the plain version, ``torch.sparse.mm``).

``--variants`` names a JSON object ``{name: [[old, new], ...]}``: each
variant is a copy of ``hybrid_spmm.cu`` rewritten by those substitutions,
built beside the kernel (chip_smoke.py ``start_hybrid_build``) and timed
cold on the halves of step 3 and on the sweep's uniform tiles of 2,048 and
3,072 nonzeros at F=256, in the order base, the variants, base (``VAR``
lines), its outputs checked against the base build's bit for bit.

Prints the card's name and power limit first.  A hang ends the process
(``--watchdog``, default 600 s).
"""

import argparse
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SWEEP_NNZ = (128, 256, 512, 1024, 1536, 2048, 3072, 4096, 5120, 6144, 7680)
SWEEP_F = (96, 256)
SAME_F = (4, 13, 24, 256, 4224)


def log(*a):
    print(*a, flush=True)


def dense_twin(bcsr, build):
    """``build()`` with every f32 tile dense."""
    saved = bcsr.F32_WALK_MAX_NNZ
    bcsr.F32_WALK_MAX_NNZ = -1
    try:
        return build()
    finally:
        bcsr.F32_WALK_MAX_NNZ = saved


def graphs(cs):
    """(label, edge_index, weights, n, min_block_edges) of step 1."""
    c = cs.PEMS
    ei, w = cs.pems_graph(c)
    yield "pems-ordered", ei, w, c["n"], 32
    sigma = np.random.default_rng(cs.PEMS_SCRAMBLE_SEED).permutation(c["n"])
    yield "pems-scrambled", sigma[ei], w, c["n"], 32
    rng = np.random.default_rng(7)
    n = 1500
    s = rng.integers(0, n, 30000)
    r = np.clip(s + rng.integers(-40, 41, s.size), 0, n - 1)
    yield ("banded", np.stack([s, r]),
           rng.uniform(0.1, 1.0, s.size).astype(np.float32), n, 32)
    # a band, and a first tile 40% full (~6,550 nonzeros: dense)
    s = np.repeat(np.arange(n), 6)
    r = np.clip(s + rng.integers(-8, 9, s.size), 0, n - 1)
    full = np.flatnonzero(rng.random(128 * 128) < 0.4)
    s = np.concatenate([s, full % 128])
    r = np.concatenate([r, full // 128])
    yield ("mixed", np.stack([s, r]),
           rng.uniform(0.1, 1.0, s.size).astype(np.float32), n, 32)


def same_bits(torch, cs, bcsr, Graph):
    for label, ei, w, n, mbe in graphs(cs):
        g = Graph.from_edge_index(ei, w, num_nodes=n, device="cuda")
        mat = bcsr.BCSRMatrix.from_graph(g, min_block_edges=mbe)
        dense = dense_twin(bcsr, lambda: bcsr.BCSRMatrix.from_graph(
            g, min_block_edges=mbe))
        for side in ("fwd", "bwd"):
            half, twin = getattr(mat, side), getattr(dense, side)
            assert twin.num_walked == 0
            for f in SAME_F:
                x = torch.randn(half.num_cols, f, device="cuda")
                got = bcsr.hybrid_spmm(half, x)
                want = bcsr.hybrid_spmm(twin, x)
                plain = bcsr.hybrid_spmm_plain(half, x)
                torch.cuda.synchronize()
                same = torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
                err = float((got - plain).abs().max())
                line = {"graph": label, "side": side, "f": f,
                        "nnzb": half.nnzb, "walked": half.num_walked,
                        "rem": half.num_rem, "same_bits": same,
                        "err_plain": err, "tol": cs.tol_for(plain)}
                log("SAME " + json.dumps(line))
                if not same or err > line["tol"]:
                    raise SystemExit(f"walked path differs: {line}")


def sweep_half(bcsr, rng, nnz, kind, nrb=88):
    """88 row blocks, one diagonal tile of ``nnz`` distinct nonzeros each."""
    rows, cols = [], []
    for rb in range(nrb):
        if kind == "uniform":
            cells = rng.choice(128 * 128, nnz, replace=False)
            r, c = cells // 128, cells % 128
        else:  # a band: the nnz cells nearest the diagonal
            rr, cc = np.meshgrid(np.arange(128), np.arange(128),
                                 indexing="ij")
            near = np.argsort(np.abs(rr - cc).ravel() + rng.random(128 * 128),
                              kind="stable")[:nnz]
            r, c = near // 128, near % 128
        rows.append(rb * 128 + r)
        cols.append(rb * 128 + c)
    rows = np.concatenate(rows).astype(np.int32)
    cols = np.concatenate(cols).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, rows.size).astype(np.float32)

    def build():
        return bcsr._build_half(rows, cols, vals, nrb * 128, 128, None, 0,
                                device="cuda")
    return build


def sweep(torch, cs, bcsr):
    rng = np.random.default_rng(19)
    saved = bcsr.F32_WALK_MAX_NNZ
    rows = []
    for kind in ("uniform", "band"):
        for nnz in SWEEP_NNZ:
            build = sweep_half(bcsr, rng, nnz, kind)
            bcsr.F32_WALK_MAX_NNZ = 128 * 128
            walked = build()
            bcsr.F32_WALK_MAX_NNZ = -1
            dense = build()
            bcsr.F32_WALK_MAX_NNZ = saved
            for f in SWEEP_F:
                x = torch.randn(walked.num_cols, f, device="cuda")
                line = {"kind": kind, "nnz": nnz, "f": f,
                        "walked_tiles": walked.num_walked,
                        "walked_ms": cs.cold_ms(
                            torch, lambda: bcsr.hybrid_spmm(walked, x)),
                        "dense_ms": cs.cold_ms(
                            torch, lambda: bcsr.hybrid_spmm(dense, x))}
                line["walked_over_dense"] = line["walked_ms"] / line["dense_ms"]
                log("SWEEP " + json.dumps(line))
                rows.append(line)
            del walked, dense
    for kind in ("uniform", "band"):
        for f in SWEEP_F:
            pts = [r for r in rows if r["kind"] == kind and r["f"] == f
                   and r["walked_tiles"]]
            # the walked time's least-squares line against the dense
            # path's median, which no fill moves
            b, a = np.polyfit([r["nnz"] for r in pts],
                              [r["walked_ms"] for r in pts], 1)
            dense = float(np.median([r["dense_ms"] for r in pts]))
            log("CUT " + json.dumps({
                "kind": kind, "f": f, "dense_ms": dense,
                "walked_ms_at_0": a, "walked_ms_per_1024": b * 1024,
                "crossing_nnz": (dense - a) / b}))


def pems_operators(cs, bcsr, Graph):
    """(label, build, widths): the PeMS stand-in's first diffusion operator,
    ordered and with its ids scrambled, as ``build()`` makes it."""
    from pytorch_geometric_temporal_tpu_torch.ops.operators import (
        host_diffusion_norms)

    c = cs.PEMS
    ei, w = cs.pems_graph(c)
    sigma = np.random.default_rng(cs.PEMS_SCRAMBLE_SEED).permutation(c["n"])
    for label, e, fs in (("ordered", ei, (256, 4224)),
                         ("scrambled", sigma[ei], (256,))):
        g = Graph.from_edge_index(e, w, num_nodes=c["n"], device="cpu")
        p = host_diffusion_norms(g, device="cuda")[0]
        yield label, lambda p=p: bcsr.BCSRMatrix.from_graph(
            p, min_block_edges=32), fs


def pems(torch, cs, bcsr, Graph):
    for label, build, fs in pems_operators(cs, bcsr, Graph):
        mat, dense = build(), dense_twin(bcsr, build)
        for f in fs:
            x = torch.randn(mat.fwd.num_cols, f, device="cuda")
            for path, half in (("walked", mat.fwd), ("dense", dense.fwd)):
                k = cs.fused_report(torch, half, x)
                line = {"op": label, "path": path, "f": f,
                        "nnzb": half.nnzb, "walked": half.num_walked,
                        "rem": half.num_rem,
                        **{key: k[key] for key in (
                            "ms", "bound_ms", "plain_ms", "library_ms",
                            "max_abs_err")}}
                line["share_of_bound"] = k["bound_ms"] / k["ms"]
                log("PEMS " + json.dumps(line))


def variant_halves(cs, bcsr, Graph):
    """(label, half, F) the variants are timed on."""
    for label, build, fs in pems_operators(cs, bcsr, Graph):
        half = build().fwd
        for f in fs:
            yield f"pems-{label}", half, f
    rng = np.random.default_rng(19)
    for nnz in (2048, 3072):
        yield f"uniform-{nnz}", sweep_half(bcsr, rng, nnz, "uniform")(), 256


def run_variants(torch, cs, bcsr, Graph, path):
    src = Path(bcsr.__file__).resolve().parent.parent / "csrc" / \
        "hybrid_spmm.cu"
    out = src.parent.parent / "build" / "walk_variants"
    out.mkdir(parents=True, exist_ok=True)
    started = {}
    for name, subs in json.loads(Path(path).read_text()).items():
        text = src.read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: text not found: {old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        started[name] = cs.start_hybrid_build(str(out / f"{name}.cu"),
                                              f"walk_{name}")
    libs = {name: cs.finish_hybrid_build(s) for name, s in started.items()}
    for label, half, f in variant_halves(cs, bcsr, Graph):
        x = torch.randn(half.num_cols, f, device="cuda")
        base = bcsr.hybrid_spmm(half, x)
        row = {"half": label, "f": f, "walked": half.num_walked,
               "base": cs.cold_ms(torch, lambda: bcsr.hybrid_spmm(half, x))}
        for name, lib in libs.items():
            got = cs.hybrid_with(torch, lib, half, x)
            row[name + "_same"] = torch.equal(got.view(torch.int32),
                                              base.view(torch.int32))
            row[name] = cs.cold_ms(
                torch, lambda: cs.hybrid_with(torch, lib, half, x))
        row["base_again"] = cs.cold_ms(torch,
                                       lambda: bcsr.hybrid_spmm(half, x))
        log("VAR " + json.dumps(row))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-sweep", action="store_true")
    ap.add_argument("--variants")
    ap.add_argument("--watchdog", type=float, default=600.0)
    args = ap.parse_args()
    timer = threading.Timer(args.watchdog, lambda: (
        print("walk_cut_sweep: watchdog", file=sys.stderr, flush=True),
        os._exit(124)))
    timer.daemon = True
    timer.start()
    import torch

    import chip_smoke as cs
    from pytorch_geometric_temporal_tpu_torch import csrc
    from pytorch_geometric_temporal_tpu_torch.ops import Graph, bcsr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip(), torch.__version__)
    csrc.load()
    log("build:", csrc.build_info["seconds"], "s")
    log("\n".join(line for line in csrc.build_info["log"].splitlines()
                  if "Compiling entry" in line or "spill" in line
                  or "registers" in line))
    same_bits(torch, cs, bcsr, Graph)
    if args.variants:
        run_variants(torch, cs, bcsr, Graph, args.variants)
    if not args.skip_sweep:
        sweep(torch, cs, bcsr)
    pems(torch, cs, bcsr, Graph)
    log("walk_cut_sweep: ok")
    timer.cancel()


if __name__ == "__main__":
    main()
