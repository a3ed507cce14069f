#!/usr/bin/env python3
"""Variants of the fused kernel's f32 loop, timed on one NVIDIA card.

    python3 tools/f32_tile_variants.py

Each variant is a copy of ``csrc/hybrid_spmm.cu`` rewritten by text
substitution and built by its own nvcc (all in parallel) into a library
with the same C entry point, loaded with ctypes.  Every copy is built with
the widest f32 feature tile 128, so F=768 and F=128 run the 8 x 8 micro-tile;
the kernel as it is and the prefetched loop are also built at 96.
Exact variants must equal the unchanged copy bit for bit; diagnostic ones
(names starting with ``skip``) leave out loads or FMAs and compute garbage,
to show what the loop waits on.  Shapes are those of
``chip_smoke.py``: F=768, 128 and 24 on edge-mode ASTGCN's reversed scaled
Laplacian of the 50,000-node graph, F=256 on the PeMS diffusion operator.
Each is timed cold (``chip_smoke.cold_ms``), every variant twice, in the
order first to last and back.  Needs a card; prints the card's name and
power limit first.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "pytorch_geometric_temporal_tpu_torch" / "csrc" / "hybrid_spmm.cu"
OUT = ROOT / "pytorch_geometric_temporal_tpu_torch" / "build" / "variants"

FG = "static constexpr int FG = f32_feature_groups(UNITS);"
LOOP = "#pragma unroll 2\n        for (int g = 0; g < C::KC / 4; ++g) {"
A_LOAD = """          float a[M::R][4];
#pragma unroll
          for (int i = 0; i < M::R; ++i) lds128(pa[i] ^ (g << 4), a[i]);"""
B_LOAD = """            float b[M::U][4];
#pragma unroll
            for (int m = 0; m < M::U; ++m)
              lds128((pb[m] ^ ((k & 7) << 4)) + k * SW, b[m]);"""
FMAS = """#pragma unroll
            for (int i = 0; i < M::R; ++i)
#pragma unroll
              for (int m = 0; m < M::U; ++m)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  float& d = acc[(i * M::U + m) * 4 + j];
                  d = fmaf(a[i][kk], b[m][j], d);
                }"""
# the same FMAs with the rows innermost: consecutive FMAs share B's operand
ROWS_INNER = """#pragma unroll
            for (int m = 0; m < M::U; ++m)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int i = 0; i < M::R; ++i) {
                  float& d = acc[(i * M::U + m) * 4 + j];
                  d = fmaf(a[i][kk], b[m][j], d);
                }"""
# the loads and the pipeline with no FMA: what the loop costs besides them
NO_FMAS = """#pragma unroll
            for (int i = 0; i < M::R; ++i)
#pragma unroll
              for (int m = 0; m < M::U; ++m)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  asm volatile("" ::"f"(a[i][kk]), "f"(b[m][j]));"""
# A a k-group ahead and B a k ahead, whole float4s, two buffers each
PREFETCH = """        constexpr int G = C::KC / 4;
        float a0[M::R][4], a1[M::R][4], b0[M::U][4], b1[M::U][4];
        auto lda = [&](float (&a)[M::R][4], int g) {
#pragma unroll
          for (int i = 0; i < M::R; ++i) lds128(pa[i] ^ (g << 4), a[i]);
        };
        auto ldb = [&](float (&b)[M::U][4], int k) {
#pragma unroll
          for (int m = 0; m < M::U; ++m)
            lds128((pb[m] ^ ((k & 7) << 4)) + k * SW, b[m]);
        };
        auto mul = [&](const float (&a)[M::R][4], int kk,
                       const float (&b)[M::U][4]) {
#pragma unroll
          for (int i = 0; i < M::R; ++i)
#pragma unroll
            for (int m = 0; m < M::U; ++m)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float& d = acc[(i * M::U + m) * 4 + j];
                d = fmaf(a[i][kk], b[m][j], d);
              }
        };
        lda(a0, 0);
        ldb(b0, 0);
#pragma unroll 1
        for (int g = 0; g < G; g += 2) {
          const int k = 4 * g;
          lda(a1, g + 1);
          ldb(b1, k + 1);
          mul(a0, 0, b0);
          ldb(b0, k + 2);
          mul(a0, 1, b1);
          ldb(b1, k + 3);
          mul(a0, 2, b0);
          ldb(b0, k + 4);
          mul(a0, 3, b1);
          lda(a0, (g + 2) % G);
          ldb(b1, k + 5);
          mul(a1, 0, b0);
          ldb(b0, k + 6);
          mul(a1, 1, b1);
          ldb(b1, k + 7);
          mul(a1, 2, b0);
          ldb(b0, (k + 8) % C::KC);
          mul(a1, 3, b1);
        }
      }
      advance();"""
# A in halves of a k-group and B a row at a time, both double-buffered
DOUBLE = """        constexpr int G = C::KC / 4;
        float a0[M::R][2], a1[M::R][2], b0[M::U][4], b1[M::U][4];
        auto lda = [&](float (&a)[M::R][2], int g, int h) {
#pragma unroll
          for (int i = 0; i < M::R; ++i) {
            const uint32_t p = (pa[i] ^ (g << 4)) + 8 * h;
            asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\\n"
                         : "=f"(a[i][0]), "=f"(a[i][1]) : "r"(p));
          }
        };
        auto ldb = [&](float (&b)[M::U][4], int k) {
#pragma unroll
          for (int m = 0; m < M::U; ++m)
            lds128((pb[m] ^ ((k & 7) << 4)) + k * SW, b[m]);
        };
        auto mul = [&](const float (&a)[M::R][2], int h,
                       const float (&b)[M::U][4]) {
#pragma unroll
          for (int i = 0; i < M::R; ++i)
#pragma unroll
            for (int m = 0; m < M::U; ++m)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float& d = acc[(i * M::U + m) * 4 + j];
                d = fmaf(a[i][h], b[m][j], d);
              }
        };
        lda(a0, 0, 0);
        ldb(b0, 0);
#pragma unroll 2
        for (int g = 0; g < G; ++g) {
          const int k = 4 * g;
          lda(a1, g, 1);
          ldb(b1, k + 1);
          mul(a0, 0, b0);
          ldb(b0, k + 2);
          mul(a0, 1, b1);
          lda(a0, (g + 1) % G, 0);
          ldb(b1, k + 3);
          mul(a1, 0, b0);
          ldb(b0, (k + 4) % C::KC);
          mul(a1, 1, b1);
        }
      }
      advance();"""


def variants(src):
    """{name: source}: the kernel as it is, then each rewrite."""
    tail = "      advance();"
    loop_end = src.index(tail + "\n    }\n\n    // epilogue") + len(tail)
    loop_start = src.index(LOOP)

    def skip_b(t):  # B loaded once a k-group, reused for its 4 k
        t = t.replace(B_LOAD, B_LOAD.replace("float b[M::U][4];\n", "")
                      .replace("lds128(", "if (kk == 0) lds128("))
        return t.replace(A_LOAD, A_LOAD + "\n          float b[M::U][4];")

    def skip_a(t):  # A loaded once a stage, reused for its 8 k-groups
        t = t.replace(A_LOAD, A_LOAD.replace("float a[M::R][4];\n", "")
                      .replace("lds128(", "if (g == 0) lds128("))
        return t.replace(LOOP, "float a[M::R][4];\n" + LOOP)

    return {
        "as built": src,
        "FG=8 (4 x 16)": src.replace(
            FG, "static constexpr int FG = FT == 128 ? 8 : "
                "f32_feature_groups(UNITS);"),
        "FG=32 (16 x 4)": src.replace(
            FG, "static constexpr int FG = FT == 128 ? 32 : "
                "f32_feature_groups(UNITS);"),
        "groups unrolled 8": src.replace(LOOP, LOOP.replace(" 2\n", "\n")),
        "groups unrolled 1": src.replace(LOOP, LOOP.replace(" 2\n", " 1\n")),
        "double-buffered": src[:loop_start] + DOUBLE + src[loop_end:],
        "prefetched": src[:loop_start] + PREFETCH + src[loop_end:],
        "rows innermost": src.replace(FMAS, ROWS_INNER),
        "skip 3/4 of B": skip_b(src),
        "skip 7/8 of A": skip_a(src),
        "skip both": skip_a(skip_b(src)),
        "skip the FMAs": src.replace(FMAS, NO_FMAS),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("f32_tile_variants: CUDA is not available", file=sys.stderr)
        return 2
    from pytorch_geometric_temporal_tpu_torch.models.attention import astgcn
    from pytorch_geometric_temporal_tpu_torch.ops import Graph
    from pytorch_geometric_temporal_tpu_torch.ops.graph import diffusion_norms
    from pytorch_geometric_temporal_tpu_torch.ops.spmm import _auto_bcsr

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    started = {}
    builds = {name: (text, 128) for name, text in variants(src).items()}
    builds["as built, FT<=96"] = (src, 96)
    builds["prefetched, FT<=96"] = (builds["prefetched"][0], 96)
    for i, (name, (text, ft)) in enumerate(builds.items()):
        if not name.startswith("as built") and text == src:
            raise SystemExit(f"variant {name!r} rewrote nothing")
        path = OUT / f"variant{i}.cu"
        path.write_text(text)
        started[name] = cs.start_hybrid_build(
            path, f"variant{i}", [f"PGTT_F32_MAX_FT={ft}"])
    libs = {}
    for name, (proc, out) in started.items():
        out_, err_ = proc.communicate(timeout=600)
        log = out_ + err_
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name!r}:\n{log[-3000:]}")
        regs = {nt: re.search(r"Used (\d+) registers", b).group(1)
                for b in log.split("Compiling entry function")[1:]
                for nt in re.findall(r"kernelIfLi(\d+)E", b)}
        spills = re.findall(r"(\d+) bytes spill stores", log)
        libs[name] = cs.finish_hybrid_build((proc, out))
        print(f"{name}: f32 registers FT=128 {regs['16']}, FT=96 "
              f"{regs['12']}; spill stores {max(map(int, spills))} B at most",
              flush=True)

    rng = np.random.default_rng(cs.SLICE["seed"])
    ei, w = cs.slice_graph(rng)
    g = Graph.from_edge_index(ei, w, num_nodes=cs.SLICE["n"])
    m50 = _auto_bcsr(astgcn._reversed(astgcn._lhat_graph(g, "sym")),
                     torch.float32).fwd
    ei, w = cs.pems_graph(cs.PEMS)
    g = Graph.from_edge_index(ei, w, num_nodes=cs.PEMS["n"])
    pems = _auto_bcsr(diffusion_norms(g)[0], torch.float32).fwd
    names = list(libs)
    for half, f, label in ((m50, 768, "50k"), (m50, 128, "50k"),
                           (m50, 24, "50k"), (pems, 256, "PeMS")):
        x = torch.randn(half.num_cols, f, device="cuda")
        ref = cs.hybrid_with(torch, libs["as built"], half, x)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            run = lambda n=n: cs.hybrid_with(torch, libs[n], half, x)  # noqa
            if not n.startswith("skip") and not torch.equal(run(), ref):
                raise SystemExit(f"variant {n!r} differs at {label} F={f}")
            ms[n].append(cs.cold_ms(torch, run))
        print(f"{label} F={f} (cold ms, first / second pass): " + "; ".join(
            f"{n} {a:.4f} / {b:.4f}" for n, (a, b) in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
