#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``pytorch_geometric_temporal_tpu_torch`` only (no JAX):

1. card: name and power limit (nvidia-smi), torch/CUDA versions, and the
   nvcc build of the kernels (``csrc/*.cu``, one nvcc per source, in
   parallel) with its time and ptxas' registers and spills; beside it,
   copies of ``hybrid_spmm.cu`` built with the other widest f32 feature
   tiles of ``F32_FT_SWEEP``, for the sweep of phases 14 and 15;
2. kernels against their plain PyTorch versions on the card: the fused
   hybrid SpMM (the main path) and its baseline pair K1 (tile SpMM) and K2
   (remainder scatter) on f32 and bf16 tiles, both halves, F in
   ``KERNEL_CASE_FS`` (every instantiation; 1, 14 and 36 ragged), a hybrid
   operator, an all-tiles operator, an all-remainder operator, a graph with
   empty row blocks and a GCN-normalized operator (self-loop diagonal), and
   the SHA-256 of the f32 outputs on the hybrid operator; then at the
   slice's own shapes, where each kernel is also timed (CUDA events, L2
   flushed before each launch) beside its byte/op bound, its plain version
   and one ``torch.sparse.mm`` over the same operator as CSR (a yardstick
   the port never calls), and K1 + K2 are timed as a pair;
3. the slice: DCRNNSeq(hidden 64, K=2) training (MSE, Adam 1e-3) over
   bf16-tile BCSR diffusion operators of a 50,000-node, 2,000,000-edge
   banded+random graph (F=32, T=4, B=1), checked against the segment path
   on the card, then a few timed steps with every kernel launch counted
   (the fused kernel once per aggregation, K1 and K2 never);
4. the dense path: one METR-LA-shape step (B=64, T=12, N=207, F=2, K=3),
   which launches no BCSR kernel;
5. the snapshot pipeline on Chickenpox: loader, split, stacked signal,
   GConvGRU(4->32, K=1) + relu + Linear(32->1) through ``SnapshotTrainer``
   (MSE over snapshots, Adam 1e-2, 200 epochs), test MSE and MAE; no BCSR
   kernel is launched;
6. GConvGRU(14->32, K=2) + relu + Linear(32->1) with the hidden state
   threaded through ``SnapshotTrainer`` over the bf16-tile BCSR Chebyshev
   operator of the 50,000-node graph (T=8 snapshots): forward and
   parameter gradients against the f32 segment path, ``cheb_basis`` at
   K=3 too, then epochs with every launch counted (5T-1 fused launches an
   epoch), the device's busy time by kernel, and the fused kernel timed at
   F=14 and F=32 on this operator beside its bound and ``torch.sparse.mm``;
7. a dynamic-edge sequence over ``stack_bcsr``: T=4 operators of 20,000
   nodes and 600,000 edges each, ``h <- tanh(bcsr_spmm(mat_t, h))`` at
   F=64, the fused kernel against its plain version on every step's two
   halves at that width, every step against ``spmm_segment`` on that
   step's graph and the gradient to h0 against the segment path's, T + T
   fused launches;
8. the eight bundled-data accuracy protocols at their full epoch counts
   (PedalMe: DCRNN, TGCN, A3TGCN; TwitterTennis rg17: EvolveGCN-O,
   EvolveGCN-H, DyGrEncoder; EnglandCovid: DCRNN; MontevideoBus:
   GConvGRU): test MSE beside the JAX package's TPU v5e record, seconds
   per epoch; small graphs on the dense branch, no BCSR kernel launched;
9. TGCN(32->32) + relu + Linear(32->1) with the hidden state threaded
   through ``SnapshotTrainer`` over the 50,000-node graph prepared once as
   a bf16-tile GCN BCSR operator (``prepare_graph(kinds=("gcn",))``, which
   ``gcn_norm`` hands to the cell's three ``GCNConv``s): forward and
   parameter gradients against the f32 segment path, 6T fused launches an
   epoch, the device's busy time by kernel, and the fused kernel timed at
   F=32 on this operator;
10. EvolveGCN-O and EvolveGCN-H as ``Seq`` models (``normalize=False``,
   F=16) over ``stack_bcsr_gcn`` of phase 7's four graphs, against the
   same models normalizing in the loop over ``stack_graphs`` on the f32
   segment path (outputs per step, parameter gradients), T + T fused
   launches a model, and the fused kernel against its plain version at
   F=16 on every half, timed;
11. the METR-LA accuracy protocol at full size (``DCRNNSeq(2->2, K=3)``,
   207 sensors, 2880 steps of the seeded synthetic stand-in, 12 epochs of
   batches of 64, Adam 1e-3): falling training curve, the de-normalized
   masked test MAE, seconds per epoch; then at the size of the JAX
   package's records (3 epochs over 720 steps), its MAE beside them; dense
   branch, no BCSR kernel launched;
12. the attention family on the dense branch: ASTGCN and MSTGCN at the
   reference configuration (B=16, N=207, F_in=2, T=12, K=3, 2 blocks,
   64/64 filters, predict 12), five Adam steps each with the device's
   busy time per step and their difference (the attention's share), then
   three Adam steps each of STConv, GMAN, MTGNN, AAGCN and DNNTSP at the
   papers' widths in ``train=True`` (finite, falling loss, moving batch
   statistics); no BCSR kernel launched;
13. two stacked STConv blocks (STGCN's widths: 16 spatial channels, 64
   out, temporal kernel 3, K=3, 12 steps in) and a linear head over the
   50,000-node graph prepared once as a bf16-tile Chebyshev BCSR operator:
   aggregations at F = 10·16 = 160 and 6·16 = 96, outputs and parameter
   gradients against the f32 segment path, 4 forward + 4 backward fused
   launches a step, no operator build and no ``cheb_norm`` inside a step,
   the fused kernel timed at F=160, the device's busy time by kernel;
14. edge-mode ASTGCN (``normalization="sym"``, K=3, 2 blocks, 64/64
   filters) at N=50,000: the reversed scaled Laplacian is tiled once (f32
   tiles) in the first forward, then 2 forward + 2 backward fused launches
   a step; per-edge attention sums to 1 per column; output and gradients
   against ``spmm_backend="segment"``; the fused kernel timed on that f32
   operator at F=24 and F=768, and at F=768 against the copies with the
   other f32 feature tiles (equal bytes, cold times); ``normalization=None``
   builds and launches nothing;
15. index-batched DCRNN at the all-California PeMS scale: the seeded
   stand-in of the JAX package's ``examples/index_batching/
   streaming_out_of_core.py`` (11,160 sensors, speed and time of day, 7
   days of 5-minute steps, z-scored per feature, written to an ``.npy``)
   and its banded graph passed as a raw ``Graph``;
   ``make_index_loaders(lags=12, batch_size=64, shuffle=True)`` into
   ``BatchTrainer`` with masked MAE on de-normalized values,
   ``DCRNNSeq(2, 2, K=2)``, 3 epochs with validation and a test pass:
   the card's windows against ``IndexDataset``'s host windows, the first
   batch against the f32 segment path, exactly 2 operator builds, 94
   fused launches a train batch and 48 an eval batch, a falling loss, a
   ``StreamingWindower`` over the file against the device windower, step
   and streaming times, and the fused kernel on that f32 operator at
   F = 64·4 = 256: timed, and against the copies with the other f32
   feature tiles; the SHA-256 of the kernel's output on the raw graph's
   tiles at that width;
16. phase 3's DCRNNSeq and operators trained through
   ``make_mixed_precision_step`` with ``bf16_policy`` (f32 master
   parameters in a ``TrainState``, bf16 compute, Adam 1e-3): forward and
   parameter gradients against the f32 segment path, bf16 predictions, 30
   fused launches a step and none of K1/K2, a falling loss, the step time
   and the device's busy time beside phase 3's f32-compute step; then
   ``f16_policy`` with a ``DynamicLossScale``: a planted overflow batch
   leaves parameters, Adam moments and step counts unchanged bit for bit
   and halves the scale, two clean steps double it;
17. ``HeteroGCLSTM`` (32 channels) + a shared head over a
   ``StaticHeteroGraphTemporalSignal`` with node types of 50,000 (F=8)
   and 20,000 (F=4) nodes and 1,000,000 banded edges each way, T=8,
   stacked (``StackedHeteroSignal``) and trained through
   ``SnapshotTrainer`` for 3 epochs: one snapshot's outputs and gradients
   on the card against the port on the CPU, no BCSR launch (bipartite
   SAGEConv aggregates on the segment path), a falling loss, host epoch
   times, peak memory (``device_memory_stats``), the device's busy time;
18. the training harness (``protocols/harness.py``: ``TrainState``,
   ``CheckpointManager``, ``DivergenceGuard``, ``StepTimer``, early
   stopping) on Chickenpox for 10 epochs; a second run stopped at epoch 5
   and resumed from its checkpoints must equal it within 1e-6 relative
   (and says whether to the bit); two checkpoints kept; a planted NaN
   epoch rolled back.

A watchdog ends the process if the whole run passes 1150 s (a hang in a
kernel must not outlive the run).  Exits non-zero, and prints no result,
without CUDA or when any check fails.  The last line is ``{"ok": true,
"device": {...}}``; the line before it holds the per-kernel JSON record,
its launch counts summed over phases 3, 6, 7, 9, 10, 13, 14, 15 and 16; the
fused kernel's time and share of its bound at each path's own width, and
the f32 feature-tile sweep, stand on the lines before the total.
"""

import contextlib
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12,     # dense tensor-core rate
              "f32": 67e12}       # CUDA-core FMA rate
SLICE = dict(n=50_000, deg=40, f=32, hidden=64, t=4, band=96, seed=3)
STEPS = 5          # counted training steps (the main path)
TIMED_STEPS = 20   # further steps timed on the host clock
CHICKENPOX_EPOCHS = 200
CHEB = dict(lags=14, hidden=32, K=2, t=8, epochs=5, timed_epochs=10)
DYNAMIC = dict(n=20_000, deg=30, t=4, f=64, band=64, seed=0)
# bf16 tiles and bf16-cast activations in every hop, ~2^-9 relative
# rounding per product term, against the f32 segment path
FWD_TOL, GRAD_TOL = 2e-2, 3e-2
# phases 6 and 7: about three times the errors read on an H100 (phase 6:
# forward 1.8e-3, basis 1.9e-3 of its largest value, parameter gradients
# 8.8e-3 relative; phase 7: steps 1.5e-3 to 2.7e-3 of each step's largest
# value, gradient to h0 2.1e-3 relative)
CHEB_FWD_TOL, CHEB_BASIS_TOL, CHEB_GRAD_TOL = 5e-3, 6e-3, 2e-2
DYN_STEP_TOL, DYN_GRAD_TOL = 1e-2, 6e-3
# phase 8: epochs of each protocol, and the JAX package's record of the same
# protocol on a TPU v5e (another framework's initial draw)
PROTOCOLS = {
    "pedalme_dcrnn": (200, 0.6842),
    "pedalme_tgcn": (50, 0.5911),
    "pedalme_a3tgcn": (50, 0.5697),
    "twittertennis_evolvegcno": (200, 0.2928),
    "twittertennis_evolvegcnh": (200, 0.2769),
    "twittertennis_dygrae": (200, 0.2448),
    "englandcovid_dcrnn": (100, 0.9235),
    "montevideobus_gconvgru": (50, 0.9251),
}
TGCN = dict(f=32, hidden=32, t=8, epochs=5, timed_epochs=10)
EVOLVE = dict(f=16)
# phases 9 and 10: about three times the errors read on an H100 (phase 9:
# forward 4.9e-4, parameter gradients 3.3e-2 relative, the worst on the r
# gate, whose gradient is ~1e-5 in size; phase 10: steps 3.9e-3 to 5.6e-3
# of each step's largest value, parameter gradients 1.4e-4 relative)
TGCN_FWD_TOL, TGCN_GRAD_TOL = 1.5e-3, 1e-1
EVO_STEP_TOL, EVO_GRAD_TOL = 1.7e-2, 5e-4
WATCHDOG_S = 1150
# phase 2's widths: each f32 and bf16 instantiation of the fused kernel
# (n-tile counts 1, 2, 4, 5, 6, 8, 12, 16; 1 and 14 ragged), two feature
# tiles at F=200; the f32 digests of phases 2 and 15 draw x from DIGEST_SEED
KERNEL_CASE_FS = (1, 8, 14, 16, 32, 36, 48, 64, 96, 128, 200)
DIGEST_SEED = 7
# the widest f32 feature tiles phases 14 and 15 time against each other
F32_FT_SWEEP = (64, 96, 128)
# phase 11: the protocol at full size, and at the size at which the JAX
# package's records were taken (3 epochs over 720 steps): on a TPU v5e, and
# its torch-CPU twin's, both from another framework's initial draw
METRLA = dict(epochs=12, batch_size=64, t_len=2880, K=3, n=207)
METRLA_RECORD_CONFIG = dict(METRLA, epochs=3, t_len=720)
METRLA_RECORD_TPU, METRLA_RECORD_TORCH_CPU = 3.9036, 3.9047
# phase 12: the reference configuration of ASTGCN / MSTGCN
ATT = dict(b=16, n=207, f=2, t=12, k=3, blocks=2, filters=64, steps=5)
# phase 13: STGCN's widths (Yu et al., IJCAI 2018)
STGCN = dict(f_in=1, spatial=16, out=64, kernel=3, K=3, t=12, steps=5,
             timed_steps=10)
# phase 14
EDGE = dict(f_in=2, t=12, K=3, blocks=2, filters=64, steps=3)
# phases 13 and 14 against the f32 segment path (forward; gradients by the
# largest entry; gradients by the 2-norm): about three times the errors
# read on an H100 (phase 13, bf16 tiles: 1.2e-2 on outputs up to 3.5, 2.2e-1
# and 4.7e-2, both on block 1's per-node batch-norm bias; phase 14, f32
# tiles, where only the order of the sums differs: 2.3e-6 on outputs up to
# 4.1 in every run; the gradients' worst entry is the sparse attention's
# scalar bias, a sum over 2.1 M edges that nearly cancels, which both paths
# add with atomics in an order that changes from run to run: 1.9e-6, 1.8e-5
# and 2.9e-4 in three runs, so phase 14's gradient limits stand well above
# that noise and below the ~1e-1 of a misplaced tile or bf16 rounding)
STCONV_TOLS = (3.5e-2, 6.5e-1, 1.5e-1)
EDGE_TOLS = (1e-4, 1e-2, 1e-2)
# phase 15: PGT-I's PeMS defaults (lags 12, batches of 64, DCRNN K=2 at the
# width of the JAX package's examples/index_batching/streaming_out_of_core.py)
# over that script's all-California stand-in: 11,160 sensors, speed and time
# of day, 7 days of 5-minute steps, a banded graph of degree 6
PEMS = dict(n=11_160, f=2, days=7, steps_per_day=288, lags=12,
            batch_size=64, K=2, epochs=3, deg=6, offset=8, seed=0,
            graph_seed=1, batches=(22, 4, 7))
# phase 15 against the f32 segment path (forward; gradients by the largest
# entry; gradients by the 2-norm): f32 tiles, where only the order of the
# sums differs; about three times the errors read on an H100 (4.0e-7 on
# outputs up to 0.94, 1.3e-7 and 1.1e-7, both at cell.b_h)
PEMS_TOLS = (1.5e-6, 5e-7, 5e-7)
# phase 16: phase 3's model in bf16 compute against the f32 segment path
# (forward by the largest output; parameter gradients by each gradient's
# largest entry): about three times the errors read on an H100 (9.2e-3
# forward, 5.9e-3 on gradients, at cell.b_h); the f16 branch's loss scale
MIXED = dict(steps=5, timed_steps=10, f16_scale=256.0, growth_interval=2)
MIXED_TOLS = (3e-2, 2e-2)
# phase 17: two node types with typed edges both ways at the slice's scale
HETERO = dict(n_a=50_000, f_a=8, n_b=20_000, f_b=4, e=1_000_000, band=96,
              hidden=32, t=8, epochs=3, seed=5)
# card against CPU: atomics on both sides (1e-4 of the outputs' scale, 1e-2
# of each gradient's largest entry)
HETERO_TOLS = (1e-4, 1e-2)
# phase 18: the harness protocol on Chickenpox, and where a run resumes
HARNESS = dict(epochs=10, resume_at=5, nan_epoch=2)
HARNESS_RESUME_TOL = 1e-6


def log(*a):
    print(*a, flush=True)


def banded_graph(rng, n, e, band, frac_local=0.95):
    """The bench's large-N graph: ``frac_local`` of the edges within
    ±band of their source, the rest uniform random."""
    e_loc = int(e * frac_local)
    s = rng.integers(0, n, size=e_loc)
    r = np.clip(s + rng.integers(-band, band + 1, size=e_loc), 0, n - 1)
    s = np.concatenate([s, rng.integers(0, n, size=e - e_loc)])
    r = np.concatenate([r, rng.integers(0, n, size=e - e_loc)])
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    return np.stack([s, r]), w


def slice_graph(rng):
    """The large-N graph of phases 3 and 6 (the first draws of ``rng``)."""
    c = SLICE
    return banded_graph(rng, c["n"], c["n"] * c["deg"], c["band"])


def cold_ms(torch, fn, reps=30, warmup=3):
    """Median ms of one ``fn()`` launch, timed with CUDA events, with the
    50 MB L2 flushed (a 256 MB buffer zeroed) before each launch."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def tol_for(ref):
    # both sides sum the same f32 products (bf16 values are exact in f32),
    # in another order: a few f32 ulps of the largest output
    return 1e-4 * max(1.0, float(ref.abs().max()))


def check_kernels(torch, bcsr, half, x):
    """The fused kernel, K1 and K2 against their plain versions on one
    (half, x); returns {name: (err, tol)}."""
    def err(got, want):
        torch.cuda.synchronize()
        return float((got - want).abs().max()), tol_for(want)

    p1 = bcsr.tile_spmm_plain(half, x)
    return {
        "fused": err(bcsr.hybrid_spmm(half, x),
                     bcsr.hybrid_spmm_plain(half, x)),
        "K1": err(bcsr.tile_spmm(half, x), p1),
        "K2": err(bcsr.rem_scatter_(half, x, p1.clone()),
                  bcsr.rem_scatter_plain(half, x, p1.clone())),
    }


def fmt_errs(errs):
    return "  ".join(f"{k} err {e:.2e} (tol {t:.1e})"
                     for k, (e, t) in errs.items())


def f32_feature_tiles():
    """(the widest f32 feature tile ``hybrid_spmm.cu`` is built with, the
    others of ``F32_FT_SWEEP``, which the sweep of phases 14 and 15
    times)."""
    from pytorch_geometric_temporal_tpu_torch import csrc

    src = (Path(csrc.__file__).parent / "hybrid_spmm.cu").read_text()
    ft = int(re.search(r"#define PGTT_F32_MAX_FT (\d+)", src).group(1))
    return ft, [t for t in F32_FT_SWEEP if t != ft]


def start_hybrid_build(src, name, defines=()):
    """Start nvcc on one copy of ``hybrid_spmm.cu`` into a library of its
    own, ``build/kernels/<name>.so``, with the kernel flags and ``defines``;
    returns (process, path) for :func:`finish_hybrid_build`."""
    from pytorch_geometric_temporal_tpu_torch import csrc

    csrc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = csrc.BUILD_DIR / f"{name}.so"
    cmd = [csrc._nvcc(), *csrc.NVCC_FLAGS, *(f"-D{d}" for d in defines),
           "-shared", "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), out


def finish_hybrid_build(started):
    """Wait for :func:`start_hybrid_build` and load its library."""
    proc, out = started
    _, stderr = proc.communicate(timeout=600)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {out.name}:\n{stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgtt_hybrid_spmm.argtypes = [p, i, i, p, p, p, p, p, p, i, p, i, i,
                                     p]
    lib.pgtt_hybrid_spmm.restype = i
    return lib


def hybrid_with(torch, lib, half, x):
    """The fused kernel of another build ``lib`` on (half, x), with the
    arguments ``bcsr.hybrid_spmm`` passes; no launch is counted."""
    f = x.shape[1]
    out = torch.empty((half.num_rows, f), dtype=torch.float32, device="cuda")
    rc = lib.pgtt_hybrid_spmm(
        half.blocks.data_ptr(), half.blocks.shape[0],
        int(half.blocks.dtype == torch.bfloat16), half.tile_ptr.data_ptr(),
        half.block_cols.data_ptr(), half.rem_row_ptr.data_ptr(),
        half.rem_row_cols.data_ptr(), half.rem_row_vals.data_ptr(),
        x.data_ptr(), half.num_cols, out.data_ptr(), half.num_rows // 128, f,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"hybrid_spmm of another build: CUDA error {rc}")
    return out


def f32_digest(torch, halves, fs, seed):
    """SHA-256 of the fused kernel's outputs on f32 tiles, over each half
    and each F in ``fs``, with x drawn by numpy from ``seed``: sums in a
    fixed order give the same bytes on every run and every build that
    keeps that order."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    rng = np.random.default_rng(seed)
    digest = hashlib.sha256()
    for half in halves:
        for f in fs:
            x = torch.from_numpy(rng.normal(size=(half.num_cols, f)).astype(
                np.float32)).cuda()
            digest.update(bcsr.hybrid_spmm(half, x).cpu().numpy().tobytes())
    return digest.hexdigest()


def sweep_f32_tile(torch, kernel_report, half, f, label):
    """The f32 feature-tile sweep on (half, F=f): this build's kernel
    against the builds with the other widest f32 tiles, outputs equal bit
    for bit (no sum's order depends on the tile), then cold ms of this
    build, each other one twice, and this build again."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    ft, others = f32_feature_tiles()
    x = torch.randn(half.num_cols, f, device="cuda")
    runs = {ft: lambda: bcsr.hybrid_spmm(half, x)}
    for t, lib in zip(others, kernel_report["f32_other_libs"]):
        runs[t] = lambda lib=lib: hybrid_with(torch, lib, half, x)
        if not torch.equal(runs[ft](), runs[t]()):
            raise SystemExit(f"f32 feature tiles {ft} and {t} differ at F={f}")
    ms = {t: [] for t in runs}
    for t in [ft] + [t for t in others for _ in (0, 1)] + [ft]:
        ms[t].append(cold_ms(torch, runs[t]))
    line = f"{label} F={f}: " + ", ".join(
        f"FT<={t} " + " / ".join(f"{v:.4f}" for v in ms[t]) + " ms"
        for t in sorted(ms)) + (f"; built with FT<={ft}; outputs equal bit "
                                "for bit")
    log("  f32 feature-tile sweep: " + line)
    kernel_report["f32_sweep"].append(line)


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from pytorch_geometric_temporal_tpu_torch import csrc

    # the copies with the other widest f32 feature tiles build beside the
    # library, for the sweep of phases 14 and 15
    _, others = f32_feature_tiles()
    t0 = time.perf_counter()
    started = [start_hybrid_build(
        Path(csrc.__file__).parent / "hybrid_spmm.cu", f"hybrid_f32_ft{t}",
        [f"PGTT_F32_MAX_FT={t}"]) for t in others]
    try:
        csrc.load()
    except BaseException:
        for proc, _ in started:
            proc.kill()
            proc.wait()
        raise
    t1 = time.perf_counter()
    other_libs = [finish_hybrid_build(s) for s in started]
    log(f"kernel build+load: {t1 - t0:.2f} s (nvcc "
        f"{csrc.build_info['seconds']}); the f32 FT<={others} copies of "
        f"hybrid_spmm.cu beside it, done at {time.perf_counter() - t0:.2f} s")
    for line in csrc.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())
    return smi, other_libs


def phase_kernel_cases(torch):
    from pytorch_geometric_temporal_tpu_torch.ops import (
        Graph, bcsr, host_gcn_norm)
    from pytorch_geometric_temporal_tpu_torch.ops.bcsr import BCSRMatrix

    rng = np.random.default_rng(0)
    n = 1000
    ei, w = banded_graph(rng, n, 20_000, band=40, frac_local=0.96)
    whole = Graph.from_edge_index(ei, w, num_nodes=n)
    # empty row blocks: nodes 384..639 (row blocks 3 and 4) get no edges
    keep = ~((ei[1] >= 384) & (ei[1] < 640))
    graphs = {
        "hybrid": (whole, 32),
        "all-tiles": (whole, 0),
        "all-remainder": (whole, 10**6),
        "empty-rows": (Graph.from_edge_index(ei[:, keep], w[keep],
                                             num_nodes=n), 32),
        "gcn": (host_gcn_norm(whole), 32),
    }
    worst = 0.0
    for name, (g, mbe) in graphs.items():
        for dtype in (torch.float32, torch.bfloat16):
            mat = BCSRMatrix.from_graph(g, dtype=dtype, min_block_edges=mbe)
            for side in ("fwd", "bwd"):
                half = getattr(mat, side)
                for f in KERNEL_CASE_FS:
                    x = torch.randn(half.num_cols, f, device="cuda")
                    x = x.to(dtype)
                    errs = check_kernels(torch, bcsr, half, x)
                    ok = all(e <= t for e, t in errs.values())
                    log(f"  {name:13s} {str(dtype)[6:]:8s} {side} F={f:3d} "
                        f"nnzb={half.nnzb:3d} rem={half.num_rem:5d} "
                        f"{fmt_errs(errs)}{'' if ok else '  FAIL'}")
                    if not ok:
                        raise SystemExit(f"kernel mismatch: {name}")
                    worst = max([worst] + [e / t for e, t in errs.values()])
    log(f"kernel cases: all within tolerance (worst err/tol {worst:.3f})")
    mat = BCSRMatrix.from_graph(whole, dtype=torch.float32, min_block_edges=32)
    digest = f32_digest(torch, (mat.fwd, mat.bwd), KERNEL_CASE_FS, DIGEST_SEED)
    log(f"  f32 digest, the hybrid operator's two halves at F in "
        f"{KERNEL_CASE_FS}, x from numpy seed {DIGEST_SEED}: {digest}")


def _csr_of(torch, rows, cols, vals, shape):
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                  shape).coalesce()
    return coo.to_sparse_csr()


def tile_operator_coo(torch, half):
    t, r, c = torch.nonzero(half.blocks[:half.nnzb], as_tuple=True)
    vals = half.blocks[:half.nnzb][t, r, c]
    rows = half.block_rows.long()[t] * 128 + r
    cols = half.block_cols.long()[t] * 128 + c
    return rows, cols, vals


def bound_of(n_bytes, ops_by_type):
    """(bound ms, what binds): bytes at the HBM rate against the operations
    at each type's peak rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[dt] for dt, n in ops_by_type.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fused_report(torch, half, x):
    """The fused kernel on (half, x): error against its plain version, cold
    time, the plain version's and ``torch.sparse.mm``'s over the whole half
    as one CSR in the tiles' type, and the bound.  The bound counts each
    input once — the tiles and their pointers, the x rows of the
    referenced column blocks and of the remainder columns (a union), 8 B
    per remainder edge (column, value) and the row pointers — and the f32
    output written once."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    f = x.shape[1]
    dt = "bf16" if half.blocks.dtype == torch.bfloat16 else "f32"
    s_t, s_x = half.blocks.element_size(), x.element_size()
    nb = half.num_rows // 128
    x_used = torch.zeros(half.num_cols, dtype=torch.bool, device="cuda")
    x_used.view(nb, 128)[half.block_cols.long()] = True
    x_used[half.rem_row_cols.long()] = True
    x_rows = int(x_used.sum())
    n_bytes = (half.nnzb * 128 * 128 * s_t + (nb + 1 + half.nnzb) * 4
               + x_rows * f * s_x + half.num_rem * 8
               + (half.num_rows + 1) * 4 + half.num_rows * f * 4)
    # tile products at the tiles' type, the remainder's on the CUDA cores
    ops = {dt: 2 * half.nnzb * 128 * 128 * f}
    ops["f32"] = ops.get("f32", 0) + 2 * half.num_rem * f
    bound, by = bound_of(n_bytes, ops)
    rows, cols, vals = tile_operator_coo(torch, half)
    whole_csr = _csr_of(
        torch, torch.cat([rows, half.rem_rows]),
        torch.cat([cols, half.rem_cols.long()]),
        torch.cat([vals, half.rem_vals.to(half.blocks.dtype)]),
        (half.num_rows, half.num_cols))
    got = bcsr.hybrid_spmm(half, x)
    want = bcsr.hybrid_spmm_plain(half, x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > tol_for(want):
        raise SystemExit(f"fused kernel mismatch at F={f}: {err:.3e}")
    return {
        "ms": cold_ms(torch, lambda: bcsr.hybrid_spmm(half, x)),
        "plain_ms": cold_ms(torch,
                            lambda: bcsr.hybrid_spmm_plain(half, x)),
        "library_ms": cold_ms(torch, lambda: torch.sparse.mm(whole_csr, x)),
        "bound_ms": bound, "bound_by": by, "bytes": n_bytes,
        "ops": sum(ops.values()), "x_rows": x_rows, "max_abs_err": err,
        "dtype": dt,
    }


def log_kernel(name, k):
    log(f"  {name}: {k['ms']:.4f} ms  bound {k['bound_ms']:.4f} ms "
        f"({k['bound_by']}, {k['bytes']} B, {k['ops']} flop; share "
        f"{k['bound_ms'] / k['ms']:.3f})  plain {k['plain_ms']:.4f} ms  "
        f"torch.sparse.mm ({k['dtype']} CSR) {k['library_ms']:.4f} ms")


def report_fused(torch, kernel_report, half, f, label):
    """:func:`fused_report` at width ``f`` on ``half``, logged and entered
    into the run's record as the path ``label``."""
    x = torch.randn(half.num_cols, f, device="cuda").to(half.blocks.dtype)
    k = fused_report(torch, half, x)
    log_kernel(f"fused hybrid_spmm F={f}", k)
    log(f"    fused / torch.sparse.mm {k['ms'] / k['library_ms']:.3f}; "
        f"err {k['max_abs_err']:.2e}")
    kernel_report["H"]["max_abs_err"] = max(
        kernel_report["H"]["max_abs_err"], k["max_abs_err"])
    kernel_report["paths"].append((f"{label} F={f}", k))


def phase_slice_kernels(torch, ops, f):
    """The three kernels at the slice's shapes: checked on all four halves,
    timed on the forward operator's forward half."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    errs = {"fused": 0.0, "K1": 0.0, "K2": 0.0}
    for op_name in ("p_fwd", "p_bwd"):
        mat = getattr(ops, op_name)
        for side in ("fwd", "bwd"):
            half = getattr(mat, side)
            x = torch.randn(half.num_cols, f, device="cuda").to(
                half.blocks.dtype)
            case = check_kernels(torch, bcsr, half, x)
            log(f"  slice {op_name}.{side} F={f} nnzb={half.nnzb} "
                f"rem={half.num_rem} rem_rbs={half.rem_rbs.numel()} "
                f"{fmt_errs(case)}")
            if any(e > t for e, t in case.values()):
                raise SystemExit(f"slice kernel mismatch on {op_name}.{side}")
            for k, (e, _) in case.items():
                errs[k] = max(errs[k], e)

    half = ops.p_fwd.fwd
    x = torch.randn(half.num_cols, f, device="cuda").to(half.blocks.dtype)
    dt = "bf16" if half.blocks.dtype == torch.bfloat16 else "f32"
    s_t = half.blocks.element_size()
    s_x = x.element_size()
    nb = half.num_rows // 128
    shape = (half.num_rows, half.num_cols)

    # K1: tiles, the x column blocks they reference, the f32 output
    ucols = int(torch.unique(half.block_cols).numel())
    k1_bytes = (half.nnzb * 128 * 128 * s_t + ucols * 128 * f * s_x
                + half.num_rows * f * 4 + (nb + 1 + half.nnzb) * 4)
    k1_ops = 2 * half.nnzb * 128 * 128 * f
    k1_bound, k1_by = bound_of(k1_bytes, {dt: k1_ops})
    rows, cols, vals = tile_operator_coo(torch, half)
    tiles_csr = _csr_of(torch, rows, cols, vals, shape)
    k1 = {
        "ms": cold_ms(torch, lambda: bcsr.tile_spmm(half, x)),
        "plain_ms": cold_ms(torch, lambda: bcsr.tile_spmm_plain(half, x)),
        "library_ms": cold_ms(torch,
                              lambda: torch.sparse.mm(tiles_csr, x)),
        "bound_ms": k1_bound, "bound_by": k1_by,
        "bytes": k1_bytes, "ops": k1_ops,
    }

    # K2: what the function needs: each remainder edge's column, value and
    # row (12 B), the distinct x rows gathered, and the distinct output rows
    # that receive an edge, read and written.  (The kernel moves whole
    # 128-row output blocks; that is its cost, not the bound's.)
    rrows = half.rem_rows
    x_rows = int(torch.unique(half.rem_cols).numel())
    out_rows = int(torch.unique(rrows).numel())
    k2_bytes = half.num_rem * 12 + x_rows * f * s_x + out_rows * f * 4 * 2
    k2_ops = 2 * half.num_rem * f
    k2_bound, k2_by = bound_of(k2_bytes, {"f32": k2_ops})
    log(f"  K2 bound counts {half.num_rem} edges, {x_rows} x rows, "
        f"{out_rows} output rows (of {half.rem_rbs.numel() * 128} in the "
        f"row blocks the kernel reads and writes)")
    rvals = half.rem_vals.to(half.blocks.dtype)
    rem_csr = _csr_of(torch, rrows, half.rem_cols.long(), rvals, shape)
    base = bcsr.tile_spmm(half, x)
    k2 = {
        "ms": cold_ms(torch, lambda: bcsr.rem_scatter_(half, x, base)),
        "plain_ms": cold_ms(torch,
                            lambda: bcsr.rem_scatter_plain(half, x, base)),
        # computes less than K2: writes new bf16 rows, adds into nothing
        "library_ms": cold_ms(torch, lambda: torch.sparse.mm(rem_csr, x)),
        "bound_ms": k2_bound, "bound_by": k2_by,
        "bytes": k2_bytes, "ops": k2_ops,
    }

    h = fused_report(torch, half, x)
    pair_ms = cold_ms(
        torch, lambda: bcsr.rem_scatter_(half, x, bcsr.tile_spmm(half, x)))
    for name, k in (("fused hybrid_spmm", h), ("K1 tile_spmm", k1),
                    ("K2 rem_scatter_", k2)):
        k["dtype"] = dt
        log_kernel(name, k)
    log(f"  fused counts {h['x_rows']} x rows; K1 then K2 as a pair "
        f"{pair_ms:.4f} ms (sum of singles {k1['ms'] + k2['ms']:.4f}); "
        f"fused / pair {h['ms'] / pair_ms:.3f}; fused / torch.sparse.mm "
        f"over the whole half {h['ms'] / h['library_ms']:.3f}")
    h["max_abs_err"] = max(h["max_abs_err"], errs["fused"])
    k1["max_abs_err"], k2["max_abs_err"] = errs["K1"], errs["K2"]
    return h, k1, k2


def expected_launches(T, K, steps):
    """Fused-kernel launches of ``steps`` training steps of DCRNNSeq over
    BCSR diffusion operators: one per bcsr_matmul.

    Forward: per time step 2 diffusion bases x 2 directions x (K-1) hops.
    Backward: one bcsr_matmul on the transposed half per forward product
    whose input needs a gradient — all but the first basis at t=0, whose
    input concat([x, h0]) holds no parameter (K-1 products per direction).
    """
    n_fwd = T * 2 * (K - 1)
    n_bwd = n_fwd - (K - 1)
    return 2 * (n_fwd + n_bwd) * steps


def phase_slice(torch, kernel_report):
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import (
        DiffusionOperators, Graph, bcsr)
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer, mse

    c = SLICE
    rng = np.random.default_rng(c["seed"])
    e = c["n"] * c["deg"]
    t0 = time.perf_counter()
    ei, w = slice_graph(rng)
    g = Graph.from_edge_index(ei, w, num_nodes=c["n"])
    x_np = rng.normal(size=(1, c["t"], c["n"], c["f"])).astype(np.float32)
    y_np = rng.normal(size=(1, c["t"], c["n"], c["hidden"])).astype(
        np.float32)
    ops = DiffusionOperators.from_graph(g, bcsr=True, dtype=torch.bfloat16)
    ops_seg = DiffusionOperators.from_graph(g, bcsr=False)
    log(f"  graph N={c['n']} E={e}: operators built in "
        f"{time.perf_counter() - t0:.1f} s; "
        + ", ".join(f"{o}.{s}: nnzb={getattr(getattr(ops, o), s).nnzb} "
                    f"rem={getattr(getattr(ops, o), s).num_rem}"
                    for o in ("p_fwd", "p_bwd") for s in ("fwd", "bwd")))

    f_basis = c["f"] + c["hidden"]   # spmm input width: concat([x, h])
    h, k1, k2 = phase_slice_kernels(torch, ops, f_basis)
    kernel_report.update(H=h, K1=k1, K2=k2,
                         paths=[(f"diffusion F={f_basis}", h)])

    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()
    gen = torch.Generator().manual_seed(0)
    model = DCRNNSeq(c["f"], c["hidden"], K=2, generator=gen)

    # forward and input gradient against the segment path (f32) on the card
    def fwd_grad(operators):
        xr = x.clone().requires_grad_()
        out = model(xr, operators)
        (gx,) = torch.autograd.grad(mse(out, y), xr)
        return out.detach(), gx

    out_b, gx_b = fwd_grad(ops)
    with config_override(spmm_backend="segment"):
        out_s, gx_s = fwd_grad(ops_seg)
    torch.cuda.synchronize()
    fwd_err = float((out_b - out_s).abs().max())
    grad_rel = float((gx_b - gx_s).abs().max() / gx_s.abs().max())
    log(f"  vs segment path: forward max abs err {fwd_err:.3e} (tol "
        f"{FWD_TOL}), input-grad max rel err {grad_rel:.3e} (tol {GRAD_TOL})")
    if not (fwd_err <= FWD_TOL and grad_rel <= GRAD_TOL):
        raise SystemExit("slice does not match the segment path")

    trainer = BatchTrainer(model, lambda xb: model(xb, ops), lr=1e-3,
                           loss_fn=mse)
    trainer.train_step(x, y)  # warm-up step (allocator, cuBLAS handles)
    torch.cuda.synchronize()

    bcsr.reset_launch_counts()
    losses = [float(trainer.train_step(x, y)) for _ in range(STEPS)]
    launches = launch_counts(bcsr)
    want = expected_launches(c["t"], 2, STEPS)
    log(f"  launches over {STEPS} steps: fused {launches['H']} (expected "
        f"{want}), K1 {launches['K1']} and K2 {launches['K2']} (expected 0)")
    if launches != {"H": want, "K1": 0, "K2": 0}:
        raise SystemExit("launch counts differ from the model's count")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite loss: {losses}")
    log(f"  losses {['%.6f' % v for v in losses]}")
    step_s = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(x, y)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s)
    log(f"  step time over {TIMED_STEPS} steps (host clock, synchronized): "
        f"median {med * 1e3:.3f} ms, min {min(step_s) * 1e3:.3f} ms, max "
        f"{max(step_s) * 1e3:.3f} ms; {e * c['t'] * 4 / med:.4e} edges/s "
        f"(E*T*4/step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for key in ("H", "K1", "K2"):
        kernel_report[key]["launches"] = launches[key]
    busy = profile_steps(torch, lambda: trainer.train_step(x, y), med * 1e3)
    # phase 16 trains the same model and operators in bf16 compute
    kernel_report["slice"] = dict(ops=ops, ops_seg=ops_seg, x=x, y=y,
                                  busy_ms=busy, step_ms=med * 1e3)


def device_time_by_kernel(torch, fn, n):
    """({kernel name: (device us, count)}, wall us) over ``n`` calls of
    ``fn`` under torch.profiler: device-side kernels and copies only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    agg = {}
    for ev in prof.events():
        # GPU user annotations (the optimizer's range) overlap the kernels
        # and are left out
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and not ev.name.startswith("Optimizer.")):
            us, cnt = agg.get(ev.name, (0.0, 0))
            agg[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    return agg, wall_us


def profile_steps(torch, step, step_ms, n=2, top=12, unit="step"):
    """Device time by kernel over ``n`` training steps, and the device's
    busy share of the unprofiled median step ``step_ms`` (one stream, so
    kernel times do not overlap).  Returns the busy ms per step, None if
    no device time was recorded."""
    agg, wall_us = device_time_by_kernel(torch, step, n)
    rows = sorted(((us, cnt, name) for name, (us, cnt) in agg.items()),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("  profile: no device time recorded (not measured)")
        return None
    busy_ms = busy / n / 1e3
    log(f"  profile over {n} {unit}s: device busy {busy_ms:.3f} ms per "
        f"{unit} ({wall_us / n / 1e3:.3f} ms wall under the profiler); busy "
        f"share of the unprofiled median {unit} {busy_ms / step_ms:.3f}; "
        f"top kernels by device time:")
    for dev, count, key in rows[:top]:
        log(f"    {dev / n / 1e3:8.3f} ms/{unit} {count // n:5d}x/{unit}  "
            f"{100 * dev / busy:5.1f}%  {key[:90]}")
    return busy_ms


def around_kernel_ms(torch, mat, f, backward, n=20):
    """Device ms per ``bcsr_spmm`` call at width ``f`` (forward, or forward
    and backward) spent outside the fused kernel: the node-padding copy,
    the cast to bf16 and, backward, the zero-padded gradient of the output
    slice and its cast.  Returns (outside ms, kernel ms)."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr_spmm

    x = torch.randn(mat.num_nodes, f, device="cuda", requires_grad=backward)
    g = torch.randn(mat.num_nodes, f, device="cuda")

    def call():
        out = bcsr_spmm(mat, x)
        if backward:
            out.backward(g)

    call()
    agg, _ = device_time_by_kernel(torch, call, n)
    kernel = sum(us for name, (us, _) in agg.items()
                 if "hybrid_spmm_kernel" in name)
    total = sum(us for us, _ in agg.values())
    return (total - kernel) / n / 1e3, kernel / n / 1e3


def phase_dense(torch):
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import Graph, bcsr
    from pytorch_geometric_temporal_tpu_torch.ops.spmm import _resolve_backend
    from pytorch_geometric_temporal_tpu_torch.train import (
        BatchTrainer, ZScoreScaler)

    B, T, N, F, K = 64, 12, 207, 2, 3
    rng = np.random.default_rng(0)
    ei = np.unique(rng.integers(0, N, size=(2, 1722)), axis=1)
    w = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(B, T, N, F)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(B, T, N, F)).astype(np.float32))
    x, y = x.cuda(), y.cuda()
    g = Graph.from_edge_index(ei, w, num_nodes=N)
    assert _resolve_backend(g, x, None) == "dense"
    model = DCRNNSeq(F, F, K, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        d = model(x, g)
        with config_override(spmm_backend="segment"):
            s = model(x, g)
    err = float((d - s).abs().max())
    log(f"  dense vs segment forward max abs err {err:.3e} (tol 1e-4, f32)")
    if err > 1e-4:
        raise SystemExit("dense path does not match the segment path")
    scaler = ZScoreScaler(mean=torch.tensor(54.0, device="cuda"),
                          std=torch.tensor(20.0, device="cuda"))
    trainer = BatchTrainer(model, lambda xb: model(xb, g), scaler=scaler)
    bcsr.reset_launch_counts()
    step_s, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(x, y)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    if any(launch_counts(bcsr).values()):
        raise SystemExit("dense path launched a BCSR kernel")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite loss: {losses}")
    log(f"  METR-LA shape: masked-MAE losses "
        f"{['%.4f' % v for v in losses]}, step times (s) "
        f"{['%.4f' % v for v in step_s]}")


def launch_counts(bcsr):
    return {"H": bcsr.hybrid_spmm.launches, "K1": bcsr.tile_spmm.launches,
            "K2": bcsr.rem_scatter_.launches}


def make_net(torch, make_cell, hidden, seed):
    """cell + relu + Linear(hidden -> 1), the reference examples' network;
    returns (prediction (N,), hidden state).  ``make_cell(generator)``
    builds the recurrent cell; weights from ``seed``."""

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.recurrent = make_cell(torch.Generator().manual_seed(seed))
            torch.manual_seed(seed)
            self.linear = torch.nn.Linear(hidden, 1)

        def forward(self, x, graph, h=None):
            h = self.recurrent(x, graph, h)
            return self.linear(torch.relu(h))[..., 0], h

    return Net().to("cuda")


def gconv_gru_net(torch, in_channels, hidden, K, seed):
    from pytorch_geometric_temporal_tpu_torch.models import GConvGRU

    return make_net(torch, lambda gen: GConvGRU(in_channels, hidden, K,
                                                generator=gen), hidden, seed)


def threaded_outputs_and_grads(torch, net, signal, operator):
    """Predictions of every snapshot with the hidden state threaded, and the
    parameter gradients of the mean snapshot MSE, over ``operator``."""
    from pytorch_geometric_temporal_tpu_torch.train import mse

    def step(carry, x, y, graph):
        h, acc = carry
        out, h = net(x, operator, h)
        return (h, acc + mse(out, y)), out

    zero = torch.zeros((), device="cuda")
    (_, total), outs = signal.scan(step, (None, zero))
    grads = torch.autograd.grad(total / signal.snapshot_count,
                                list(net.parameters()))
    return outs.detach(), grads


def phase_chickenpox(torch):
    """The Chickenpox accuracy protocol (hidden state reset every
    snapshot, as the reference example never threads it)."""
    from pytorch_geometric_temporal_tpu_torch.data import (
        ChickenpoxDatasetLoader)
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr
    from pytorch_geometric_temporal_tpu_torch.signal import (
        StackedSignal, temporal_signal_split)
    from pytorch_geometric_temporal_tpu_torch.train import (
        SnapshotTrainer, mae, mse)

    dataset = ChickenpoxDatasetLoader().get_dataset(lags=4)
    train_sig, test_sig = temporal_signal_split(dataset, 0.2)
    train = StackedSignal.from_signal(train_sig)
    test = StackedSignal.from_signal(test_sig)
    if train.features.device.type != "cuda":
        raise SystemExit("the signal is not on the card")
    net = gconv_gru_net(torch, 4, 32, K=1, seed=42)

    def loss_and_state(carry, x, y, g):
        return mse(net(x, g)[0], y), carry

    def mae_and_state(carry, x, y, g):
        return mae(net(x, g)[0], y), carry

    trainer = SnapshotTrainer(net, loss_and_state, lr=1e-2)
    losses = []
    bcsr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(train, CHICKENPOX_EPOCHS,
                callback=lambda epoch, loss: losses.append(loss))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    test_mse = float(trainer.evaluate(test))
    test_mae = float(SnapshotTrainer(net, mae_and_state).evaluate(test))
    log(f"  N={train.num_nodes} E={train.num_edges}, "
        f"{train.snapshot_count} training and {test.snapshot_count} test "
        f"snapshots; {CHICKENPOX_EPOCHS} epochs in {seconds:.2f} s "
        f"({seconds / CHICKENPOX_EPOCHS:.4f} s per epoch, host clock); "
        f"training MSE {losses[0]:.4f} -> {losses[-1]:.4f}; test MSE "
        f"{test_mse:.4f}, test MAE {test_mae:.4f}")
    if any(launch_counts(bcsr).values()):
        raise SystemExit("the Chickenpox path launched a BCSR kernel")
    if not (len(losses) == CHICKENPOX_EPOCHS and all(np.isfinite(losses))
            and np.isfinite([test_mse, test_mae]).all()):
        raise SystemExit(f"non-finite loss: {losses[-3:]}, {test_mse}")
    if not losses[-1] < losses[0]:
        raise SystemExit("the training loss did not fall")


def cheb_launches(T, K, epochs):
    """Fused-kernel launches of ``epochs`` epochs of GConvGRU with the
    hidden state threaded over a BCSR Chebyshev operator.

    Forward: per snapshot three bases (X, H, H·R) of K-1 hops each.
    Backward: one launch on the transposed half per forward hop whose input
    needs a gradient: never X's; at t=0 only H·R's (H is the zero state, R
    depends on the parameters); H's and H·R's after.
    """
    n_fwd = 3 * (K - 1) * T
    n_bwd = (K - 1) * (1 + 2 * (T - 1))
    return (n_fwd + n_bwd) * epochs


def counted_epochs(torch, trainer, signal, c, kernel_report, want, edges):
    """``c["epochs"]`` epochs of ``trainer`` over ``signal`` (hidden state
    threaded from None) with every launch counted against ``want``, then
    ``c["timed_epochs"]`` timed on the host clock and two under the
    profiler.  Returns the device's busy ms per epoch (None if the profiler
    recorded no device time)."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    T = signal.snapshot_count
    trainer.train_epoch(signal, None)   # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    bcsr.reset_launch_counts()
    losses = [float(trainer.train_epoch(signal, None))
              for _ in range(c["epochs"])]
    launches = launch_counts(bcsr)
    log(f"  launches over {c['epochs']} epochs: fused {launches['H']} "
        f"(expected {want}: {want // c['epochs']} an epoch), K1 "
        f"{launches['K1']} and K2 {launches['K2']} (expected 0)")
    if launches != {"H": want, "K1": 0, "K2": 0}:
        raise SystemExit("launch counts differ from the model's count")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"losses not finite or not falling: {losses}")
    log(f"  losses {['%.6f' % v for v in losses]}")
    kernel_report["H"]["launches"] += launches["H"]
    epoch_s = []
    for _ in range(c["timed_epochs"]):
        t0 = time.perf_counter()
        trainer.train_epoch(signal, None)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    med = statistics.median(epoch_s)
    log(f"  epoch time over {len(epoch_s)} epochs (host clock, "
        f"synchronized): median {med * 1e3:.3f} ms, min "
        f"{min(epoch_s) * 1e3:.3f} ms, max {max(epoch_s) * 1e3:.3f} ms; "
        f"{edges * T * 3 / med:.4e} edges/s (E*T*3/epoch, forward "
        f"aggregations); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return profile_steps(torch, lambda: trainer.train_epoch(signal, None),
                         med * 1e3, unit="epoch")


def phase_cheb(torch, kernel_report):
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import cheb_basis
    from pytorch_geometric_temporal_tpu_torch.ops import (
        Graph, Prenormalized, host_cheb_norm, prenormalize_cheb)
    from pytorch_geometric_temporal_tpu_torch.signal import StackedSignal
    from pytorch_geometric_temporal_tpu_torch.train import (
        SnapshotTrainer, mse)

    c, n = CHEB, SLICE["n"]
    T, lags = c["t"], c["lags"]
    rng = np.random.default_rng(SLICE["seed"])
    t0 = time.perf_counter()
    ei, w = slice_graph(rng)
    g = Graph.from_edge_index(ei, w, num_nodes=n)
    op = prenormalize_cheb(g, "sym", bcsr=True, dtype=torch.bfloat16)
    seg = Prenormalized(host_cheb_norm(g))
    signal = StackedSignal.from_arrays(
        rng.normal(size=(T, n, lags)).astype(np.float32),
        rng.normal(size=(T, n)).astype(np.float32), ei, w)
    log(f"  graph N={n} E={ei.shape[1]}: Chebyshev operator "
        f"({seg.op.num_edges} entries) built in "
        f"{time.perf_counter() - t0:.1f} s; "
        + ", ".join(f"{s}: nnzb={getattr(op.op, s).nnzb} "
                    f"rem={getattr(op.op, s).num_rem}"
                    for s in ("fwd", "bwd")))

    # the fused kernel at this path's two widths on this operator
    for f in (lags, c["hidden"]):
        report_fused(torch, kernel_report, op.op.fwd, f, "Chebyshev")

    # cheb_basis at K=3 (the recurrence 2·L̂·T1 − T0), forward only
    xb = signal.features[0]
    b_op = cheb_basis(op, xb, 3)
    with config_override(spmm_backend="segment"):
        b_seg = cheb_basis(seg, xb, 3)
    torch.cuda.synchronize()
    basis_err = float((b_op - b_seg).abs().max() / b_seg.abs().max())
    log(f"  cheb_basis K=3 vs segment path: max abs err {basis_err:.3e} of "
        f"the basis' largest value {float(b_seg.abs().max()):.3f} (tol "
        f"{CHEB_BASIS_TOL})")
    if not basis_err <= CHEB_BASIS_TOL:
        raise SystemExit("cheb_basis over BCSR does not match the segment "
                         "path")

    net = gconv_gru_net(torch, lags, c["hidden"], c["K"], seed=1)

    def loss_and_state(carry, x, y, graph):
        out, h = net(x, op, carry)
        return mse(out, y), h

    # forward and parameter gradients against the f32 segment path
    out_b, grads_b = threaded_outputs_and_grads(torch, net, signal, op)
    with config_override(spmm_backend="segment"):
        out_s, grads_s = threaded_outputs_and_grads(torch, net, signal, seg)
    torch.cuda.synchronize()
    fwd_err = float((out_b - out_s).abs().max())
    grad_rel = max(float((gb - gs).abs().max() / gs.abs().max())
                   for gb, gs in zip(grads_b, grads_s))
    log(f"  vs segment path over T={T} threaded snapshots: forward max abs "
        f"err {fwd_err:.3e} (tol {CHEB_FWD_TOL}), parameter-gradient max "
        f"rel err {grad_rel:.3e} (tol {CHEB_GRAD_TOL})")
    if not (fwd_err <= CHEB_FWD_TOL and grad_rel <= CHEB_GRAD_TOL):
        raise SystemExit("GConvGRU over BCSR does not match the segment "
                         "path")

    trainer = SnapshotTrainer(net, loss_and_state, lr=1e-2)
    busy_ms = counted_epochs(torch, trainer, signal, c, kernel_report,
                             cheb_launches(T, c["K"], c["epochs"]),
                             ei.shape[1])

    # the copies around each aggregation in bcsr_spmm (node padding, cast
    # to bf16, and backward the padded gradient of the output slice),
    # profiled alone and summed over an epoch's launches: X's basis runs
    # forward only, H's and H·R's forward and backward but for H's at t=0
    if busy_ms:
        x_fwd, _ = around_kernel_ms(torch, op.op, lags, backward=False)
        h_fwd, k_fwd = around_kernel_ms(torch, op.op, c["hidden"],
                                        backward=False)
        h_both, k_both = around_kernel_ms(torch, op.op, c["hidden"],
                                          backward=True)
        per_epoch = T * x_fwd + (2 * T - 1) * h_both + h_fwd
        log(f"  device time outside the kernel per bcsr_spmm: F={lags} "
            f"forward {x_fwd:.4f} ms; F={c['hidden']} forward {h_fwd:.4f} ms "
            f"(kernel {k_fwd:.4f}), forward and backward {h_both:.4f} ms "
            f"(kernel {k_both:.4f}); padding and cast copies {per_epoch:.3f} "
            f"ms an epoch, {per_epoch / busy_ms:.3f} of the device's busy "
            f"time")


def operator_bytes(mat):
    return sum(v.numel() * v.element_size()
               for half in (mat.fwd, mat.bwd)
               for v in vars(half).values() if hasattr(v, "element_size"))


def dynamic_graphs(rng):
    """The T graphs of phases 7 and 10 (the first draws of ``rng``): banded,
    weights normalized by the weighted in-degree."""
    from pytorch_geometric_temporal_tpu_torch.ops import Graph

    c = DYNAMIC
    n, e = c["n"], c["n"] * c["deg"]
    graphs = []
    for _ in range(c["t"]):
        s = rng.integers(0, n, size=e)
        r = np.clip(s + rng.integers(-c["band"], c["band"] + 1, size=e),
                    0, n - 1)
        w = rng.uniform(0.1, 1.0, e).astype(np.float32)
        d = np.bincount(r, weights=w, minlength=n).astype(np.float32)
        graphs.append(Graph.from_edge_index(
            np.stack([s, r]), w / np.maximum(d[r], 1e-6), num_nodes=n))
    return graphs


def fused_on_every_half(torch, stacked, f, kernel_report, label):
    """The fused kernel against its plain version on every step's two
    halves at width ``f``, each timed beside its bound; the slowest half
    (they hold equal work) is timed again to tell a slow half from a slow
    moment, and stands for the path in the report."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    reports = []
    for t, mat in enumerate(stacked):
        for side in ("fwd", "bwd"):
            half = getattr(mat, side)
            x = torch.randn(half.num_cols, f, device="cuda").to(
                half.blocks.dtype)
            k = fused_report(torch, half, x)
            log_kernel(f"fused hybrid_spmm t={t} {side} F={f}", k)
            log(f"    fused / torch.sparse.mm "
                f"{k['ms'] / k['library_ms']:.3f}; err "
                f"{k['max_abs_err']:.2e}")
            kernel_report["H"]["max_abs_err"] = max(
                kernel_report["H"]["max_abs_err"], k["max_abs_err"])
            reports.append((k["ms"], len(reports), k, half, x))
    _, _, worst, half, x = max(reports)
    again = cold_ms(torch, lambda: bcsr.hybrid_spmm(half, x))
    log(f"  fused over the {len(reports)} halves: {min(reports)[0]:.4f} to "
        f"{worst['ms']:.4f} ms; the slowest timed again: {again:.4f} ms")
    kernel_report["paths"].append(
        (f"{label} F={f} (slowest of {len(reports)} halves)", worst))


def phase_dynamic(torch, kernel_report):
    from pytorch_geometric_temporal_tpu_torch.ops import (
        BCSRMatrix, bcsr, bcsr_spmm, spmm_segment, stack_bcsr)

    c = DYNAMIC
    n, T, f = c["n"], c["t"], c["f"]
    e = n * c["deg"]
    rng = np.random.default_rng(c["seed"])
    t0 = time.perf_counter()
    graphs = dynamic_graphs(rng)
    stacked = stack_bcsr([
        BCSRMatrix.from_graph(g, dtype=torch.bfloat16,
                              min_block_edges="auto", pack=3)
        for g in graphs])
    sizes = [operator_bytes(m) for m in stacked]
    log(f"  T={T} graphs of N={n}, E={e} each: operators built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{[round(b / 2**20, 1) for b in sizes]} MiB on the card "
        f"({sum(sizes) / 2**20:.1f} MiB in all, unpadded); "
        + ", ".join(f"t={t}: nnzb={m.fwd.nnzb} rem={m.fwd.num_rem}"
                    for t, m in enumerate(stacked)))
    h0 = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).cuda()

    fused_on_every_half(torch, stacked, f, kernel_report, "dynamic")

    def run(h, aggregate, operators):
        outs = []
        for op_t in operators:
            outs.append(aggregate(op_t, h))
            h = torch.tanh(outs[-1])
        return h, outs

    bcsr.reset_launch_counts()
    hb = h0.clone().requires_grad_()
    h_last, outs = run(hb, bcsr_spmm, stacked)
    fwd_launches = launch_counts(bcsr)
    (grad_b,) = torch.autograd.grad((h_last ** 2).sum(), hb)
    torch.cuda.synchronize()
    launches = launch_counts(bcsr)
    log(f"  launches: fused {fwd_launches['H']} forward, "
        f"{launches['H'] - fwd_launches['H']} backward (expected {T} and "
        f"{T}), K1 {launches['K1']} and K2 {launches['K2']} (expected 0)")
    if (fwd_launches["H"], launches) != (T, {"H": 2 * T, "K1": 0, "K2": 0}):
        raise SystemExit("launch counts differ from T forward + T backward")
    kernel_report["H"]["launches"] += launches["H"]

    # every step against spmm_segment on that step's graph and the same
    # input, then the gradient to h0 against the all-segment chain
    h = h0
    for t, g in enumerate(graphs):
        want = spmm_segment(g, h)
        scale = float(want.abs().max())
        err = float((outs[t].detach() - want).abs().max()) / scale
        log(f"  step {t}: max abs err vs spmm_segment {err:.3e} of the "
            f"step's largest value {scale:.4f} (tol {DYN_STEP_TOL})")
        if not err <= DYN_STEP_TOL:
            raise SystemExit(f"dynamic step {t} does not match spmm_segment")
        h = torch.tanh(outs[t].detach())
    hs = h0.clone().requires_grad_()
    h_seg, _ = run(hs, spmm_segment, graphs)
    (grad_s,) = torch.autograd.grad((h_seg ** 2).sum(), hs)
    grad_rel = float((grad_b - grad_s).abs().max() / grad_s.abs().max())
    log(f"  gradient to h0 vs the segment path: max rel err {grad_rel:.3e} "
        f"(tol {DYN_GRAD_TOL})")
    if not grad_rel <= DYN_GRAD_TOL:
        raise SystemExit("dynamic gradient does not match the segment path")

    def sequence_ms(aggregate, operators, reps=20):
        times = []
        with torch.no_grad():
            run(h0, aggregate, operators)
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run(h0, aggregate, operators)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
        return times

    for name, times in (("bcsr", sequence_ms(bcsr_spmm, stacked)),
                        ("segment", sequence_ms(spmm_segment, graphs))):
        rates = sorted(T * e / (ms * 1e-3) for ms in times)
        log(f"  forward sequence ({name}, CUDA events, 20 runs): median "
            f"{statistics.median(times):.4f} ms; edges/s min "
            f"{rates[0]:.4e}, median {statistics.median(rates):.4e}, max "
            f"{rates[-1]:.4e}")


def phase_protocols(torch):
    """The eight bundled-data accuracy protocols at their full epoch
    counts."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr
    from pytorch_geometric_temporal_tpu_torch.ops.spmm import _resolve_backend
    from pytorch_geometric_temporal_tpu_torch.protocols import (
        RUNS, bundled_accuracy)

    for dataset in ("pedalme", "twittertennis", "englandcovid",
                    "montevideobus"):
        train, test = bundled_accuracy._signals(dataset, "cuda")
        backend = _resolve_backend(train.graph(0), train.features[0], None)
        log(f"  {dataset}: N={train.num_nodes}, E<={train.num_edges}, "
            f"{train.snapshot_count} training and {test.snapshot_count} "
            f"test snapshots, a graph per snapshot: {train.graph_dynamic}; "
            f"aggregation backend {backend}")
        if train.features.device.type != "cuda" or backend != "dense":
            raise SystemExit(f"{dataset} is not on the card's dense branch")
    bcsr.reset_launch_counts()
    for name, (epochs, record) in PROTOCOLS.items():
        run = RUNS[name](epochs)
        log(f"  {name}: {epochs} epochs in {run.seconds:.2f} s "
            f"({run.seconds / epochs:.4f} s per epoch, host clock); training "
            f"MSE {run.losses[0]:.4f} -> {run.losses[-1]:.4f}; test MSE "
            f"{run.test_mse:.4f} (JAX package, TPU v5e record {record:.4f}: "
            f"{100 * (run.test_mse - record) / record:+.1f}%)")
        if not (len(run.losses) == epochs and all(np.isfinite(run.losses))
                and np.isfinite(run.test_mse)):
            raise SystemExit(f"{name}: non-finite loss")
        if not run.losses[-1] < run.losses[0]:
            raise SystemExit(f"{name}: the training loss did not fall")
    if any(launch_counts(bcsr).values()):
        raise SystemExit("a bundled protocol launched a BCSR kernel")
    log("  no BCSR kernel launched (expected: small graphs, dense branch)")


def tgcn_launches(T, epochs):
    """Fused-kernel launches of ``epochs`` epochs of TGCN over a BCSR GCN
    operator.

    Forward: per snapshot three GCNConvs (z, r, h), each one aggregation of
    X·W.  Backward: one launch on the transposed half per forward one —
    every aggregated X·W depends on a parameter, at t=0 too.
    """
    return (3 * T + 3 * T) * epochs


def phase_tgcn(torch, kernel_report):
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import TGCN as TGCNCell
    from pytorch_geometric_temporal_tpu_torch.ops import Graph, prepare_graph
    from pytorch_geometric_temporal_tpu_torch.signal import StackedSignal
    from pytorch_geometric_temporal_tpu_torch.train import (
        SnapshotTrainer, mse)

    c, n = TGCN, SLICE["n"]
    T, f = c["t"], c["f"]
    rng = np.random.default_rng(SLICE["seed"])
    t0 = time.perf_counter()
    ei, w = slice_graph(rng)
    g = Graph.from_edge_index(ei, w, num_nodes=n)
    key = ("gcn_norm", False, True)
    prepared = prepare_graph(g, kinds=("gcn",), bcsr=True,
                             dtype=torch.bfloat16)
    g_seg = Graph.from_edge_index(ei, w, num_nodes=n)
    seg = prepare_graph(g_seg, kinds=("gcn",), bcsr=False)
    mat = prepared.ops[key]
    signal = StackedSignal.from_arrays(
        rng.normal(size=(T, n, f)).astype(np.float32),
        rng.normal(size=(T, n)).astype(np.float32), ei, w)
    log(f"  graph N={n} E={ei.shape[1]}: GCN operator "
        f"({seg.ops[key].num_edges} entries, self-loops included) built in "
        f"{time.perf_counter() - t0:.1f} s; "
        + ", ".join(f"{s}: nnzb={getattr(mat, s).nnzb} "
                    f"rem={getattr(mat, s).num_rem}" for s in ("fwd", "bwd")))

    report_fused(torch, kernel_report, mat.fwd, c["hidden"], "GCN")

    net = make_net(torch, lambda gen: TGCNCell(f, c["hidden"],
                                               generator=gen),
                   c["hidden"], seed=2)

    # forward and parameter gradients against the f32 segment path
    out_b, grads_b = threaded_outputs_and_grads(torch, net, signal, prepared)
    with config_override(spmm_backend="segment"):
        out_s, grads_s = threaded_outputs_and_grads(torch, net, signal, seg)
    torch.cuda.synchronize()
    fwd_err = float((out_b - out_s).abs().max())
    grad_rel = max(float((gb - gs).abs().max() / gs.abs().max())
                   for gb, gs in zip(grads_b, grads_s))
    log(f"  vs segment path over T={T} threaded snapshots: forward max abs "
        f"err {fwd_err:.3e} (tol {TGCN_FWD_TOL}), parameter-gradient max "
        f"rel err {grad_rel:.3e} (tol {TGCN_GRAD_TOL})")
    if not (fwd_err <= TGCN_FWD_TOL and grad_rel <= TGCN_GRAD_TOL):
        raise SystemExit("TGCN over BCSR does not match the segment path")

    def loss_and_state(carry, x, y, graph):
        out, h = net(x, prepared, carry)
        return mse(out, y), h

    trainer = SnapshotTrainer(net, loss_and_state, lr=1e-2)
    counted_epochs(torch, trainer, signal, c, kernel_report,
                   tgcn_launches(T, c["epochs"]), ei.shape[1])
    # the three GCNConvs normalize (normalize=True): gcn_norm must have
    # handed them the prepared operator and never normalized the raw graph
    if any(k[0] == "gcn_norm" for k in getattr(g, "_op_cache", {})):
        raise SystemExit("gcn_norm ran on the raw graph inside the loop")
    log("  no normalization ran inside the loop")


def phase_evolve(torch, kernel_report):
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import (
        EvolveGCNHSeq, EvolveGCNOSeq)
    from pytorch_geometric_temporal_tpu_torch.ops import (
        bcsr, stack_bcsr_gcn, stack_graphs)
    from pytorch_geometric_temporal_tpu_torch.train import mse

    c = DYNAMIC
    n, T, f = c["n"], c["t"], EVOLVE["f"]
    rng = np.random.default_rng(c["seed"])
    t0 = time.perf_counter()
    graphs = dynamic_graphs(rng)
    stacked = stack_bcsr_gcn(graphs, dtype=torch.bfloat16)
    dynamic = stack_graphs(graphs)
    log(f"  T={T} graphs of N={n}, E={n * c['deg']} each (+{n} self-loops): "
        f"GCN operators built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(operator_bytes(m) for m in stacked) / 2**20:.1f} MiB on the "
        f"card; "
        + ", ".join(f"t={t}: nnzb={m.fwd.nnzb} rem={m.fwd.num_rem}"
                    for t, m in enumerate(stacked)))
    fused_on_every_half(torch, stacked, f, kernel_report, "stacked GCN")

    xs = torch.from_numpy(rng.normal(size=(T, n, f)).astype(np.float32)
                          ).cuda()
    ys = torch.from_numpy(rng.normal(size=(T, n, f)).astype(np.float32)
                          ).cuda()
    models = {
        "EvolveGCNOSeq": lambda **kw: EvolveGCNOSeq(f, **kw),
        "EvolveGCNHSeq": lambda **kw: EvolveGCNHSeq(n, f, **kw),
    }
    for name, make in models.items():
        over_ops = make(normalize=False,
                        generator=torch.Generator().manual_seed(3))
        in_loop = make(normalize=True)
        in_loop.load_state_dict(over_ops.state_dict())

        def outputs_and_grads(model, graph):
            out = model(xs, graph)
            grads = torch.autograd.grad(mse(out, ys),
                                        list(model.parameters()))
            return out.detach(), grads

        bcsr.reset_launch_counts()
        with torch.no_grad():
            over_ops(xs, stacked)
        fwd_only = launch_counts(bcsr)["H"]
        out_b, grads_b = outputs_and_grads(over_ops, stacked)
        torch.cuda.synchronize()
        launches = launch_counts(bcsr)
        log(f"  {name}: launches fused {fwd_only} forward alone, then "
            f"{launches['H'] - fwd_only} forward and backward (expected {T} "
            f"and {2 * T}: one per step's aggregation of X·W_t, one on the "
            f"transposed half for its gradient), K1 {launches['K1']} and K2 "
            f"{launches['K2']} (expected 0)")
        if (fwd_only, launches) != (T, {"H": 3 * T, "K1": 0, "K2": 0}):
            raise SystemExit(f"{name}: launch counts differ from T forward "
                             "+ T backward")
        kernel_report["H"]["launches"] += launches["H"]
        with config_override(spmm_backend="segment"):
            out_s, grads_s = outputs_and_grads(in_loop, dynamic)
        torch.cuda.synchronize()
        step_err = [float((out_b[t] - out_s[t]).abs().max()
                          / out_s[t].abs().max()) for t in range(T)]
        names = [k for k, _ in over_ops.named_parameters()]
        grad_rel = {k: float((gb - gs).abs().max() / gs.abs().max())
                    for k, gb, gs in zip(names, grads_b, grads_s)}
        worst = max(grad_rel, key=grad_rel.get)
        log(f"    vs normalize=True over stack_graphs on the f32 segment "
            f"path: per-step max abs err "
            f"{['%.3e' % v for v in step_err]} of each step's largest value "
            f"(tol {EVO_STEP_TOL}); parameter gradients max rel err "
            f"{grad_rel[worst]:.3e} at {worst}, initial_weight "
            f"{grad_rel['cell.initial_weight']:.3e} (tol {EVO_GRAD_TOL})")
        if not (max(step_err) <= EVO_STEP_TOL
                and grad_rel[worst] <= EVO_GRAD_TOL):
            raise SystemExit(f"{name} over stack_bcsr_gcn does not match "
                             "the segment path")
        try:
            in_loop(xs, stacked)
        except ValueError as exc:
            log(f"    normalize=True over the stacked operator raises: "
                f"{str(exc)[:60]}...")
        else:
            raise SystemExit(f"{name}(normalize=True) accepted a stacked "
                             "BCSR operator")

        def sequence_ms(model, graph, reps=10):
            times = []
            with torch.no_grad():
                model(xs, graph)
                for _ in range(reps):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    model(xs, graph)
                    b.record()
                    b.synchronize()
                    times.append(a.elapsed_time(b))
            return statistics.median(times)

        ms_b = sequence_ms(over_ops, stacked)
        with config_override(spmm_backend="segment"):
            ms_s = sequence_ms(in_loop, dynamic)
        log(f"    forward sequence (CUDA events, median of 10): over the "
            f"stacked operators {ms_b:.4f} ms; normalizing in the loop on "
            f"the segment path {ms_s:.4f} ms")


@contextlib.contextmanager
def counted_builds():
    """Counts ``BCSRMatrix.from_graph`` calls (host-side operator builds)
    inside the block: ``builds.calls``."""
    from pytorch_geometric_temporal_tpu_torch.ops.bcsr import BCSRMatrix

    inner = BCSRMatrix.from_graph

    class Builds:
        calls = 0

    def counted(*a, **kw):
        Builds.calls += 1
        return inner(*a, **kw)

    BCSRMatrix.from_graph = staticmethod(counted)
    try:
        yield Builds
    finally:
        BCSRMatrix.from_graph = staticmethod(inner)


def phase_metrla(torch, smi):
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr
    from pytorch_geometric_temporal_tpu_torch.protocols import metrla_protocol

    bcsr.reset_launch_counts()
    for label, c in (("full size", METRLA),
                     ("the records' configuration", METRLA_RECORD_CONFIG)):
        rec = metrla_protocol.run(**c)
        curve, mae = rec["train_curve"], rec["test_masked_mae_denorm"]
        log(f"  {label} ({rec['source']}): N={c['n']}, {c['t_len']} steps, "
            f"{c['epochs']} epochs of batches of {c['batch_size']} in "
            f"{rec['seconds']:.2f} s ({rec['seconds'] / c['epochs']:.4f} s "
            f"per epoch, host clock, test pass included) on {smi}")
        log(f"    training curve (last batch of each epoch, masked MAE, mph) "
            f"{curve}; de-normalized masked test MAE {mae:.4f}")
        if not (len(curve) == c["epochs"] and all(np.isfinite(curve))
                and np.isfinite(mae)):
            raise SystemExit(f"METR-LA: non-finite loss {curve}, {mae}")
        if c is METRLA and not curve[-1] < curve[0]:
            raise SystemExit("METR-LA: the training curve did not fall")
    log(f"    beside the JAX package's records at that configuration: "
        f"{METRLA_RECORD_TPU} on a TPU v5e, {METRLA_RECORD_TORCH_CPU} for "
        f"its torch-CPU twin, both from another initial draw "
        f"({100 * (mae - METRLA_RECORD_TPU) / METRLA_RECORD_TPU:+.2f}%)")
    if any(launch_counts(bcsr).values()):
        raise SystemExit("the METR-LA protocol launched a BCSR kernel")


def adam_steps(torch, model, forward, x, y, steps):
    """``steps`` updates of ``model`` through ``BatchTrainer`` (MSE, Adam
    1e-3); returns (losses, trainer)."""
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer, mse

    trainer = BatchTrainer(model, forward, lr=1e-3, loss_fn=mse)
    losses = [float(trainer.train_step(x, y)) for _ in range(steps)]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"{type(model).__name__}: losses not finite or not "
                         f"falling: {losses}")
    return losses, trainer


def phase_attention(torch, smi):
    from pytorch_geometric_temporal_tpu_torch.models import (
        AAGCN, ASTGCN, DNNTSP, GMAN, MSTGCN, MTGNN, STConv)
    from pytorch_geometric_temporal_tpu_torch.ops import Graph, bcsr
    from pytorch_geometric_temporal_tpu_torch.ops.spmm import _resolve_backend

    c = ATT
    b, n, f, t = c["b"], c["n"], c["f"], c["t"]
    rng = np.random.default_rng(0)

    def cuda(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).cuda()

    ei = np.unique(rng.integers(0, n, size=(2, 1800)), axis=1)
    g = Graph.from_edge_index(ei, num_nodes=n)
    x, y = cuda(b, n, f, t), cuda(b, n, t)
    if _resolve_backend(g, x, None) != "dense":
        raise SystemExit("the reference graph is not on the dense branch")
    bcsr.reset_launch_counts()
    gen = torch.Generator().manual_seed(0)
    shared = dict(nb_block=c["blocks"], in_channels=f, K=c["k"],
                  nb_chev_filter=c["filters"], nb_time_filter=c["filters"],
                  time_strides=1, num_for_predict=t, len_input=t)
    busy = {}
    for name, model in (
            ("ASTGCN", ASTGCN(**shared, num_of_vertices=n, generator=gen)),
            ("MSTGCN", MSTGCN(**shared, generator=gen))):
        losses, trainer = adam_steps(torch, model, lambda xb: model(xb, g),
                                     x, y, c["steps"])
        step_s = []
        for _ in range(10):
            t0 = time.perf_counter()
            trainer.train_step(x, y)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        med = statistics.median(step_s)
        n_par = sum(p.numel() for p in model.parameters())
        log(f"  {name} (B={b}, N={n}, F_in={f}, T={t}, K={c['k']}, "
            f"{c['blocks']} blocks, {c['filters']} filters, {n_par} "
            f"parameters): MSE {['%.5f' % v for v in losses]}; step median "
            f"{med * 1e3:.3f} ms (host clock, 10 steps) on {smi}")
        busy[name] = profile_steps(torch, lambda: trainer.train_step(x, y),
                                   med * 1e3, top=8)
    if busy["ASTGCN"] and busy["MSTGCN"]:
        share = (busy["ASTGCN"] - busy["MSTGCN"]) / busy["ASTGCN"]
        log(f"  attention's share of the ASTGCN step by device busy time: "
            f"({busy['ASTGCN']:.3f} - {busy['MSTGCN']:.3f}) / "
            f"{busy['ASTGCN']:.3f} = {share:.3f} on {smi}")

    def moved(model, before):
        return any(not torch.equal(v, before[k])
                   for k, v in model.named_buffers())

    def three_steps(name, model, forward, xs, ys, has_stats=True):
        before = {k: v.clone() for k, v in model.named_buffers()}
        t0 = time.perf_counter()
        losses, _ = adam_steps(torch, model, forward, xs, ys, 3)
        torch.cuda.synchronize()
        log(f"  {name}: MSE {['%.5f' % v for v in losses]} in train mode, "
            f"{sum(p.numel() for p in model.parameters())} parameters, "
            f"{time.perf_counter() - t0:.2f} s for three steps, the first "
            f"included")
        if has_stats and not moved(model, before):
            raise SystemExit(f"{name}: the batch statistics did not move")

    # STConv, STGCN's widths
    m = STConv(n, 1, 16, 64, 3, 3, generator=gen)
    three_steps("STConv(1->16->64, K=3)", m,
                lambda xb: m(xb, g, train=True), cuda(b, t, n, 1),
                cuda(b, t - 4, n, 64))
    # GMAN: L=1, K=8 heads of d=8, 12 -> 12 steps
    m = GMAN(1, 8, 8, t, 0.1, 288, generator=gen)
    se = cuda(n, 64)
    te = torch.from_numpy(np.stack(
        [rng.integers(0, 7, (8, 2 * t)), rng.integers(0, 288, (8, 2 * t))],
        -1)).cuda()
    three_steps("GMAN(L=1, K=8, d=8)", m, lambda xb: m(xb, se, te, True),
                cuda(8, t, n), cuda(8, t, n))
    # MTGNN: 3 layers, conv/residual 32, skip 64, end 128, subgraph 20
    m = MTGNN(True, True, 2, n, [2, 3, 6, 7], 7, 0.3, 20, 40, 1, 32, 32, 64,
              128, t, 2, 12, 3, 0.05, 3.0, True, generator=gen)

    def mtgnn_forward(xb):
        # the same dropout mask every step, drawn on the card
        mask_gen = torch.Generator(device="cuda").manual_seed(7)
        return m(xb, train=True, generator=mask_gen)

    three_steps("MTGNN(3 layers, 32/32/64/128)", m, mtgnn_forward,
                cuda(b, 2, n, t), cuda(b, 12, n, 1), has_stats=False)
    # AAGCN: 3 -> 64 channels, 25 joints, 64 frames
    joints = np.unique(rng.integers(0, 25, size=(2, 48)), axis=1)
    m = AAGCN(3, 64, joints, 25, generator=gen)
    three_steps("AAGCN(3->64, V=25, T=64)", m, lambda xb: m(xb, True),
                cuda(8, 3, 64, 25), cuda(8, 64, 64, 25))
    # DNNTSP: 100 items, embedding 32, 4 heads, 4 steps
    items, steps_t = 100, 4
    ei2 = np.unique(rng.integers(0, items * steps_t, size=(2, 1200)), axis=1)
    g2 = Graph.from_edge_index(
        ei2, rng.uniform(0.5, 2.0, ei2.shape[1]).astype(np.float32),
        num_nodes=items * steps_t)
    m = DNNTSP(items, 32, 4, generator=gen)
    three_steps("DNNTSP(100 items, 32, 4 heads)", m,
                lambda xb: m(xb, g2, True), cuda(items * steps_t, 32),
                cuda(steps_t, items, 32))
    if any(launch_counts(bcsr).values()):
        raise SystemExit("a dense-branch model launched a BCSR kernel")
    log("  no BCSR kernel launched (expected: dense branch)")


def outputs_and_param_grads(torch, model, forward, y):
    from pytorch_geometric_temporal_tpu_torch.train import mse

    out = forward()
    grads = torch.autograd.grad(mse(out, y), list(model.parameters()))
    return out.detach(), grads


def compare_with_segment(torch, name, model, got, want, fwd_tol, grad_tol,
                         grad_l2_tol):
    """Outputs by their largest absolute difference; every parameter's
    gradient by the largest difference over the gradient's largest entry
    (the other phases' measure) and by the 2-norm of the difference over
    the gradient's 2-norm: a per-node parameter's gradient is a sum of a
    few hundred terms of either sign, so single entries carry rounding
    that the norm averages out."""
    (out_b, grads_b), (out_s, grads_s) = got, want
    torch.cuda.synchronize()
    scale = float(out_s.abs().max())
    fwd_err = float((out_b - out_s).abs().max())
    names = [k for k, _ in model.named_parameters()]
    rel, l2 = {}, {}
    for k, gb, gs in zip(names, grads_b, grads_s):
        rel[k] = float((gb - gs).abs().max() / gs.abs().max())
        l2[k] = float(torch.linalg.norm(gb - gs) / torch.linalg.norm(gs))
    w_rel, w_l2 = max(rel, key=rel.get), max(l2, key=l2.get)
    log(f"  vs the f32 segment path: forward max abs err {fwd_err:.3e} "
        f"(outputs up to {scale:.3f}; tol {fwd_tol}); parameter gradients: "
        f"max abs err over the gradient's largest entry {rel[w_rel]:.3e} at "
        f"{w_rel} (tol {grad_tol}), 2-norm of the error over the "
        f"gradient's {l2[w_l2]:.3e} at {w_l2} (tol {grad_l2_tol})")
    if not (fwd_err <= fwd_tol and rel[w_rel] <= grad_tol
            and l2[w_l2] <= grad_l2_tol):
        raise SystemExit(f"{name} over BCSR does not match the segment path")


def phase_stconv(torch, kernel_report, smi):
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import STConv
    from pytorch_geometric_temporal_tpu_torch.models._cells import Dense
    from pytorch_geometric_temporal_tpu_torch.ops import (
        Graph, bcsr, prepare_graph)
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer, mse

    c, n = STGCN, SLICE["n"]
    K, T = c["K"], c["t"]
    rng = np.random.default_rng(SLICE["seed"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ei, w = slice_graph(rng)
    g = Graph.from_edge_index(ei, w, num_nodes=n)
    key = ("cheb_norm", "sym", 2.0)
    prepared = prepare_graph(g, kinds=("cheb",), bcsr=True,
                             dtype=torch.bfloat16)
    seg = prepare_graph(Graph.from_edge_index(ei, w, num_nodes=n),
                        kinds=("cheb",), bcsr=False)
    mat = prepared.ops[key]
    log(f"  graph N={n} E={ei.shape[1]}: Chebyshev operator built in "
        f"{time.perf_counter() - t0:.1f} s; "
        + ", ".join(f"{s}: nnzb={getattr(mat, s).nnzb} "
                    f"rem={getattr(mat, s).num_rem}" for s in ("fwd", "bwd")))
    t_out = T - 4 * (c["kernel"] - 1)
    # a block's hops see its first temporal conv's output: T' steps wide
    widths = [(T - (2 * i + 1) * (c["kernel"] - 1)) * c["spatial"]
              for i in range(2)]
    report_fused(torch, kernel_report, mat.fwd, widths[0], "STConv Chebyshev")

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(4)
            self.block1 = STConv(n, c["f_in"], c["spatial"], c["out"],
                                 c["kernel"], K, generator=gen)
            self.block2 = STConv(n, c["out"], c["spatial"], c["out"],
                                 c["kernel"], K, generator=gen)
            self.head = Dense(c["out"], 1, generator=gen)

        def forward(self, x, graph):
            h = self.block1(x, graph, train=True)
            h = self.block2(h, graph, train=True)
            return self.head(h)[..., 0]

    net = Net()
    x = torch.from_numpy(rng.normal(size=(1, T, n, c["f_in"])).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.normal(size=(1, t_out, n)).astype(
        np.float32)).cuda()
    log(f"  two STConv blocks ({c['f_in']}->{c['spatial']}->{c['out']}, "
        f"{c['out']}->{c['spatial']}->{c['out']}, K={K}) + Dense head, "
        f"{sum(p.numel() for p in net.parameters())} parameters; "
        f"aggregations at F={widths[0]} and F={widths[1]}")

    got = outputs_and_param_grads(torch, net, lambda: net(x, prepared), y)
    with config_override(spmm_backend="segment"):
        want = outputs_and_param_grads(torch, net, lambda: net(x, seg), y)
    compare_with_segment(torch, "STConv", net, got, want, *STCONV_TOLS)

    trainer = BatchTrainer(net, lambda xb: net(xb, prepared), lr=1e-3,
                           loss_fn=mse)
    trainer.train_step(x, y)            # warm-up
    torch.cuda.synchronize()
    with counted_builds() as builds:
        bcsr.reset_launch_counts()
        with torch.no_grad():
            net(x, prepared)
        fwd_only = launch_counts(bcsr)["H"]
        bcsr.reset_launch_counts()
        losses = [float(trainer.train_step(x, y)) for _ in range(c["steps"])]
        launches = launch_counts(bcsr)
    per_block = K - 1
    want_step = 2 * per_block + 2 * per_block
    log(f"  launches: fused {fwd_only} in one forward (expected "
        f"{2 * per_block}: K-1 a block), {launches['H']} over {c['steps']} "
        f"steps (expected {want_step * c['steps']}: {2 * per_block} forward "
        f"+ {2 * per_block} backward a step), K1 {launches['K1']} and K2 "
        f"{launches['K2']} (expected 0); operator builds inside the steps "
        f"{builds.calls} (expected 0)")
    if (fwd_only, launches, builds.calls) != (
            2 * per_block,
            {"H": want_step * c["steps"], "K1": 0, "K2": 0}, 0):
        raise SystemExit("STConv: launch or build counts differ")
    if any(k[0] == "cheb_norm" for k in getattr(g, "_op_cache", {})):
        raise SystemExit("cheb_norm ran on the raw graph inside the loop")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"STConv: losses not finite or not falling: "
                         f"{losses}")
    log(f"  losses {['%.6f' % v for v in losses]}; no normalization ran "
        f"inside the loop")
    kernel_report["H"]["launches"] += launches["H"]
    step_s = []
    for _ in range(c["timed_steps"]):
        t0 = time.perf_counter()
        trainer.train_step(x, y)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s)
    log(f"  step time over {len(step_s)} steps (host clock, synchronized): "
        f"median {med * 1e3:.3f} ms, min {min(step_s) * 1e3:.3f} ms, max "
        f"{max(step_s) * 1e3:.3f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    profile_steps(torch, lambda: trainer.train_step(x, y), med * 1e3)


def phase_astgcn_edge(torch, kernel_report, smi):
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import ASTGCN
    from pytorch_geometric_temporal_tpu_torch.models.attention import astgcn
    from pytorch_geometric_temporal_tpu_torch.ops import Graph, bcsr
    from pytorch_geometric_temporal_tpu_torch.ops.bcsr import BCSRMatrix
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer, mse

    c, n = EDGE, SLICE["n"]
    K, T, f_in = c["K"], c["t"], c["f_in"]
    rng = np.random.default_rng(SLICE["seed"])
    ei, w = slice_graph(rng)
    g = Graph.from_edge_index(ei, w, num_nodes=n)
    x = torch.from_numpy(rng.normal(size=(1, n, f_in, T)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.normal(size=(1, n, T)).astype(
        np.float32)).cuda()
    cfg = dict(nb_block=c["blocks"], in_channels=f_in, K=K,
               nb_chev_filter=c["filters"], nb_time_filter=c["filters"],
               time_strides=1, num_for_predict=T, len_input=T,
               num_of_vertices=n, attention_mode="edge")
    model = ASTGCN(**cfg, normalization="sym",
                   generator=torch.Generator().manual_seed(5))
    e_lhat = ei.shape[1] + 2 * n
    log(f"  ASTGCN(edge, sym, K={K}, {c['blocks']} blocks, {c['filters']} "
        f"filters), {sum(p.numel() for p in model.parameters())} "
        f"parameters, N={n}, L-hat of {e_lhat} entries; hop 1's per-edge "
        f"messages in block 2: T*E*F*4 B = "
        f"{T * e_lhat * c['filters'] * 4 / 2**30:.2f} GiB, formed "
        f"{max(1, astgcn._HOP1_CHUNK // (e_lhat * c['filters']))} steps at a "
        f"time")

    # the per-edge attention is column-normalized on the card
    with torch.no_grad():
        scores = model.block_0.spatial_attention(x, g)
        col = scores.diag.clone().index_add_(
            1, g.receivers, scores.edge * g.edge_mask())
    col_err = float((col - 1.0).abs().max())
    log(f"  EdgeScores column sums (edges into j + the diagonal): max "
        f"|sum - 1| {col_err:.2e} (tol 1e-5)")
    if not col_err <= 1e-5:
        raise SystemExit("the edge attention is not column-normalized")

    trainer = BatchTrainer(model, lambda xb: model(xb, g), lr=1e-3,
                           loss_fn=mse)
    per_step = 2 * c["blocks"] * (K - 2)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, counts = [], [], []
    with counted_builds() as builds:
        bcsr.reset_launch_counts()
        with torch.no_grad():
            model(x, g)
        counts.append((builds.calls, launch_counts(bcsr)["H"]))
        for _ in range(c["steps"]):
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(x, y)))
            step_s.append(time.perf_counter() - t0)
            counts.append((builds.calls, launch_counts(bcsr)["H"]))
        launches = launch_counts(bcsr)
    fwd = c["blocks"] * (K - 2)
    want = [(1, fwd)] + [(1, fwd + per_step * (i + 1))
                         for i in range(c["steps"])]
    log(f"  (operator builds, fused launches) after the first forward and "
        f"after each step: {counts} (expected {want}: one build in all, "
        f"{fwd} launches a forward, {per_step} a step), K1 "
        f"{launches['K1']} and K2 {launches['K2']} (expected 0)")
    if counts != want or launches["K1"] or launches["K2"]:
        raise SystemExit("edge-mode ASTGCN: build or launch counts differ")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"edge-mode ASTGCN: losses not finite or not "
                         f"falling: {losses}")
    kernel_report["H"]["launches"] += launches["H"]
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses {['%.6f' % v for v in losses]}; step times (host clock, "
        f"s) {['%.4f' % v for v in step_s]}; peak memory "
        f"{peak / 2**30:.2f} GiB (one (N, N) f32 matrix would be "
        f"{n * n * 4 / 2**30:.2f} GiB) on {smi}")
    # dense mode holds at least L-hat and three (B, N, N) attention tensors
    if peak >= 4 * n * n * 4:
        raise SystemExit("edge-mode ASTGCN allocated as much as dense mode's "
                         "(N, N) tensors")

    # the operator spmm built: f32 tiles, cached on the reversed L-hat
    rev = astgcn._reversed(astgcn._lhat_graph(g, "sym"))
    mats = [v for v in rev._op_cache.values() if isinstance(v, BCSRMatrix)]
    if len(mats) != 1 or mats[0].fwd.blocks.dtype != torch.float32:
        raise SystemExit("expected one f32 operator on the reversed L-hat")
    mat = mats[0]
    log("  reversed L-hat as BCSR (f32 tiles): "
        + ", ".join(f"{s}: nnzb={getattr(mat, s).nnzb} "
                    f"rem={getattr(mat, s).num_rem}" for s in ("fwd", "bwd")))
    for f in (T * f_in, T * c["filters"]):
        report_fused(torch, kernel_report, mat.fwd, f, "edge ASTGCN f32")
    sweep_f32_tile(torch, kernel_report, mat.fwd, T * c["filters"],
                   "edge ASTGCN's reversed L-hat (N=50k)")

    got = outputs_and_param_grads(torch, model, lambda: model(x, g), y)
    with config_override(spmm_backend="segment"):
        want_sg = outputs_and_param_grads(torch, model, lambda: model(x, g),
                                          y)
    compare_with_segment(torch, "edge-mode ASTGCN", model, got, want_sg,
                         *EDGE_TOLS)
    profile_steps(torch, lambda: trainer.train_step(x, y),
                  statistics.median(step_s[1:]) * 1e3, n=1)

    # λ_max from power iteration: a transient L-hat, the segment path
    del got, want_sg
    plain = ASTGCN(**cfg, normalization=None,
                   generator=torch.Generator().manual_seed(6))
    with counted_builds() as builds, torch.no_grad():
        bcsr.reset_launch_counts()
        t0 = time.perf_counter()
        out = plain(x, g)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    log(f"  normalization=None (λ_max by 64 power iterations on the card): "
        f"one forward in {seconds:.3f} s, {builds.calls} operator builds and "
        f"{launch_counts(bcsr)['H']} fused launches (expected 0 and 0)")
    if builds.calls or any(launch_counts(bcsr).values()):
        raise SystemExit("a transient L-hat built an operator or launched "
                         "a kernel")
    if not torch.isfinite(out).all():
        raise SystemExit("normalization=None: non-finite output")



def pems_series(c):
    """The stand-in series of ``streaming_out_of_core.py:write_series``
    (the same draws, made in memory): (T, N, 2) f32, speed in mph and the
    time of day."""
    n, spd = c["n"], c["steps_per_day"]
    t = c["days"] * spd
    rng = np.random.default_rng(c["seed"])
    out = np.empty((t, n, c["f"]), np.float32)
    base = rng.uniform(40.0, 70.0, size=n).astype(np.float32)
    for lo in range(0, t, spd):
        hi = min(lo + spd, t)
        tod = (np.arange(lo, hi) % spd) / spd
        noise = rng.normal(scale=3.0, size=(hi - lo, n)).astype(np.float32)
        out[lo:hi, :, 0] = np.clip(base[None, :] - 15.0 * np.sin(
            2 * np.pi * tod)[:, None].astype(np.float32) + noise, 0.0, 80.0)
        out[lo:hi, :, 1] = tod[:, None].astype(np.float32)
    return out


def pems_graph(c):
    """That script's banded sensor graph: ``deg`` edges a sensor to others
    within ±``offset``, weights U(0.3, 1)."""
    rng = np.random.default_rng(c["graph_seed"])
    s = np.repeat(np.arange(c["n"]), c["deg"])
    r = np.clip(s + rng.integers(-c["offset"], c["offset"] + 1,
                                 size=s.shape[0]), 0, c["n"] - 1)
    w = rng.uniform(0.3, 1.0, s.shape[0]).astype(np.float32)
    return np.stack([s, r]), w


def rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def phase_index_pems(torch, kernel_report, smi):
    import tempfile

    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.data._common import (
        make_index_loaders)
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import Graph, bcsr
    from pytorch_geometric_temporal_tpu_torch.ops.bcsr import BCSRMatrix
    from pytorch_geometric_temporal_tpu_torch.ops.graph import diffusion_norms
    from pytorch_geometric_temporal_tpu_torch.signal import (
        IndexDataset, IndexLoader, StreamingWindower, iter_index_batches)
    from pytorch_geometric_temporal_tpu_torch.train import (
        BatchTrainer, ZScoreScaler)

    c = PEMS
    h, bs, K = c["lags"], c["batch_size"], c["K"]
    torch.cuda.reset_peak_memory_stats()
    with counted_builds() as builds, \
            tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        raw = pems_series(c)
        means = np.mean(raw, axis=(0, 1))
        stds = np.std(raw, axis=(0, 1))
        data = (raw - means) / stds             # as data/pems.py z-scores
        del raw
        path = os.path.join(tmp, "pems.npy")
        np.save(path, data)
        ei, w = pems_graph(c)
        g = Graph.from_edge_index(ei, w, num_nodes=c["n"])
        train, val, test = make_index_loaders(data, h, bs, shuffle=True)
        windower = train.windower
        log(f"  series {data.shape} f32 ({os.path.getsize(path) / 1e6:.1f} "
            f"MB on disk), means {means}, stds {stds}; graph N={c['n']} "
            f"E={ei.shape[1]} (raw Graph: spmm tiles it); windows "
            f"{len(train.indices)} / {len(val.indices)} / "
            f"{len(test.indices)} in {len(train)} / {len(val)} / "
            f"{len(test)} batches of {bs}; set-up "
            f"{time.perf_counter() - t0:.1f} s")
        if (len(train), len(val), len(test)) != c["batches"]:
            raise SystemExit(f"PeMS index split differs from {c['batches']}")
        series_b = windower.data.numel() * windower.data.element_size()
        n_win = sum(len(lo.indices) for lo in (train, val, test))
        windows_b = n_win * 2 * h * c["n"] * c["f"] * 4
        log(f"  the series on the card {series_b / 1e9:.3f} GB; its "
            f"{n_win} windows materialized would take {windows_b / 1e9:.2f} "
            f"GB ({windows_b / series_b:.1f}x)")

        # (a) the first train batch on the card against the host windows
        first = next(iter_index_batches(train.indices, bs, shuffle=True,
                                        rng=np.random.default_rng(0),
                                        drop_last=False))
        twin = IndexLoader(train.indices, windower, bs, shuffle=True)
        x0, y0 = next(iter(twin))
        host = IndexDataset(train.indices, data, h)
        pos = np.searchsorted(train.indices, first)
        hx = np.stack([host[p][0] for p in pos])
        hy = np.stack([host[p][1] for p in pos])
        if not (np.array_equal(x0.cpu().numpy(), hx)
                and np.array_equal(y0.cpu().numpy(), hy)):
            raise SystemExit("(a) the card's windows differ from the host's")
        log(f"  (a) first train batch {tuple(x0.shape)}: equal to "
            f"IndexDataset's host windows, bit for bit")

        model = DCRNNSeq(c["f"], c["f"], K,
                         generator=torch.Generator().manual_seed(0))
        scaler = ZScoreScaler(mean=torch.tensor(means, device="cuda"),
                              std=torch.tensor(stds, device="cuda"))
        trainer = BatchTrainer(model, lambda xb: model(xb, g), lr=1e-3,
                               scaler=scaler)

        # (b) the first batch against the f32 segment path
        got = outputs_and_param_grads(torch, model, lambda: model(x0, g), y0)
        with config_override(spmm_backend="segment"):
            want = outputs_and_param_grads(torch, model,
                                           lambda: model(x0, g), y0)
        compare_with_segment(torch, "index-batched DCRNN", model, got, want,
                             *PEMS_TOLS)
        del got, want
        mats = [v for p in diffusion_norms(g)
                for v in p._op_cache.values() if isinstance(v, BCSRMatrix)]
        if len(mats) != 2 or any(m.fwd.blocks.dtype != torch.float32
                                 for m in mats):
            raise SystemExit("expected one f32 operator a direction")
        log("  operators spmm built (f32 tiles, the activations' type): "
            + "; ".join(f"{name}: fwd nnzb={m.fwd.nnzb} rem="
                        f"{m.fwd.num_rem}, bwd nnzb={m.bwd.nnzb} rem="
                        f"{m.bwd.num_rem}, spmm_reorder='auto' "
                        f"{'reordered' if m.perm is not None else 'kept the order'}"
                        for name, m in zip(("P_fwd", "P_bwd"), mats)))

        # (d) launches of one train and one eval batch, then of the epochs
        per_train = expected_launches(h, K, 1)
        per_eval = 2 * h * 2 * (K - 1)
        bcsr.reset_launch_counts()
        trainer.train_step(x0, y0)
        one_train = launch_counts(bcsr)
        bcsr.reset_launch_counts()
        trainer.eval_step(x0, y0)
        one_eval = launch_counts(bcsr)
        log(f"  (d) one train batch: fused {one_train['H']} (expected "
            f"{per_train}); one eval batch: {one_eval['H']} (expected "
            f"{per_eval}); K1 and K2 {one_train['K1'] + one_eval['K1']} and "
            f"{one_train['K2'] + one_eval['K2']} (expected 0)")
        if (one_train, one_eval) != ({"H": per_train, "K1": 0, "K2": 0},
                                     {"H": per_eval, "K1": 0, "K2": 0}):
            raise SystemExit("launch counts of one batch differ")

        per_epoch = len(train) * per_train + len(val) * per_eval
        curve, marks, epoch_s = [], [], []
        torch.cuda.synchronize()
        bcsr.reset_launch_counts()
        t_fit = time.perf_counter()

        def on_epoch(epoch, loss, val_loss):
            curve.append((loss, val_loss))
            marks.append(launch_counts(bcsr)["H"])
            epoch_s.append(time.perf_counter() - t_fit)

        trainer.fit(train, c["epochs"], val_loader=val, callback=on_epoch)
        tl, tn = torch.zeros((), device="cuda"), 0
        for xb, yb in test:
            tl, tn = tl + trainer.eval_step(xb, yb), tn + 1
        test_mae = float(tl) / tn
        launches = launch_counts(bcsr)
        want_marks = [per_epoch * (e + 1) for e in range(c["epochs"])]
        log(f"  (d) fused launches after each epoch {marks} (expected "
            f"{want_marks}: {len(train)} x {per_train} + {len(val)} x "
            f"{per_eval} an epoch); after the test pass {launches['H']} "
            f"(expected {want_marks[-1] + len(test) * per_eval}); K1 "
            f"{launches['K1']} and K2 {launches['K2']} (expected 0)")
        if (marks != want_marks or launches != {
                "H": want_marks[-1] + len(test) * per_eval, "K1": 0,
                "K2": 0}):
            raise SystemExit("PeMS index path: launch counts differ")
        kernel_report["H"]["launches"] += launches["H"]
        losses = [v for pair in curve for v in pair] + [test_mae]
        log(f"  (e) epochs (train, val) masked MAE on de-normalized values "
            f"{[('%.4f' % a, '%.4f' % b) for a, b in curve]}; test "
            f"{test_mae:.4f}; epochs end at {['%.2f' % v for v in epoch_s]} s "
            f"(host clock)")
        if not all(np.isfinite(losses)) or not curve[-1][0] < curve[0][0]:
            raise SystemExit("PeMS index path: losses not finite or the "
                             "epoch loss did not fall")

        # step times over one more epoch, then the device's busy time
        step_s = []
        for xb, yb in train:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(xb, yb)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        med = statistics.median(step_s)
        log(f"  step time over {len(step_s)} train batches (host clock, "
            f"synchronized, the last one short): median {med * 1e3:.3f} ms, "
            f"min {min(step_s) * 1e3:.3f} ms, max {max(step_s) * 1e3:.3f} ms; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB on {smi}")
        profile_steps(torch, lambda: trainer.train_step(x0, y0), med * 1e3)

        # (f) the streaming windower over the written file, same starts
        stream = StreamingWindower(path, h)
        starts = list(iter_index_batches(train.indices, bs, shuffle=True,
                                         rng=np.random.default_rng(0),
                                         drop_last=False))
        held = [stream(b) for b in starts]      # no synchronize in between
        same = all(torch.equal(sx, dx) and torch.equal(sy, dy)
                   for (sx, sy), (dx, dy) in zip(held, (windower(b)
                                                        for b in starts)))
        if not same:
            raise SystemExit("(f) streamed batches differ from the card's")
        log(f"  (f) {len(held)} streamed train batches, taken with no "
            f"synchronize in between: equal to the DeviceWindower's, bit "
            f"for bit")
        del held
        host_ms, copy_ms = [], []
        for b in starts:
            t0 = time.perf_counter()
            buf = stream.host_batch(b)
            t1 = time.perf_counter()
            torch.from_numpy(buf).to("cuda")
            torch.cuda.synchronize()
            host_ms.append((t1 - t0) * 1e3)
            copy_ms.append((time.perf_counter() - t1) * 1e3)

        def timed_epoch(loader):
            rss0, peak = rss_bytes(), 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for xb, yb in loader:
                trainer.train_step(xb, yb)
                peak = max(peak, rss_bytes() - rss0)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, peak

        dev_s, dev_rss = timed_epoch(IndexLoader(train.indices, windower,
                                                 bs, shuffle=True))
        str_s, str_rss = timed_epoch(IndexLoader(train.indices, stream, bs,
                                                 shuffle=True))
        full_b = bs * 2 * h * c["n"] * c["f"] * data.itemsize
        log(f"  streaming: host_batch median {statistics.median(host_ms):.2f}"
            f" ms, the copy to the card median "
            f"{statistics.median(copy_ms):.2f} ms a batch of "
            f"{full_b / 1e6:.1f} MB; a train epoch streamed {str_s:.3f} s "
            f"(RSS growth {str_rss / 1e6:.1f} MB) against {dev_s:.3f} s "
            f"device-resident (RSS growth {dev_rss / 1e6:.1f} MB)")

    log(f"  (c) operator builds in the phase: {builds.calls} (expected 2: "
        f"one a diffusion direction)")
    if builds.calls != 2:
        raise SystemExit("PeMS index path: operator builds differ from 2")
    f_hop = bs * 2 * c["f"]
    report_fused(torch, kernel_report, mats[0].fwd, f_hop,
                 "PeMS index DCRNN f32")
    sweep_f32_tile(torch, kernel_report, mats[0].fwd, f_hop,
                   "PeMS diffusion operator (N=11,160)")
    # the digest tiles the raw graph on the host: the diffusion operators'
    # weights are normalized on the card with atomics, so their last bits
    # may change from run to run
    raw = BCSRMatrix.from_graph(g, dtype=torch.float32).fwd
    log(f"  f32 digest, the raw PeMS graph's forward half (nnzb={raw.nnzb} "
        f"rem={raw.num_rem}) at F={f_hop}, x from numpy seed {DIGEST_SEED}: "
        f"{f32_digest(torch, [raw], [f_hop], DIGEST_SEED)}")


def rel_err(got, want):
    """max |got − want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def phase_mixed(torch, kernel_report, smi):
    """Phase 3's model and operators through ``make_mixed_precision_step``:
    bf16 compute (bf16_policy), then f16 with a dynamic loss scale."""
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr
    from pytorch_geometric_temporal_tpu_torch.train import (
        DynamicLossScale, TrainState, bf16_policy, f16_policy,
        make_mixed_precision_step)

    c, m = SLICE, MIXED
    sl = kernel_report["slice"]
    ops, ops_seg, x, y = sl["ops"], sl["ops_seg"], sl["x"], sl["y"]
    model = DCRNNSeq(c["f"], c["hidden"], K=2,
                     generator=torch.Generator().manual_seed(0))
    dtypes = []

    def loss_on(operators):
        def loss_fn(params, xb, yb):
            pred = torch.func.functional_call(model, params, (xb, operators))
            dtypes.append(pred.dtype)
            return (pred.float() - yb.float()).square().mean()
        return loss_fn

    loss_fn = loss_on(ops)
    # forward and parameter gradients against the f32 segment path
    master = dict(model.named_parameters())
    with torch.no_grad():
        out_b = torch.func.functional_call(
            model, bf16_policy.cast_to_compute(master),
            (x.to(torch.bfloat16), ops))
    grads_b = torch.autograd.grad(
        loss_fn(bf16_policy.cast_to_compute(master), x.to(torch.bfloat16),
                y.to(torch.bfloat16)), list(master.values()))
    with config_override(spmm_backend="segment"):
        with torch.no_grad():
            out_s = model(x, ops_seg)
        grads_s = torch.autograd.grad(loss_on(ops_seg)(master, x, y),
                                      list(master.values()))
    fwd = rel_err(out_b, out_s)
    grad = {name: rel_err(gb, gs)
            for name, gb, gs in zip(master, grads_b, grads_s)}
    worst = max(grad, key=grad.get)
    log(f"  bf16 compute vs the f32 segment path: output {out_b.dtype}, "
        f"forward {fwd:.3e} of the largest output (tol {MIXED_TOLS[0]}), "
        f"parameter gradients up to {grad[worst]:.3e} at {worst} (tol "
        f"{MIXED_TOLS[1]}): " + ", ".join(f"{k} {v:.2e}"
                                           for k, v in grad.items()))
    if out_b.dtype != torch.bfloat16:
        raise SystemExit("bf16 compute did not return bf16 outputs")
    if not (fwd <= MIXED_TOLS[0] and grad[worst] <= MIXED_TOLS[1]):
        raise SystemExit("bf16 compute does not match the segment path")

    state = TrainState.create(
        model, lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8))
    step = make_mixed_precision_step(loss_fn, policy=bf16_policy)
    step(state, x, y)  # warm-up step
    torch.cuda.synchronize()
    dtypes.clear()
    bcsr.reset_launch_counts()
    losses = [float(step(state, x, y)[1]) for _ in range(m["steps"])]
    launches = launch_counts(bcsr)
    want = expected_launches(c["t"], 2, m["steps"])
    log(f"  bf16-compute steps: losses {['%.6f' % v for v in losses]}; "
        f"launches over {m['steps']} steps: fused {launches['H']} (expected "
        f"{want}), K1 {launches['K1']} and K2 {launches['K2']} (expected "
        f"0); predictions {sorted({str(d) for d in dtypes})}")
    if launches != {"H": want, "K1": 0, "K2": 0}:
        raise SystemExit("launch counts differ from the model's count")
    kernel_report["H"]["launches"] += launches["H"]
    if set(dtypes) != {torch.bfloat16}:
        raise SystemExit(f"predictions in {dtypes}, not bf16")
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise SystemExit("master parameters left f32")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"bf16-compute loss does not fall: {losses}")
    step_s = []
    for _ in range(m["timed_steps"]):
        t0 = time.perf_counter()
        step(state, x, y)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s)
    log(f"  bf16-compute step (host clock, synchronized, {m['timed_steps']} "
        f"steps): median {med * 1e3:.3f} ms, min {min(step_s) * 1e3:.3f}, "
        f"max {max(step_s) * 1e3:.3f}; phase 3's f32-compute step median "
        f"{sl['step_ms']:.3f} ms; on {smi}")
    busy = profile_steps(torch, lambda: step(state, x, y), med * 1e3)
    if busy is not None and sl["busy_ms"] is not None:
        log(f"  device busy per step: bf16 compute {busy:.3f} ms, f32 "
            f"compute (phase 3) {sl['busy_ms']:.3f} ms, ratio "
            f"{busy / sl['busy_ms']:.3f}, on {smi}")

    # f16 with a dynamic loss scale: a planted overflow is skipped
    dev = x.device
    scale = DynamicLossScale(
        scale=torch.tensor(m["f16_scale"], device=dev),
        steps_since_growth=torch.tensor(0, dtype=torch.int32, device=dev),
        growth_interval=m["growth_interval"])
    state16 = TrainState.create(
        model, lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8))
    step16 = make_mixed_precision_step(loss_fn, policy=f16_policy,
                                       dynamic_scale=True)
    dtypes.clear()
    state16, scale, l0 = step16(state16, scale, x, y)
    before = state16.snapshot()
    state16, scale, l_bad = step16(state16, scale, x * 1e9, y)
    after = state16.snapshot()
    same = (after["step"] == before["step"] and all(
        torch.equal(after["params"][k], v)
        for k, v in before["params"].items()) and all(
        torch.equal(after["opt_state"]["state"][i][key], v)
        for i, mom in before["opt_state"]["state"].items()
        for key, v in mom.items()))
    halved = float(scale.scale)
    clean = []
    for _ in range(2):
        state16, scale, loss = step16(state16, scale, x, y)
        clean.append(float(loss))
    log(f"  f16 compute, loss scale {m['f16_scale']}: first step loss "
        f"{float(l0):.6f}; planted overflow (x·1e9) loss {float(l_bad)}, "
        f"parameters, Adam moments and steps unchanged bit for bit: {same}, "
        f"scale {halved}; two clean steps {['%.6f' % v for v in clean]}, "
        f"scale {float(scale.scale)}, state step {state16.step}; "
        f"predictions {sorted({str(d) for d in dtypes})}")
    if not (same and halved == m["f16_scale"] / 2
            and float(scale.scale) == m["f16_scale"]
            and state16.step == 3 and np.isfinite(clean).all()
            and torch.isfinite(l0)):
        raise SystemExit("the f16 loss-scale schedule misbehaved")


def banded_bipartite(rng, n_src, n_dst, e, band, frac_local=0.95):
    """``e`` edges from ``n_src`` to ``n_dst`` nodes: ``frac_local`` of
    them within ±band of the source's scaled position, the rest random."""
    e_loc = int(e * frac_local)
    s = rng.integers(0, n_src, size=e)
    r = np.concatenate([
        np.clip(s[:e_loc] * n_dst // n_src
                + rng.integers(-band, band + 1, size=e_loc), 0, n_dst - 1),
        rng.integers(0, n_dst, size=e - e_loc)])
    return np.stack([s, r]), rng.uniform(0.1, 1.0, e).astype(np.float32)


def phase_hetero(torch, kernel_report, smi):
    """HeteroGCLSTM over a static heterogeneous signal at the slice's
    scale, stacked and trained through SnapshotTrainer."""
    from pytorch_geometric_temporal_tpu_torch.ops import Graph, bcsr
    from pytorch_geometric_temporal_tpu_torch.protocols.hetero import (
        HeteroRegressor)
    from pytorch_geometric_temporal_tpu_torch.signal import (
        StackedHeteroSignal, StaticHeteroGraphTemporalSignal)
    from pytorch_geometric_temporal_tpu_torch.train import (
        SnapshotTrainer, mse)
    from pytorch_geometric_temporal_tpu_torch.utils import (
        device_memory_stats)

    c = HETERO
    rng = np.random.default_rng(c["seed"])
    n = {"a": c["n_a"], "b": c["n_b"]}
    f = {"a": c["f_a"], "b": c["f_b"]}
    meta = (["a", "b"], [("a", "to", "b"), ("b", "to", "a")])
    t0 = time.perf_counter()
    edges = {(s, r, d): banded_bipartite(rng, n[s], n[d], c["e"], c["band"])
             for s, r, d in meta[1]}
    feats = [{k: rng.normal(size=(n[k], f[k])).astype(np.float32)
              for k in n} for _ in range(c["t"])]
    targs = [{"a": x["a"].sum(-1) * 0.3, "b": x["b"].sum(-1) * 0.5}
             for x in feats]
    sig = StaticHeteroGraphTemporalSignal(
        {k: v[0] for k, v in edges.items()},
        {k: v[1] for k, v in edges.items()}, feats, targs)
    stacked = StackedHeteroSignal.from_signal(sig)
    torch.cuda.synchronize()
    log(f"  node types a: N={n['a']} F={f['a']}, b: N={n['b']} F={f['b']}; "
        f"{c['e']} edges each way; T={c['t']}; stacked on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    def make_model(device):
        return HeteroRegressor(meta, f, c["hidden"], device=device,
                               generator=torch.Generator().manual_seed(0))

    def snapshot_loss(model, x, y, graphs):
        preds, h, cc = model(x, graphs)
        return sum(mse(preds[k], y[k]) for k in preds), preds, h

    # one snapshot on the card against the port on the CPU
    results = []
    for device in ("cuda", "cpu"):
        model = make_model(device)
        graphs = {k: Graph(g.senders.to(device), g.receivers.to(device),
                           g.weights.to(device), g.num_nodes, g.num_edges,
                           g.num_src)
                  for k, g in stacked.edge_graphs().items()}
        x = {k: v[0].to(device) for k, v in stacked.x_dicts.items()}
        y = {k: v[0].to(device) for k, v in stacked.y_dicts.items()}
        loss, preds, h = snapshot_loss(model, x, y, graphs)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append(({k: v.detach().cpu() for k, v in h.items()},
                        {k: v.detach().cpu() for k, v in preds.items()},
                        [gr.cpu() for gr in grads],
                        [name for name, _ in model.named_parameters()]))
    (h_g, p_g, g_g, names), (h_c, p_c, g_c, _) = results
    fwd = max(rel_err(a[k], b[k]) for a, b in ((h_g, h_c), (p_g, p_c))
              for k in b)
    grad = {name: rel_err(a, b) for name, a, b in zip(names, g_g, g_c)}
    worst = max(grad, key=grad.get)
    log(f"  one snapshot, card against CPU: outputs {fwd:.3e} of their "
        f"scale (tol {HETERO_TOLS[0]}), parameter gradients up to "
        f"{grad[worst]:.3e} at {worst} (tol {HETERO_TOLS[1]})")
    if not (fwd <= HETERO_TOLS[0] and grad[worst] <= HETERO_TOLS[1]):
        raise SystemExit("hetero on the card does not match the CPU")

    model = make_model("cuda")

    def step(carry, x, y, graphs):
        h, cc = carry if carry else (None, None)
        preds, h, cc = model(x, graphs, h, cc)
        return sum(mse(preds[k], y[k]) for k in preds), (h, cc)

    trainer = SnapshotTrainer(model, step, lr=1e-2)
    torch.cuda.reset_peak_memory_stats()
    bcsr.reset_launch_counts()
    losses, epoch_s = [], []
    for _ in range(c["epochs"]):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_epoch(stacked, None)))
        epoch_s.append(time.perf_counter() - t0)
    launches = launch_counts(bcsr)
    mem = device_memory_stats()
    log(f"  {c['epochs']} epochs: losses {['%.6f' % v for v in losses]}; "
        f"host epoch times {['%.3f' % v for v in epoch_s]} s; launches: "
        f"fused {launches['H']}, K1 {launches['K1']}, K2 {launches['K2']} "
        f"(expected 0: bipartite SAGEConv aggregates on the segment path); "
        f"peak {mem['peak_bytes_in_use'] / 2**30:.2f} GiB of "
        f"{mem['bytes_limit'] / 2**30:.1f} (device_memory_stats); on {smi}")
    if launches != {"H": 0, "K1": 0, "K2": 0}:
        raise SystemExit("hetero training launched a BCSR kernel")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"hetero loss does not fall: {losses}")
    profile_steps(torch, lambda: trainer.train_epoch(stacked, None),
                  statistics.median(epoch_s) * 1e3, n=1, unit="epoch")


def phase_harness(torch, smi):
    """The harness protocol on Chickenpox: an uninterrupted run, a run
    resumed from its own checkpoint, and a planted NaN epoch."""
    import shutil
    import tempfile

    from pytorch_geometric_temporal_tpu_torch.protocols import harness

    c = HARNESS
    tmp = tempfile.mkdtemp(prefix="harness_")
    try:
        lines = []

        def run(epochs, name, **kw):
            t0 = time.perf_counter()
            best, hist = harness.main(epochs, ckpt_dir=os.path.join(
                tmp, name), log=lines.append, **kw)
            torch.cuda.synchronize()
            return hist, time.perf_counter() - t0

        whole, secs = run(c["epochs"], "whole")
        n_train = harness.chickenpox(device="cuda")[0].snapshot_count
        kept = sorted(int(d) for d in os.listdir(os.path.join(tmp, "whole")))
        summary = [ln for ln in lines if re.fullmatch(
            r"\d+ steps, [\d.]+ ms/step, [\d.]+ items/s", ln)]
        log(f"  {c['epochs']} epochs in {secs:.2f} s ({secs / c['epochs']:.3f}"
            f" s an epoch of {n_train} updates, host clock, on {smi}); "
            f"train MSE {['%.6f' % h['train_mse'] for h in whole]}; val MSE "
            f"{['%.6f' % h['val_mse'] for h in whole]}; StepTimer: "
            f"{summary}; checkpoints kept {kept}")
        if kept != [(c["epochs"] - 1) * n_train, c["epochs"] * n_train]:
            raise SystemExit(f"retention kept {kept}")
        if len(summary) != 1 or not summary[0].startswith(
                f"{c['epochs']} steps, "):
            raise SystemExit(f"StepTimer's summary reads {summary}")
        losses = [h["train_mse"] for h in whole]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise SystemExit(f"harness loss does not fall: {losses}")

        run(c["resume_at"], "resumed")
        lines.clear()
        rest, _ = run(c["epochs"], "resumed")
        resumed = [ln for ln in lines if ln.startswith("resumed from step")]
        pairs = [(a, b) for a, b in zip(rest, whole[c["resume_at"]:])]
        worst = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in pairs
                    for k in ("train_mse", "val_mse"))
        bitwise = all(a == b for a, b in pairs)
        log(f"  resumed at epoch {c['resume_at']} ({resumed}): epochs "
            f"{[h['epoch'] for h in rest]}, largest relative difference "
            f"from the uninterrupted run {worst:.3e} (tol "
            f"{HARNESS_RESUME_TOL}); bitwise equal: {bitwise}")
        if (len(resumed) != 1 or [h["epoch"] for h in rest] != list(
                range(c["resume_at"], c["epochs"]))
                or not worst <= HARNESS_RESUME_TOL):
            raise SystemExit("the resumed run differs from the whole run")

        lines.clear()
        guarded, _ = run(c["nan_epoch"] + 2, "guarded",
                         nan_epochs={c["nan_epoch"]})
        rolled = [ln for ln in lines if "rolled back" in ln]
        after = guarded[-1]["train_mse"]
        want = whole[c["nan_epoch"]]["train_mse"]
        log(f"  NaN planted in epoch {c['nan_epoch']}: {rolled}; epochs "
            f"{[h['epoch'] for h in guarded]}; the next epoch's loss "
            f"{after:.6f} against the uninterrupted run's epoch "
            f"{c['nan_epoch']} {want:.6f}")
        if (len(rolled) != 1 or [h["epoch"] for h in guarded] != [
                e for e in range(c["nan_epoch"] + 2) if e != c["nan_epoch"]]
                or abs(after - want) > HARNESS_RESUME_TOL * abs(want)):
            raise SystemExit("DivergenceGuard did not roll the epoch back")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import pytorch_geometric_temporal_tpu_torch  # noqa: F401  (fails alone)
    # full-precision f32 matmuls everywhere (the plain versions and the
    # segment reference); TF32 would round to ~3 decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    watchdog = threading.Timer(WATCHDOG_S, lambda: (
        print(f"chip_smoke: still running after {WATCHDOG_S} s, giving up",
              file=sys.stderr, flush=True), os._exit(124)))
    watchdog.daemon = True
    watchdog.start()

    log("== phase 1: card and kernel build")
    smi, other_libs = phase_card(torch)
    log("== phase 2: kernels against their plain versions")
    phase_kernel_cases(torch)
    log("== phase 3: DCRNNSeq training at N=50k over BCSR operators")
    report = {"f32_other_libs": other_libs, "f32_sweep": []}
    phase_slice(torch, report)
    log("== phase 4: dense path (METR-LA shape)")
    phase_dense(torch)
    log("== phase 5: snapshot pipeline on Chickenpox (GConvGRU, K=1)")
    phase_chickenpox(torch)
    log("== phase 6: GConvGRU training at N=50k over a Chebyshev BCSR "
        "operator")
    phase_cheb(torch, report)
    log("== phase 7: dynamic-edge sequence over stack_bcsr")
    phase_dynamic(torch, report)
    log("== phase 8: the bundled-data accuracy protocols")
    phase_protocols(torch)
    log("== phase 9: TGCN training at N=50k over a GCN BCSR operator")
    phase_tgcn(torch, report)
    log("== phase 10: EvolveGCN-O/H over stack_bcsr_gcn")
    phase_evolve(torch, report)
    log("== phase 11: the METR-LA accuracy protocol at full size")
    phase_metrla(torch, smi)
    log("== phase 12: the attention family on the dense branch")
    phase_attention(torch, smi)
    log("== phase 13: STConv at N=50k over a Chebyshev BCSR operator")
    phase_stconv(torch, report, smi)
    log("== phase 14: edge-mode ASTGCN at N=50k")
    phase_astgcn_edge(torch, report, smi)
    log("== phase 15: index-batched DCRNN on the PeMS-scale stand-in")
    phase_index_pems(torch, report, smi)
    log("== phase 16: DCRNNSeq at N=50k in bf16 compute "
        "(make_mixed_precision_step), then f16 with a loss scale")
    phase_mixed(torch, report, smi)
    del report["slice"]
    log("== phase 17: HeteroGCLSTM at N=50k + 20k through SnapshotTrainer")
    phase_hetero(torch, report, smi)
    log("== phase 18: the training harness on Chickenpox")
    phase_harness(torch, smi)

    kernels = []
    jax_bcsr = "pytorch_geometric_temporal_tpu/ops/bcsr.py"
    for key, name, src, replaces in (
            ("H", "hybrid_spmm", "hybrid_spmm.cu",
             f"{jax_bcsr}:546 and {jax_bcsr}:612"),
            ("K1", "tile_spmm", "bcsr_kernels.cu", f"{jax_bcsr}:546"),
            ("K2", "rem_scatter_", "bcsr_kernels.cu", f"{jax_bcsr}:612")):
        k = report[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pytorch_geometric_temporal_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": k["launches"], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    for line in report["f32_sweep"]:
        log(f"f32 feature-tile sweep on {smi}: {line}")
    log("fused kernel by path (cold ms, share of its bound): " + "; ".join(
        f"{label} {k['ms']:.4f} ms, {k['bound_ms'] / k['ms']:.3f}"
        for label, k in report["paths"]))
    log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    watchdog.cancel()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
