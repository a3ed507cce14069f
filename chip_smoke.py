#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``pytorch_geometric_temporal_tpu_torch`` only (no JAX).  Every
phase that trains through ``BatchTrainer`` or ``SnapshotTrainer``, the
METR-LA and bundled protocols and the harness included, runs its steps as
replays of CUDA graphs, the default on the card (one graph a step
signature; phases 3, 6, 8, 9, 11, 12, 15, 18 and 21 assert how many);
MTGNN's dropout generator is registered with its graph.  Launch counts
stay kernels executed under replay.

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
   fused launches; each graph's ``min_block_edges="auto"`` θ under both
   cost models (the build uses the default H100 one);
8. the eight bundled-data accuracy protocols at their full epoch counts
   (PedalMe: DCRNN, TGCN, A3TGCN; TwitterTennis rg17: EvolveGCN-O,
   EvolveGCN-H, DyGrEncoder; EnglandCovid: DCRNN; MontevideoBus:
   GConvGRU): test MSE beside the JAX package's TPU v5e record, seconds
   per epoch, one CUDA graph each (the first epoch eager, the rest
   replays); small graphs on the dense branch, no BCSR kernel launched;
   then the two full-sequence runs (EvolveGCN-O / -H) eager and captured
   from the same parameters (``loop_eager_and_captured``: a steady epoch's
   host and device busy time both ways, memory, losses, test MSE and
   parameters equal to the bit);
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
   F=16 on every half, timed; each GCN operator's θ under both cost
   models;
11. the METR-LA accuracy protocol at full size (``DCRNNSeq(2->2, K=3)``,
   207 sensors, 2880 steps of the seeded synthetic stand-in, 12 epochs of
   batches of 64, Adam 1e-3): falling training curve, the de-normalized
   masked test MAE, seconds per epoch; then at the size of the JAX
   package's records (3 epochs over 720 steps), its MAE beside them; one
   train graph and one test graph each; dense branch, no BCSR kernel
   launched; then the full-size run eager and captured, as phase 8's;
12. the attention family on the dense branch: ASTGCN and MSTGCN at the
   reference configuration (B=16, N=207, F_in=2, T=12, K=3, 2 blocks,
   64/64 filters, predict 12), five Adam steps each with the device's
   busy time per step and their difference (the attention's share), then
   three Adam steps each of STConv, GMAN, MTGNN, AAGCN and DNNTSP at the
   papers' widths in ``train=True`` (finite, falling loss, moving batch
   statistics, one CUDA graph and two replays; MTGNN's dropout masks from
   a CUDA generator handed to the trainer and reseeded before each step);
   no BCSR kernel launched; then MTGNN's step eager and captured as phase
   24 runs its paths, equal to the bit (cuDNN's deterministic algorithms);
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
   a step, and hop 1's kernel (``csrc/weighted_hop.cu``) once a block
   forward and once backward, with no per-edge message formed, and the
   block tail's kernel (``csrc/block_tail.cu``) likewise, copying only
   block 1's (B, N, F, T) input into rows; per-edge
   attention sums to 1 per column; output and gradients
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
   feature tiles; timed at F = 64·66 = 4,224 (DCRNN's published widths,
   the benchmark's ``pems-dcrnn64``); the SHA-256 of the kernel's output
   on the raw graph's tiles at that width;
16. phase 3's DCRNNSeq and operators trained through
   ``make_mixed_precision_step`` with ``bf16_policy`` (f32 master
   parameters in a ``TrainState``, bf16 compute, Adam 1e-3): forward and
   parameter gradients against the f32 segment path, bf16 predictions, 30
   fused launches a step and none of K1/K2, one CUDA graph (the step is
   captured), a falling loss, the step time and the device's busy time
   beside phase 3's f32-compute step; then ``f16_policy`` with a
   ``DynamicLossScale``, captured: after two clean steps a planted overflow
   batch and two clean steps run as replays with every host sync an error
   (``torch.cuda.set_sync_debug_mode``); the overflow leaves parameters,
   Adam moments and step counts and the state's step unchanged bit for bit
   and halves the scale, the clean steps double it;
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
   stopping) on Chickenpox for 10 epochs, its epoch and its validation
   pass captured (two graphs a run); a second run stopped at epoch 5 and
   resumed from its checkpoints captures its own and must equal it to the
   bit; two checkpoints kept; a planted NaN epoch rolled back; then the
   run eager and captured, as phase 8's;
19. PGT-I's DDP recipe on phase 15's PeMS stand-in: two spawned ranks
   time-share the card over gloo with CUDA tensors (NCCL refuses two ranks
   on one device), each fed by ``IndexLoader(world_size=2, rank=r)`` with
   32 windows (global batch 64) through ``make_dp_train_step`` (masked MAE
   on de-normalized values, each rank's loss weighted by its share of the
   global mask count, Adam 1e-3), DCRNNSeq(2, 2, K=2) over the raw graph
   that ``spmm`` tiles in f32: 94 fused launches a rank a step, the first
   step's loss, the all-reduced gradient Adam is given and the parameters
   after it against the single-process step on the concatenated batch,
   the ranks' parameters equal after 3 steps
   (``assert_same_across_hosts``), the steps run eagerly (gloo cannot be
   captured), step time, the share of it that the step's two all-reduces
   take when timed alone, and the device's busy time a rank (time-sharing
   one card: no scaling is measured);
20. the halo-partitioned DCRNN at the same scale: the same two ranks build
   ``PartitionedDiffusionOperators.from_graph(graph, 2)`` and run
   ``DCRNNPartitionedSeq(2, K=2)`` on their node blocks of 64 windows
   (T=12, node-leading, phase 19's initial parameters): forward and the
   masked MAE's parameter gradients against single-device DCRNNSeq on the
   segment path, the all-to-all bytes of one hop, of the forward and of
   forward + backward equal to ``ici_bytes_per_step``, H against
   ``nodes_per_part``; one aggregation through the 'gather' and 'scatter'
   exchanges, forward and backward (gloo runs all-gather and reduce-scatter
   on CUDA tensors in torch 2.11); then P=1 over NCCL in this process,
   against the same reference;
21. phase 15's recipe on the same stand-in with its sensor ids scrambled
   by one seeded permutation σ (edges (σ[s], σ[r]), series columns moved
   with σ), the raw ``Graph`` handed to ``spmm``'s auto route with
   ``spmm_reorder="auto"``: exactly 2 f32 operator builds, laid out as the
   default cost model (``ops/bcsr.py``: ``H100``) decides; the first
   batch's outputs and gradients, on that layout and on the RCM order TPU
   v5e's model keeps (through the permutation gathers forward and
   backward), against the segment path and against phase 15's unscrambled
   run un-permuted by σ; 94 / 48 fused launches a
   train / eval batch; two epochs, falling; then five variants at the same
   parameters on the same batch — the run's own layout (auto), the RCM
   order TPU v5e's model keeps (i), as the ids come (ii), ``reorder_graph``
   once with no gathers a hop (iii), and the unscrambled graph (iv), which
   keeps no permutation — each with its device busy time a train step,
   the fused kernel's and the permutation gathers' forward and backward
   time, the host step and the kernel cold at F=256; both cost models'
   ``_reorder_costs`` beside the measured hop and step.  The default
   model's decision must be the build's and pick the variant of lower busy,
   (i) or (ii), wherever they differ by more than ``DECISION_MARGIN``, and
   the auto run's busy stay within ``AUTO_BUSY_TOL`` of that variant's;
22. ``bench.py:bench_reorder_recovery``'s draw (N=20,000, 40 edges a node
   within ±96 under scrambled ids, bf16 tiles, ``min_block_edges="auto"``):
   the operator as the ids come at TPU v5e's θ and at the H100 model's,
   and reordered as the H100 model decides (it must reorder), with θ under
   both models; the kernels against their plain versions on every half at
   F=64, one ``bcsr_spmm`` each against ``spmm_segment``, the fused kernel
   cold on all three (the H100 θ no slower than v5e's), the ratios beside
   the JAX package's TPU v5e record and the gathers; then AVWGCN(topk=8) at
   N=20,000 forward and backward on the card, its kept columns and outputs
   against the same module on the CPU;
23. the BCSR builder's H100 cost model against the card: the fused kernel on
   synthetic halves of ``COST_SHAPES`` (0-4 tiles and 0-5,000 remainder
   edges a row block, under one wave of 132 CTAs and over two) at each
   width of ``COST_SWEEP`` in bf16 and f32 tiles, warm (x just written, no
   L2 flush) and cold, and the permutation gathers; every point is printed
   (``cost-shape``, ``cost-point``, ``gather-point`` lines, which
   ``tools/fit_kernel_costs.py`` refits from), with the committed
   constants' prediction and the constants refitted on this run; the
   operators of phases 15, 21 and 22 are held-out points.  The model
   prices f32 tiles dense, so an f32 half with walked tiles is timed with
   every tile dense, and as built beside it (``walked_warm_ms``).  The
   committed model's median relative error of the warm prediction must
   stay within ``COST_MEDIAN_TOL`` on the sweep, on the held-out points
   and on the gathers;
24. (run after phase 16) phases 3, 6, 15 and 16's (bf16 and f16) paths eager
   (``capture=False``) and captured, from the same parameters on the same
   batches: host time
   a step or epoch, device busy time and busy share both ways, the
   profiler's top kernels both ways (a replay runs no host op, so only the
   eager run attributes kernels to operations), the captured run's losses
   and parameters against the eager run's within ``CAPTURE_LOSS_RTOL`` /
   ``CAPTURE_PARAM_ATOL`` and whether the first step's loss is bit-equal,
   one CUDA graph a path, and the launch counts under replay;
25. (run after phase 20) phase 19's data-parallel step at P=1 over NCCL,
   the group of one ``make_mesh`` makes, at phase 15's width and depth:
   its first step against ``BatchTrainer``'s on the same batch within
   ``DDP_TOLS``, then eager against captured as in phase 24, and the
   all-reduce bytes a replay sends against the formula;
26. (run after phase 14) edge-mode ASTGCN's hop 1 kernel
   (``csrc/weighted_hop.cu``) at the benchmark cell's shapes (B = 32,
   N = 11,160, T = 12, F = 2 and 64, the reversed L-hat of phase 15's
   banded graph): forward, g_x and g_w against the plain version within
   the bound of two f32 sum orders, two runs equal to the bit, then each
   timed cold beside its byte bound and the plain version's time;
27. (run after phase 26) an ASTGCN block's tail kernel
   (``csrc/block_tail.cu``) at the benchmark cell's shapes (B = 32,
   N = 11,160, T = 12, C = 64): forward and backward against the plain
   version, with the gradient laid out as the head leaves it and
   contiguous, two runs equal to the bit, then each timed cold beside its
   byte bound, the plain version and ``F.layer_norm(F.relu(a + b))``
   forward and through autograd (a yardstick the port never calls).

A watchdog ends the process if the whole run passes 1150 s (a hang in a
kernel must not outlive the run).  Exits non-zero, and prints no result,
without CUDA or when any check fails.  The last line is ``{"ok": true,
"device": {...}}``; the line before it holds the per-kernel JSON record,
its launch counts summed over phases 3, 6, 7, 9, 10, 13, 14, 15, 16, 19
(both ranks), 25 (its first step), 21 and 22 (phase 24's are checked, not
summed), the hop-1 and block-tail kernels' of phase 14 (phases 26 and 27's are
not counted); the
fused kernel's time and share of its bound at each path's own width, and
the f32 feature-tile sweep, stand on the lines before the total.
"""

import contextlib
import ctypes
import dataclasses
import hashlib
import inspect
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
# phase 24: phases 3, 6 and 15's paths eager (capture=False) and captured
# from the same parameters on the same batches: counted steps (epochs for
# phase 6), then steps timed on the host clock.  Both runs build Adam with
# capturable=True and launch the same kernels on the same inputs, so a
# difference can come only from a library choosing another algorithm under
# capture: losses within 1e-5 relative, parameters within 1e-5 absolute
# (an Adam step moves a parameter by up to its learning rate, 1e-3-1e-2)
CAPTURE = dict(steps=6, timed=20)
CAPTURE_LOSS_RTOL, CAPTURE_PARAM_ATOL = 1e-5, 1e-5
# phases 8, 11 and 18: a whole training loop eager and captured from the
# same parameters on the same schedule, equal to the bit; a steady epoch's
# host time is the difference of the whole run's training seconds and
# those of a run of SHORT epochs (the eager one and the capturing one), its
# device busy time the profiled difference of runs of PROFILED epochs
# (those first epochs and the test pass cancel)
LOOP = dict(short=2, profiled=(2, 6))
# phase 12: MTGNN's dropout masks come from a CUDA generator reseeded to
# this before each step, as the JAX step is handed one key
MTGNN_MASK_SEED = 7
# phase 2's widths: each f32 and bf16 instantiation of the fused kernel
# (n-tile counts 1, 2, 4, 5, 6, 8, 12, 16; 1 and 14 ragged), two feature
# tiles at F=200; the f32 digests of phases 2 and 15 draw x from DIGEST_SEED
KERNEL_CASE_FS = (1, 8, 14, 16, 32, 36, 48, 64, 96, 128, 200)
DIGEST_SEED = 7
# the f32 digests of phases 2 and 15: each output one fmaf chain, the tile
# products k ascending then the remainder edges in column order, as every
# fused kernel has summed (a change of the sum order changes them)
PHASE2_F32_DIGEST = ("3c72d6bd71379c9426008c1b6f044b6b"
                     "ba6fe83c8f20385372fcbaf974b9707b")
PHASE15_F32_DIGEST = ("856eaabe6b3df0ee496da8b67344d9d8"
                      "39cf1b7c67d7e8b11f206b2f0a19080e")
# phase 2's remainder cases: a remainder-only operator of ~1,000 tasks, a
# row of HUB_EDGES edges beside a banded graph, and x rows that are not
# 16-byte aligned on a remainder-only operator
REMAINDER_CASE = dict(n=16_384, e=400_000, band=300, seed=6)
HUB_CASE = dict(n=1500, e=12_000, hub=700, hub_edges=20_000, seed=3)
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
# phase 26: hop 1 at the benchmark cell's batch, steps and widths (blocks 1
# and 2), on the reversed L-hat of phase 15's graph
HOP = dict(b=32, t=12, fs=(2, 64), reps=20, plain_reps=5)
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
# phases 19 and 20: PGT-I's DDP recipe (pems_ddp.py: window indices split
# over the ranks, gradients all-reduced) on phase 15's stand-in with the
# global batch of 64, then the halo-partitioned DCRNN on the same graph and
# 64 windows; two ranks time-share the one card over gloo with CUDA tensors
# (NCCL refuses two ranks on one device), P=1 runs over NCCL
DIST = dict(world=2, steps=3, timed_steps=5, profiled_steps=2)
# phase 19 against the single-process step on the concatenated batch: the
# same kernel at another width (F = 32·4 = 128 a rank, 256 whole) sums in
# another order; loss 1e-5 relative; the all-reduced gradient within 1e-4
# of each leaf's largest entry (a gradient scaled wrongly, by the world
# size or unweighted means, is off by tens of percent); each parameter
# after Adam's first step within 1e-5 of its largest entry (that step sees
# only the gradient's signs: an entry whose sign flipped would move it by
# twice the learning rate, 2e-3)
DDP_TOLS = (1e-5, 1e-4, 1e-5)
# phase 20 against single-device DCRNNSeq on the segment path: forward by
# the largest output, each parameter gradient by its largest entry
HALO_TOLS = (1e-4, 1e-3)
# phase 21: phase 15's stand-in with its sensor ids scrambled by one seeded
# permutation σ (real sensor graphs come with arbitrary ids: PeMS station
# ids, METR-LA's sensor list), trained two epochs where phase 15 trains
# three; the four operator variants are each timed over that many steps
PEMS_SCRAMBLE_SEED = 3
SCRAMBLED = dict(epochs=2, timed_steps=10)
# the host ops of bcsr_spmm's permutation gathers, forward and backward
# (ops/bcsr.py: _Permute), whose kernels the profiler attributes to them
PERMUTE_OPS = ("_Permute", "_PermuteBackward")
FUSED_KERNEL = re.compile(r"hybrid_spmm_kernel")
# phase 22: bench.py:bench_reorder_recovery's draw, and the JAX package's
# record of its kernel-time ratio (plain over reordered) on a TPU v5e
# (BENCH_r05.json, bcsr_reorder_speedup_scrambled)
RECOVERY = dict(n=20_000, deg=40, band=96, f=64, seed=2)
RECOVERY_RECORD_TPU_V5E = 18.9
# AVWGCN's sparse top-k at tests/test_learned_adjacency_large_n.py's size;
# the card against the CPU by the CPU output's largest entry
AVW = dict(n=20_000, f=3, d=4, out=4, K=2, topk=8, seed=2)
AVW_TOL = 1e-4
# phase 21: the decision must pick the variant of lower device busy a step,
# reordered (i) or as the ids come (ii), wherever the two differ by more
# than DECISION_MARGIN, and the "auto" run's busy stay within AUTO_BUSY_TOL
# of the variant whose layout it chose
DECISION_MARGIN = 0.05
AUTO_BUSY_TOL = 0.03
# phase 23: the cost-model sweep.  Synthetic halves from the port's builder
# (ops/bcsr.py: _build_half at threshold ``theta``): each of a shape's row
# blocks holds a seeded number of tiles of ``tile_edges`` edges in distinct
# column blocks and of remainder edges spread over its other column blocks
# (under ``theta`` a block); every half at each width of ``fs`` in bf16
# and f32 tiles, timed warm and cold; the permutation gathers at
# ``gather_rows`` x ``fs``.  Shapes: (label, row blocks, tiles a row block
# (low, high), remainder edges a row block (low, high)), under one wave of
# 132 CTAs and over two, the remainder-only ones cut into tasks (s64-r20k:
# ~20 a row block).  Beside the sweep, phase 2's hub graph is timed at
# every width (``hub-point`` lines, which the fit does not read: the model
# sees row blocks, not rows)
COST_SWEEP = dict(fs=(32, 64, 96, 256, 768), seed=11, theta=400,
                  tile_edges=600, warm_reps=20, cold_reps=10,
                  gather_rows=(11_264, 20_096, 38_400))
COST_SHAPES = (
    ("s40-t2", 40, (2, 2), (0, 0)),
    ("s40-mix", 40, (0, 4), (0, 5000)),
    ("s100-t4", 100, (4, 4), (0, 0)),
    ("s100-r2k", 100, (0, 0), (2000, 2000)),
    ("s157-t1", 157, (1, 1), (0, 0)),
    ("s157-r5k", 157, (0, 0), (4000, 5000)),
    ("s157-mix", 157, (0, 4), (0, 400)),
    ("s157-t2r1k", 157, (2, 2), (1000, 1000)),
    ("s88-t1r700", 88, (1, 1), (600, 800)),
    ("s200-sparse", 200, (0, 1), (0, 100)),
    ("s300-t0-4", 300, (0, 4), (0, 0)),
    ("s300-mix", 300, (1, 3), (0, 1000)),
    ("s300-r0-2k", 300, (0, 0), (0, 2000)),
    ("s64-r20k", 64, (0, 0), (15000, 20000)),
)
# cycles the card spins before each warm launch (~0.5 ms at 1.98 GHz), longer
# than the host takes to launch the fused kernel from Python
WARM_SPIN_CYCLES = 1_000_000
# the committed H100 model's median |relative error| of the warm prediction
# over the sweep, over the held-out operators of phases 15, 21 and 22, and
# over the permutation gathers
COST_MEDIAN_TOL = 0.20


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


def warm_ms(torch, fn, x, reps=20):
    """Median ms of one ``fn()`` launch, timed with CUDA events, each right
    after x is rewritten from a copy (no L2 flush: what of x and of the
    operator the L2 holds stays there, as in a training step).  A spin of
    ``WARM_SPIN_CYCLES`` on the card between the copy and the first event
    keeps the host's launch time out of the measurement, as the queue of a
    step does (the spin touches no memory)."""
    src = x.clone()
    fn()
    times = []
    for _ in range(reps):
        x.copy_(src)
        torch.cuda._sleep(WARM_SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cost_point(torch, report, half, f, label, held_out):
    """One point of the cost model: the fused kernel on ``half`` at width
    ``f``, warm and cold; logs the half's layout once (``cost-shape``) and
    the point (``cost-point``), the lines tools/fit_kernel_costs.py reads,
    and enters both into the run's record.  The model prices every f32
    tile dense (its f32 constants predate the walked tiles), so a half
    with walked tiles is timed with its lists emptied, every tile dense;
    the half as built is timed beside it (``walked_warm_ms``,
    ``walked_cold_ms``), the points a refit for the walked path reads."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    if label not in report["cost_shapes"]:
        tiles, rems = half.row_block_layout()
        report["cost_shapes"][label] = (tiles, rems)
        log("cost-shape " + json.dumps({"label": label,
                                        "tiles": tiles.tolist(),
                                        "rems": rems.tolist()}))
    x = torch.randn(half.num_cols, f, device="cuda").to(half.blocks.dtype)
    dense = half
    if half.num_walked:
        dense = dataclasses.replace(
            half, walk_ptr=torch.zeros_like(half.walk_ptr), num_walked=0)

    def run(h=dense):
        bcsr.hybrid_spmm(h, x)

    c = COST_SWEEP
    point = {"shape": label,
             "dtype": "bf16" if half.blocks.dtype == torch.bfloat16
             else "f32",
             "f": f, "warm_ms": warm_ms(torch, run, x, c["warm_reps"]),
             "cold_ms": cold_ms(torch, run, c["cold_reps"]),
             "held_out": held_out}
    if half.num_walked:
        point.update(walked_warm_ms=warm_ms(torch, lambda: run(half), x,
                                            c["warm_reps"]),
                     walked_cold_ms=cold_ms(torch, lambda: run(half),
                                            c["cold_reps"]))
    log("cost-point " + json.dumps(point))
    report["cost_points"].append(point)
    return point


@contextlib.contextmanager
def default_costs(costs):
    """Builds inside price their layout decisions by ``costs``."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    saved = bcsr.DEFAULT_COSTS
    bcsr.DEFAULT_COSTS = costs
    try:
        yield
    finally:
        bcsr.DEFAULT_COSTS = saved


def host_edges(graph):
    """(senders, receivers) of ``graph``'s real edges, numpy."""
    e = graph.num_edges
    s_all, r_all, _ = graph.host_edges()
    return np.asarray(s_all)[:e], np.asarray(r_all)[:e]


def thetas(s, r, n, dtype, expected_f):
    """``min_block_edges="auto"``'s θ for the operator of edges s -> r
    under each cost model: {model name: θ}."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    return {costs.name: bcsr.tune_min_block_edges(
        r, s, n, dtype=dtype, expected_f=expected_f, costs=costs)
        for costs in (bcsr.TPU_V5E, bcsr.H100)}


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
    from pytorch_geometric_temporal_tpu_torch import csrc

    return csrc.declare(ctypes.CDLL(str(out)), ("pgtt_hybrid_spmm",))


def hybrid_with(torch, lib, half, x):
    """The fused kernel of another build ``lib`` on (half, x), with the
    arguments ``bcsr.hybrid_spmm`` passes (``bcsr.hybrid_args``); no launch
    is counted."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    out = torch.empty((half.num_rows, x.shape[1]), dtype=torch.float32,
                      device="cuda")
    rc = lib.pgtt_hybrid_spmm(*bcsr.hybrid_args(half, x, out),
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
    c = REMAINDER_CASE
    ei_r, w_r = banded_graph(np.random.default_rng(c["seed"]), c["n"],
                             c["e"], c["band"])
    graphs["remainder-large"] = (
        Graph.from_edge_index(ei_r, w_r, num_nodes=c["n"]), 10**6)
    graphs["hub"] = (hub_graph(Graph), 10**6)
    graphs["ragged-remainder"] = (whole, 10**6)
    worst = 0.0
    for name, (g, mbe) in graphs.items():
        for dtype in (torch.float32, torch.bfloat16):
            mat = BCSRMatrix.from_graph(g, dtype=dtype, min_block_edges=mbe)
            for side in ("fwd", "bwd"):
                half = getattr(mat, side)
                for f in KERNEL_CASE_FS:
                    x = torch.randn(half.num_cols, f, device="cuda")
                    x = x.to(dtype)
                    if name == "ragged-remainder":
                        x = unaligned(torch, x)
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
    if digest != PHASE2_F32_DIGEST:
        raise SystemExit(f"phase 2: the f32 digest {digest} is not "
                         f"{PHASE2_F32_DIGEST}: a sum's order changed")


def hub_graph(Graph):
    """``HUB_CASE``'s graph: a banded graph and one row that receives
    ``hub_edges`` edges from random senders."""
    c = HUB_CASE
    rng = np.random.default_rng(c["seed"])
    ei, w = banded_graph(rng, c["n"], c["e"], band=40)
    hub_s = rng.integers(0, c["n"], c["hub_edges"])
    ei = np.concatenate([ei, np.stack([hub_s, np.full_like(hub_s, c["hub"])])],
                        1)
    w = np.concatenate([w, rng.uniform(0.1, 1.0, c["hub_edges"]).astype(
        np.float32)])
    return Graph.from_edge_index(ei, w, num_nodes=c["n"])


def unaligned(torch, x):
    """A contiguous copy of x whose rows start one element past a 16-byte
    boundary, so that no kernel can read it in 16-byte units."""
    n, f = x.shape
    buf = torch.empty(n * f + 8, dtype=x.dtype, device=x.device)
    out = buf[1:1 + n * f].view(n, f)
    out.copy_(x)
    assert out.data_ptr() % 16
    return out


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


def need_bound(torch, rows, cols, num_rows, f, s_val, s_x, dt):
    """The bound of ``out = A @ x`` from what the function needs, whatever
    the stored format: each nonzero once (its value in the operator's type
    and a 4 B column), the row pointers, the x rows some nonzero references,
    the f32 output written once; 2 operations a nonzero and feature at the
    operator's type.  Returns (bound, what binds, bytes, operations)."""
    nnz = int(rows.numel())
    x_rows = int(torch.unique(cols).numel()) if nnz else 0
    n_bytes = (nnz * (s_val + 4) + (num_rows + 1) * 4 + x_rows * f * s_x
               + num_rows * f * 4)
    ops = 2 * nnz * f
    bound, by = bound_of(n_bytes, {dt: ops})
    return bound, by, n_bytes, ops


def fused_report(torch, half, x):
    """The fused kernel on (half, x): error against its plain version, cold
    time, the plain version's and ``torch.sparse.mm``'s over the whole half
    as one CSR in the tiles' type, and two bounds.  ``bound_ms`` is the
    function's (:func:`need_bound` over the tiles' nonzeros and the
    remainder edges).  ``tile_bound_ms`` is that of the stored format: the
    tiles and their pointers, the x rows of the referenced column blocks and
    of the remainder columns (a union), 8 B per remainder edge, the row
    pointers and the f32 output once; the tile products at the tiles' type,
    the remainder's at f32."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    f = x.shape[1]
    dt = "bf16" if half.blocks.dtype == torch.bfloat16 else "f32"
    s_t, s_x = half.blocks.element_size(), x.element_size()
    nb = half.num_rows // 128
    x_used = torch.zeros(half.num_cols, dtype=torch.bool, device="cuda")
    x_used.view(nb, 128)[half.block_cols.long()] = True
    x_used[half.rem_row_cols.long()] = True
    tile_bytes = (half.nnzb * 128 * 128 * s_t + (nb + 1 + half.nnzb) * 4
                  + int(x_used.sum()) * f * s_x + half.num_rem * 8
                  + (half.num_rows + 1) * 4 + half.num_rows * f * 4)
    tile_ops = {dt: 2 * half.nnzb * 128 * 128 * f}
    tile_ops["f32"] = tile_ops.get("f32", 0) + 2 * half.num_rem * f
    tile_bound, tile_by = bound_of(tile_bytes, tile_ops)
    rows, cols, vals = tile_operator_coo(torch, half)
    all_rows = torch.cat([rows, half.rem_rows])
    all_cols = torch.cat([cols, half.rem_cols.long()])
    bound, by, n_bytes, ops = need_bound(torch, all_rows, all_cols,
                                         half.num_rows, f, s_t, s_x, dt)
    whole_csr = _csr_of(
        torch, all_rows, all_cols,
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
        "bound_ms": bound, "bound_by": by, "bytes": n_bytes, "ops": ops,
        "nnz": int(all_rows.numel()),
        "tile_bound_ms": tile_bound, "tile_bound_by": tile_by,
        "tile_bytes": tile_bytes, "tile_ops": sum(tile_ops.values()),
        "max_abs_err": err, "dtype": dt,
    }


def log_kernel(name, k):
    tile = ""
    if "tile_bound_ms" in k:
        tile = (f"; the stored tiles' bound {k['tile_bound_ms']:.4f} ms "
                f"({k['tile_bound_by']}, {k['tile_bytes']} B, "
                f"{k['tile_ops']} flop; share "
                f"{k['tile_bound_ms'] / k['ms']:.3f})")
    log(f"  {name}: {k['ms']:.4f} ms  bound {k['bound_ms']:.4f} ms "
        f"({k['bound_by']}, {k['bytes']} B, {k['ops']} flop; share "
        f"{k['bound_ms'] / k['ms']:.3f}){tile}  plain {k['plain_ms']:.4f} ms  "
        f"torch.sparse.mm ({k['dtype']} CSR) {k['library_ms']:.4f} ms")


def report_fused(torch, kernel_report, half, f, label):
    """:func:`fused_report` at width ``f`` on ``half``, logged with the
    half's item list, and entered into the run's record as the path
    ``label``."""
    x = torch.randn(half.num_cols, f, device="cuda").to(half.blocks.dtype)
    k = fused_report(torch, half, x)
    log_kernel(f"fused hybrid_spmm F={f}", k)
    log(f"    fused / torch.sparse.mm {k['ms'] / k['library_ms']:.3f}; "
        f"err {k['max_abs_err']:.2e}; nnzb={half.nnzb} rem={half.num_rem}: "
        f"{half.num_block_items} row-block items + "
        f"{half.items.shape[0] - half.num_block_items} remainder-only tasks")
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

    # K1: its function over the tiles' nonzeros (need_bound); the stored
    # format's bound second: the tiles, the x column blocks they reference,
    # the f32 output
    rows, cols, vals = tile_operator_coo(torch, half)
    k1_bound, k1_by, k1_bytes, k1_ops = need_bound(
        torch, rows, cols, half.num_rows, f, s_t, s_x, dt)
    ucols = int(torch.unique(half.block_cols).numel())
    k1_tile_bytes = (half.nnzb * 128 * 128 * s_t + ucols * 128 * f * s_x
                     + half.num_rows * f * 4 + (nb + 1 + half.nnzb) * 4)
    k1_tile_ops = 2 * half.nnzb * 128 * 128 * f
    k1_tile_bound, k1_tile_by = bound_of(k1_tile_bytes, {dt: k1_tile_ops})
    tiles_csr = _csr_of(torch, rows, cols, vals, shape)
    k1 = {
        "ms": cold_ms(torch, lambda: bcsr.tile_spmm(half, x)),
        "plain_ms": cold_ms(torch, lambda: bcsr.tile_spmm_plain(half, x)),
        "library_ms": cold_ms(torch,
                              lambda: torch.sparse.mm(tiles_csr, x)),
        "bound_ms": k1_bound, "bound_by": k1_by,
        "bytes": k1_bytes, "ops": k1_ops,
        "tile_bound_ms": k1_tile_bound, "tile_bound_by": k1_tile_by,
        "tile_bytes": k1_tile_bytes, "tile_ops": k1_tile_ops,
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
    log(f"  fused counts {h['nnz']} nonzeros; K1 then K2 as a pair "
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
    check_captures(trainer, 1, "the train step")
    # phase 16 trains the same model and operators in bf16 compute
    kernel_report["slice"] = dict(ops=ops, ops_seg=ops_seg, x=x, y=y,
                                  busy_ms=busy, step_ms=med * 1e3)


def device_time_by_kernel(torch, fn, n, op_totals=None):
    """({kernel name: (device us, count)}, wall us) over ``n`` calls of
    ``fn`` under torch.profiler: device-side kernels and copies only.
    ``op_totals`` ({host op name: 0.0}) receives the device us of the
    kernels each named host op launched, its children's included.

    The profiler can lose records of a CUDA graph's replay (one in a window
    of ~100 as a rule, a quarter of them once; profiling the window again
    did not recover them): a window whose fused-kernel records fall short
    of the fused launches counted in it logs the shortfall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    torch.cuda.synchronize()
    launched = bcsr.hybrid_spmm.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launched = bcsr.hybrid_spmm.launches - launched
    agg, totals = {}, dict.fromkeys(op_totals or (), 0.0)
    for ev in prof.events():
        if ev.name in totals:
            totals[ev.name] += ev.device_time_total
        # GPU user annotations (the optimizer's range) overlap the
        # kernels and are left out
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and not ev.name.startswith("Optimizer.")):
            us, cnt = agg.get(ev.name, (0.0, 0))
            agg[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    fused = sum(cnt for name, (_, cnt) in agg.items()
                if FUSED_KERNEL.search(name))
    if fused < launched:
        log(f"  profile: {fused} fused-kernel records of {launched} fused "
            f"launches in the window (busy reads short by the lost "
            f"records)")
    if op_totals is not None:
        op_totals.update(totals)
    return agg, wall_us


def profile_steps(torch, step, step_ms, n=2, top=12, unit="step",
                  agg_out=None, op_totals=None):
    """Device time by kernel over ``n`` training steps, and the device's
    busy share of the unprofiled median step ``step_ms`` (one stream, so
    kernel times do not overlap).  Returns the busy ms per step, None if
    no device time was recorded; ``agg_out`` (a dict) receives the device
    time by kernel, {name: (us over the n steps, count)}, and
    ``op_totals`` what :func:`device_time_by_kernel` gives it."""
    agg, wall_us = device_time_by_kernel(torch, step, n, op_totals)
    if agg_out is not None:
        agg_out.update(agg)
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


def predicted_captures(calls):
    """The CUDA graphs a capturing trainer holds after ``calls``, the
    signatures of its step calls in order: the first call of a signature
    runs eagerly and the second captures, so one graph for each signature
    called twice or more."""
    counts = {}
    for sig in calls:
        counts[sig] = counts.get(sig, 0) + 1
    return sum(1 for n in counts.values() if n >= 2)


def check_captures(trainer, want, what):
    """Log ``trainer``'s CUDA graphs and replays; fail unless it captured
    ``want`` graphs (its steps ran as replays)."""
    log(f"  {what}: {trainer.captures} CUDA graphs captured (predicted "
        f"{want}), {trainer.replays} replays")
    if not trainer.capture or trainer.captures != want:
        raise SystemExit(f"{what}: {trainer.captures} CUDA graphs captured, "
                         f"predicted {want}")


def batch_sizes(loader):
    """The batch sizes an ``IndexLoader`` (one rank, the last batch
    kept) yields an epoch, in order."""
    n, bs = len(loader.indices), loader.batch_size
    return [bs] * (n // bs) + ([n % bs] if n % bs else [])


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
    return dict(zip(("H", "K1", "K2"), bcsr.launch_counts()))


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
    busy = profile_steps(torch, lambda: trainer.train_epoch(signal, None),
                         med * 1e3, unit="epoch")
    check_captures(trainer, 1, "the train epoch")
    return busy


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
    # phase 24 trains this path again, eager and captured
    kernel_report["cheb"] = dict(op=op, signal=signal)

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
                              min_block_edges="auto")
        for g in graphs])
    sizes = [operator_bytes(m) for m in stacked]
    log("  min_block_edges='auto' θ at F=64 under each cost model "
        "(ops/bcsr.py: TPU_V5E, H100; the build used H100): "
        + "; ".join(f"t={t} {thetas(*host_edges(g), n, torch.bfloat16, f)}"
                    for t, g in enumerate(graphs)))
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


def phase_protocols(torch, smi):
    """The eight bundled-data accuracy protocols at their full epoch
    counts, captured; then the two full-sequence runs eager and captured."""
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
            f"{100 * (run.test_mse - record) / record:+.1f}%); "
            f"{run.captures} CUDA graph, {run.replays} replays")
        if not (len(run.losses) == epochs and all(np.isfinite(run.losses))
                and np.isfinite(run.test_mse)):
            raise SystemExit(f"{name}: non-finite loss")
        if not run.losses[-1] < run.losses[0]:
            raise SystemExit(f"{name}: the training loss did not fall")
        # the first epoch eager, the second captured, the rest replayed;
        # the test pass is one call, a signature's first: eager
        if (run.captures, run.replays) != (1, epochs - 1):
            raise SystemExit(f"{name}: {run.captures} CUDA graphs, "
                             f"{run.replays} replays (predicted 1, "
                             f"{epochs - 1})")
    if any(launch_counts(bcsr).values()):
        raise SystemExit("a bundled protocol launched a BCSR kernel")
    log("  no BCSR kernel launched (expected: small graphs, dense branch)")

    for name in ("twittertennis_evolvegcno", "twittertennis_evolvegcnh"):
        def run(capture, epochs, name=name):
            r = RUNS[name](epochs, capture=capture)
            return dict(values=r.losses + [r.test_mse],
                        tensors=[p.detach().clone()
                                 for p in r.model.parameters()],
                        captures=r.captures, replays=r.replays,
                        train_s=r.seconds)

        loop_eager_and_captured(torch, f"{name} (the full-sequence update, "
                                f"BatchTrainer)", run, PROTOCOLS[name][0],
                                smi)


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
        bcsr, host_gcn_norm, stack_bcsr_gcn, stack_graphs)
    from pytorch_geometric_temporal_tpu_torch.train import mse

    c = DYNAMIC
    n, T, f = c["n"], c["t"], EVOLVE["f"]
    rng = np.random.default_rng(c["seed"])
    t0 = time.perf_counter()
    graphs = dynamic_graphs(rng)
    stacked = stack_bcsr_gcn(graphs, dtype=torch.bfloat16)
    dynamic = stack_graphs(graphs)
    log("  min_block_edges='auto' θ of the GCN operators at "
        "stack_bcsr_gcn's expected_f 64 under each cost model (ops/bcsr.py:"
        " TPU_V5E, H100; the build used H100): " + "; ".join(
            f"t={t} " + str(thetas(*host_edges(host_gcn_norm(g)), n,
                                   torch.bfloat16, 64))
            for t, g in enumerate(graphs)))
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
    inside the block: ``builds.calls``, and the host seconds of each,
    ``builds.seconds``."""
    from pytorch_geometric_temporal_tpu_torch.ops.bcsr import BCSRMatrix

    inner = BCSRMatrix.from_graph

    class Builds:
        calls = 0
        seconds = []

    def counted(*a, **kw):
        Builds.calls += 1
        t0 = time.perf_counter()
        mat = inner(*a, **kw)
        Builds.seconds.append(time.perf_counter() - t0)
        return mat

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
        _, schedule, test_idx = metrla_protocol._split(
            c["epochs"], 0, c["t_len"], c["n"])
        # one train graph and one test graph: drop-last batches of one shape
        calls = (c["epochs"] * (len(schedule[0]) // c["batch_size"]),
                 len(test_idx) // c["batch_size"])
        log(f"  {label} ({rec['source']}): N={c['n']}, {c['t_len']} steps, "
            f"{c['epochs']} epochs of batches of {c['batch_size']} in "
            f"{rec['seconds']:.2f} s ({rec['seconds'] / c['epochs']:.4f} s "
            f"per epoch, host clock, test pass included) on {smi}; "
            f"{rec['cuda_graphs']} CUDA graphs, {rec['replays']} replays of "
            f"{calls[0]} train and {calls[1]} test steps")
        log(f"    training curve (last batch of each epoch, masked MAE, mph) "
            f"{curve}; de-normalized masked test MAE {mae:.4f}")
        if not (len(curve) == c["epochs"] and all(np.isfinite(curve))
                and np.isfinite(mae)):
            raise SystemExit(f"METR-LA: non-finite loss {curve}, {mae}")
        if c is METRLA and not curve[-1] < curve[0]:
            raise SystemExit("METR-LA: the training curve did not fall")
        if (rec["cuda_graphs"], rec["replays"]) != (2, sum(calls) - 2):
            raise SystemExit(f"METR-LA: {rec['cuda_graphs']} CUDA graphs, "
                             f"{rec['replays']} replays (predicted 2, "
                             f"{sum(calls) - 2})")
    log(f"    beside the JAX package's records at that configuration: "
        f"{METRLA_RECORD_TPU} on a TPU v5e, {METRLA_RECORD_TORCH_CPU} for "
        f"its torch-CPU twin, both from another initial draw "
        f"({100 * (mae - METRLA_RECORD_TPU) / METRLA_RECORD_TPU:+.2f}%)")
    if any(launch_counts(bcsr).values()):
        raise SystemExit("the METR-LA protocol launched a BCSR kernel")

    c = METRLA
    series, schedule, test_idx = metrla_protocol._split(
        c["epochs"], 0, c["t_len"], c["n"])

    def run(capture, epochs):
        mae, curve, tr = metrla_protocol._train(
            *series[:5], schedule[:epochs], test_idx, c["batch_size"],
            c["K"], "cuda", None, 0, capture)
        return dict(values=curve + [mae],
                    tensors=[p.detach().clone() for p in tr.model.parameters()],
                    captures=tr.captures, replays=tr.replays, keep=tr)

    loop_eager_and_captured(torch, "METR-LA at full size (BatchTrainer)", run,
                            c["epochs"], smi, profiled=(1, 2))


def adam_steps(torch, model, forward, x, y, steps, capture=None,
               generators=(), before_step=lambda: None):
    """``steps`` updates of ``model`` through ``BatchTrainer`` (MSE, Adam
    1e-3; captured unless ``capture=False``; ``generators`` go to the
    trainer, ``before_step`` runs before each); returns (losses,
    trainer)."""
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer, mse

    trainer = BatchTrainer(model, forward, lr=1e-3, loss_fn=mse,
                           capture=capture, generators=generators)
    losses = []
    for _ in range(steps):
        before_step()
        losses.append(float(trainer.train_step(x, y)))
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

    def three_steps(name, model, forward, xs, ys, has_stats=True, **kw):
        before = {k: v.clone() for k, v in model.named_buffers()}
        t0 = time.perf_counter()
        losses, trainer = adam_steps(torch, model, forward, xs, ys, 3, **kw)
        torch.cuda.synchronize()
        log(f"  {name}: MSE {['%.5f' % v for v in losses]} in train mode, "
            f"{sum(p.numel() for p in model.parameters())} parameters, "
            f"{time.perf_counter() - t0:.2f} s for three steps, the first "
            f"included; {trainer.captures} CUDA graph(s), "
            f"{trainer.replays} replays")
        if has_stats and not moved(model, before):
            raise SystemExit(f"{name}: the batch statistics did not move")
        if (trainer.captures, trainer.replays) != (1, 2):
            raise SystemExit(f"{name}: {trainer.captures} CUDA graphs, "
                             f"{trainer.replays} replays (predicted 1, 2)")

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
    # MTGNN: 3 layers, conv/residual 32, skip 64, end 128, subgraph 20.
    # The same dropout mask every step, drawn on the card from a generator
    # made once, handed to the trainer (each graph registers it) and
    # reseeded before each step
    def mtgnn(seed):
        return MTGNN(True, True, 2, n, [2, 3, 6, 7], 7, 0.3, 20, 40, 1, 32,
                     32, 64, 128, t, 2, 12, 3, 0.05, 3.0, True,
                     generator=torch.Generator().manual_seed(seed))

    m, mask_gen = mtgnn(12), torch.Generator(device="cuda")
    xm, ym = cuda(b, 2, n, t), cuda(b, 12, n, 1)
    three_steps("MTGNN(3 layers, 32/32/64/128)", m,
                lambda xb: m(xb, train=True, generator=mask_gen), xm, ym,
                has_stats=False, generators=(mask_gen,),
                before_step=lambda: mask_gen.manual_seed(MTGNN_MASK_SEED))
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
    mtgnn_eager_and_captured(torch, mtgnn, xm, ym, smi)


def mtgnn_eager_and_captured(torch, mtgnn, x, y, smi):
    """Phase 12's MTGNN step eager and captured as phase 24 runs its
    paths, then equal to the bit.  cuDNN's default convolution backward is
    not deterministic (two eager runs differ in the last bits), so both
    runs take its deterministic algorithms."""
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer, mse

    def make(capture):
        model, gen = mtgnn(12), torch.Generator(device="cuda")
        trainer = BatchTrainer(
            model, lambda xb: model(xb, train=True, generator=gen), lr=1e-3,
            loss_fn=mse, capture=capture, generators=(gen,))
        trainer.mask_gen = gen
        return trainer, model

    def call(trainer, i):
        trainer.mask_gen.manual_seed(MTGNN_MASK_SEED)
        return trainer.train_step(x, y)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res = eager_and_captured(torch, "phase 12's MTGNN step (dropout from "
                                 "a registered generator)", make, call, 0,
                                 "step", smi)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    e, c = res["eager"], res["captured"]
    bits = bool(torch.equal(e["losses"], c["losses"])) and all(
        torch.equal(a, b) for a, b in zip(e["params"], c["params"]))
    log(f"  MTGNN: captured against eager, losses and parameters equal to "
        f"the bit {bits}")
    if not bits:
        raise SystemExit("MTGNN: the captured steps differ from the eager "
                         "ones")


def outputs_and_param_grads(torch, model, forward, y):
    from pytorch_geometric_temporal_tpu_torch.train import mse

    out = forward()
    grads = torch.autograd.grad(mse(out, y), list(model.parameters()))
    return out.detach(), grads


def compare_with_segment(torch, name, model, got, want, fwd_tol, grad_tol,
                         grad_l2_tol, against="the f32 segment path"):
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
    log(f"  vs {against}: forward max abs err {fwd_err:.3e} "
        f"(outputs up to {scale:.3f}; tol {fwd_tol}); parameter gradients: "
        f"max abs err over the gradient's largest entry {rel[w_rel]:.3e} at "
        f"{w_rel} (tol {grad_tol}), 2-norm of the error over the "
        f"gradient's {l2[w_l2]:.3e} at {w_l2} (tol {grad_l2_tol})")
    if not (fwd_err <= fwd_tol and rel[w_rel] <= grad_tol
            and l2[w_l2] <= grad_l2_tol):
        raise SystemExit(f"{name} over BCSR does not match {against}")


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
    from pytorch_geometric_temporal_tpu_torch import _counters, config_override
    from pytorch_geometric_temporal_tpu_torch.models import ASTGCN
    from pytorch_geometric_temporal_tpu_torch.models.attention import astgcn
    from pytorch_geometric_temporal_tpu_torch.ops import (Graph, bcsr,
                                                          weighted_hop)
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
        f"messages in block 2 (the plain version's; the card's kernel forms "
        f"none): T*E*F*4 B = {T * e_lhat * c['filters'] * 4 / 2**30:.2f} "
        f"GiB, formed "
        f"{max(1, weighted_hop._MESSAGE_CHUNK // (e_lhat * c['filters']))}"
        f" steps at a time")

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
    losses, step_s, counts, hops, tails = [], [], [], [], []
    with counted_builds() as builds:
        bcsr.reset_launch_counts()
        before = _counters.read()

        def hop_counts():
            # (forward launches, backward launches, hop 1's message bytes)
            d = _counters.counted_since(before)
            return d["weighted_hop"][:2] + d["astgcn_hop1"][1:]

        def tail_counts():
            # (forward launches, backward launches, bytes copied into rows)
            return _counters.counted_since(before)["block_tail"]

        with torch.no_grad():
            model(x, g)
        counts.append((builds.calls, launch_counts(bcsr)["H"]))
        hops.append(hop_counts())
        tails.append(tail_counts())
        for _ in range(c["steps"]):
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(x, y)))
            step_s.append(time.perf_counter() - t0)
            counts.append((builds.calls, launch_counts(bcsr)["H"]))
            hops.append(hop_counts())
            tails.append(tail_counts())
        launches = launch_counts(bcsr)
        copied = _counters.counted_since(before)["weighted_hop"][2]
    fwd = c["blocks"] * (K - 2)
    want = [(1, fwd)] + [(1, fwd + per_step * (i + 1))
                         for i in range(c["steps"])]
    log(f"  (operator builds, fused launches) after the first forward and "
        f"after each step: {counts} (expected {want}: one build in all, "
        f"{fwd} launches a forward, {per_step} a step), K1 "
        f"{launches['K1']} and K2 {launches['K2']} (expected 0)")
    if counts != want or launches["K1"] or launches["K2"]:
        raise SystemExit("edge-mode ASTGCN: build or launch counts differ")
    blocks = c["blocks"]
    want_hops = [(blocks * (1 + i), blocks * i, 0)
                 for i in range(c["steps"] + 1)]
    log(f"  hop-1 kernel (forward launches, backward launches, bytes of "
        f"per-edge messages) after the first forward and after each step: "
        f"{hops} (expected {want_hops}: {blocks} launches a forward, "
        f"{2 * blocks} a step, no message); {copied} bytes copied into "
        f"dense rows")
    if hops != want_hops:
        raise SystemExit("edge-mode ASTGCN: hop 1 skipped its kernel or "
                         "formed messages")
    kernel_report["WH"] = {"launches": sum(hops[-1][:2]),
                           "max_abs_err": 0.0}
    # the block tail's kernel once a block each way; block 1's input, the
    # (B, N, F, T) data, copied into (B, T, N, F) rows once a forward
    rows = x.numel() * x.element_size()
    want_tails = [(blocks * (1 + i), blocks * i, rows * (1 + i))
                  for i in range(c["steps"] + 1)]
    log(f"  block-tail kernel (forward launches, backward launches, bytes "
        f"copied into rows) after the first forward and after each step: "
        f"{tails} (expected {want_tails})")
    if tails != want_tails:
        raise SystemExit("edge-mode ASTGCN: the block tail skipped its "
                         "kernel or copied more than block 1's input")
    kernel_report["BT"] = {"launches": sum(tails[-1][:2]),
                           "max_abs_err": 0.0}
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



def hop_outputs(wh, rev, csrs, x, w, g):
    """(out, g_x, g_w) of the hop-1 kernel."""
    return (wh.weighted_hop_forward(x, w, csrs[0], rev.num_nodes),
            *wh.weighted_hop_backward(g, x, w, csrs[1], True, True))


def hop_plain(wh, rev, x, w, g):
    """(out, g_x, g_w) of hop 1's plain version."""
    args = (rev.senders, rev.receivers)
    return (wh.plain_forward(x, w, *args, rev.num_nodes)[0],
            *wh.plain_backward(g, x, w, *args, True, True)[:2])


def phase_weighted_hop(torch, report, smi):
    from pytorch_geometric_temporal_tpu_torch.models.attention import astgcn
    from pytorch_geometric_temporal_tpu_torch.ops import Graph
    from pytorch_geometric_temporal_tpu_torch.ops import weighted_hop as wh

    c, h = PEMS, HOP
    ei, w0 = pems_graph(c)
    g0 = Graph.from_edge_index(ei, w0, num_nodes=c["n"])
    rev = astgcn._reversed(astgcn._lhat_graph(g0, "sym"))
    csrs = wh.hop_csrs(rev)
    n, e, b, t = c["n"], rev.senders.shape[0], h["b"], h["t"]
    deg = max(int(k.ptr.diff().max()) for k in csrs)
    log(f"  reversed L-hat of the PeMS stand-in: N={n}, {e} entries, at "
        f"most {deg} a row either way; B={b}, T={t}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = report["WH"]
    lines = []
    for f in h["fs"]:
        p = t * f
        # T_0 as each block makes it: (B, T, N, F) from the windows in
        # block 1, (B, F, N, T) from block 1's convolutions in block 2
        x = (torch.randn(b, t, n, f, device="cuda", generator=gen)
             if f == 2 else torch.randn(b, f, n, t, device="cuda",
                                        generator=gen).permute(0, 3, 2, 1))
        w = torch.randn(b, e, device="cuda", generator=gen)
        g = torch.randn(n, b, t, f, device="cuda", generator=gen).permute(
            1, 2, 0, 3)                       # as the consumers give it
        got = hop_outputs(wh, rev, csrs, x, w, g)
        want = hop_plain(wh, rev, x, w, g)
        mags = hop_plain(wh, rev, x.abs(), w.abs(), g.abs())
        again = hop_outputs(wh, rev, csrs, x, w, g)
        # two f32 sums of m products in other orders differ by at most
        # 2·m·2^-24 of the sum of the products' magnitudes
        ratios = []
        for a, want_a, mag, terms in zip(got, want, mags, (deg, deg, p)):
            bound = 2 * terms * 2.0 ** -24 * mag
            ratios.append(float(((a - want_a).abs() / bound.clamp_min(
                1e-30)).max()))
            k["max_abs_err"] = max(k["max_abs_err"],
                                   float((a - want_a).abs().max()))
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        log(f"  F={f} (P={p}): error over the sum-order bound, out / g_x / "
            f"g_w: {', '.join(f'{r:.3g}' for r in ratios)} (at most 1); "
            f"two runs equal to the bit: {same}; dense rows: x "
            f"{wh.dense_rows(x)}, out {wh.dense_rows(got[0])}, g "
            f"{wh.dense_rows(g)}")
        if max(ratios) > 1 or not same:
            raise SystemExit("the hop-1 kernel differs from its plain "
                             "version or from its own second run")
        del got, want, mags, again
        # the forward copies T_0 into dense rows (timed with it, counted);
        # the backward reads the rows the forward saved
        fwd = cold_ms(torch, lambda: wh.weighted_hop_forward(
            x, w, csrs[0], n), reps=h["reps"])
        rows = wh.as_rows(x)
        copy = cold_ms(torch, lambda: wh.as_rows(x), reps=h["reps"])
        bwd = cold_ms(torch, lambda: wh.weighted_hop_backward(
            g, rows, w, csrs[1], True, True), reps=h["reps"])
        args = (rev.senders, rev.receivers)
        plain_fwd = cold_ms(torch, lambda: wh.plain_forward(
            x, w, *args, n), reps=h["plain_reps"])
        plain_bwd = cold_ms(torch, lambda: wh.plain_backward(
            g, x, w, *args, True, True), reps=h["plain_reps"])
        index = 4 * (n + 1 + 2 * e)
        fwd_b = 4 * (2 * b * n * p + b * e) + index
        bwd_b = 4 * (3 * b * n * p + 2 * b * e) + index
        fwd_bound = fwd_b / H100_BYTES_PER_S * 1e3
        bwd_bound = bwd_b / H100_BYTES_PER_S * 1e3
        lines.append((f, fwd + bwd, fwd_bound + bwd_bound,
                      plain_fwd + plain_bwd))
        log(f"  F={f}: kernel forward {fwd:.4f} ms with T_0's copy into "
            f"dense rows ({copy:.4f} ms of it; bound {fwd_bound:.4f}, "
            f"{fwd_b / 1e6:.1f} MB, share {fwd_bound / fwd:.3f}), backward "
            f"{bwd:.4f} ms (bound {bwd_bound:.4f}, {bwd_b / 1e6:.1f} MB, "
            f"share {bwd_bound / bwd:.3f}); plain forward {plain_fwd:.3f} "
            f"ms, backward {plain_bwd:.3f} ms; cold L2, on {smi}")
        del x, w, g, rows
    ms, bound, plain = (sum(r[i] for r in lines) for i in (1, 2, 3))
    log(f"  hop 1 a train step (both blocks, forward and backward): kernel "
        f"{ms:.4f} ms, bound {bound:.4f} ms (share {bound / ms:.3f}), plain "
        f"{plain:.3f} ms")
    k.update(ms=ms, plain_ms=plain, bound_ms=bound, bound_by="bytes",
             library_ms=None)


def phase_block_tail(torch, report, smi):
    import torch.nn.functional as fn

    from pytorch_geometric_temporal_tpu_torch.ops import block_tail as bt

    b, t, n, c = HOP["b"], HOP["t"], PEMS["n"], EDGE["filters"]
    rows, eps = b * t * n, 1e-6
    gen = torch.Generator(device="cuda").manual_seed(0)
    pre = torch.randn(rows, c, device="cuda", generator=gen)
    vecs = [0.3 * torch.randn(c, device="cuda", generator=gen)
            for _ in range(4)]
    vecs[2] += 1.0
    b_t, b_r, gamma, beta = vecs
    # the gradient as each block's consumers leave it: block 2's from the
    # head, each (b, n)'s T·C values together; block 1's contiguous
    grads = {"head": torch.randn(b, n, t, c, device="cuda",
                                 generator=gen).permute(0, 2, 1, 3),
             "contiguous": torch.randn(b, t, n, c, device="cuda",
                                       generator=gen)}
    k = report["BT"]
    log(f"  rows of C={c}: B={b}, T={t}, N={n} ({rows} rows, "
        f"{rows * c * 4 / 1e9:.2f} GB a tensor)")

    def kernel(g):
        y, stats = bt.block_tail_forward(pre, *vecs, eps)
        return (y, stats, *bt.block_tail_backward(g, pre, stats, b_t, b_r,
                                                  gamma, eps))

    def plain(g):
        y, stats = bt.plain_forward(pre, *vecs, eps)
        return (y, stats, *bt.plain_backward(g, pre, stats, b_t, b_r, gamma,
                                             eps))

    for name, g in grads.items():
        got, want, again = kernel(g), plain(g), kernel(g)
        errs = [float((a - w).abs().max() / w.abs().max())
                for a, w in zip(got, want)]
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        k["max_abs_err"] = max(k["max_abs_err"], *(
            float((a - w).abs().max()) for a, w in zip(got, want)))
        log(f"  gradient {name}: kernel against plain, largest error over "
            f"the largest value, y / stats / g_pre / sums: "
            f"{', '.join(f'{e:.2g}' for e in errs)} (at most 1e-5 but the "
            f"sums over {rows} rows, 1e-4); two runs equal to the bit: "
            f"{same}")
        if max(errs[:3]) > 1e-5 or errs[3] > 1e-4 or not same:
            raise SystemExit("the block-tail kernel differs from its plain "
                             "version or from its own second run")
        del got, want, again
    y, stats = bt.block_tail_forward(pre, *vecs, eps)
    fwd = cold_ms(torch, lambda: bt.block_tail_forward(pre, *vecs, eps))
    bwd = {name: cold_ms(torch, lambda g=g: bt.block_tail_backward(
        g, pre, stats, b_t, b_r, gamma, eps)) for name, g in grads.items()}
    plain_fwd = cold_ms(torch, lambda: bt.plain_forward(pre, *vecs, eps),
                        reps=5)
    plain_bwd = cold_ms(torch, lambda: bt.plain_backward(
        grads["head"], pre, stats, b_t, b_r, gamma, eps), reps=5)
    # the one-call yardstick the port never calls: PyTorch's LayerNorm over
    # ReLU(a + b), two conv outputs apart, forward and through autograd
    other = torch.randn(rows, c, device="cuda", generator=gen)
    leaves = [v.clone().requires_grad_(True)
              for v in (pre, other, gamma, beta)]
    g_rows = grads["contiguous"].view(rows, c)

    def yardstick():
        return fn.layer_norm(fn.relu(leaves[0] + leaves[1]), (c,),
                             leaves[2], leaves[3], eps)

    yard_fwd = cold_ms(torch, lambda: yardstick().detach())
    yard_all = cold_ms(torch, lambda: torch.autograd.grad(
        yardstick(), leaves, g_rows), reps=10)
    fwd_b = 4 * (2 * rows * c + 2 * rows)
    bwd_b = 4 * (3 * rows * c + 2 * rows)
    fwd_bound = fwd_b / H100_BYTES_PER_S * 1e3
    bwd_bound = bwd_b / H100_BYTES_PER_S * 1e3
    log(f"  kernel forward {fwd:.4f} ms (bound {fwd_bound:.4f}, "
        f"{fwd_b / 1e6:.1f} MB, share {fwd_bound / fwd:.3f}); backward "
        + ", ".join(f"{bwd[name]:.4f} ms with the gradient {name}"
                    for name in grads)
        + f" (bound {bwd_bound:.4f}, {bwd_b / 1e6:.1f} MB, share "
        f"{bwd_bound / bwd['head']:.3f}); plain forward {plain_fwd:.3f} ms, "
        f"backward {plain_bwd:.3f} ms; yardstick F.layer_norm(F.relu(a + "
        f"b)) forward {yard_fwd:.4f} ms, forward and backward "
        f"{yard_all:.4f} ms; cold L2, on {smi}")
    k.update(ms=fwd + bwd["head"], plain_ms=plain_fwd + plain_bwd,
             bound_ms=fwd_bound + bwd_bound, bound_by="bytes",
             library_ms=yard_all)


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


def pems_zscored(c):
    """The stand-in series z-scored per feature, as data/pems.py does, and
    its means and standard deviations."""
    raw = pems_series(c)
    means = np.mean(raw, axis=(0, 1))
    stds = np.std(raw, axis=(0, 1))
    return (raw - means) / stds, means, stds


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


def first_batch_is_host_windows(train, data, x, y):
    """Whether (x, y) on the card equal the host windows of ``data`` at the
    starts of the first batch ``train`` draws (shuffled, numpy seed 0)."""
    from pytorch_geometric_temporal_tpu_torch.signal import (
        IndexDataset, iter_index_batches)

    first = next(iter_index_batches(train.indices, len(x), shuffle=True,
                                    rng=np.random.default_rng(0),
                                    drop_last=False))
    host = IndexDataset(train.indices, data, x.shape[1])
    pos = np.searchsorted(train.indices, first)
    return (np.array_equal(x.cpu().numpy(), np.stack([host[p][0] for p in pos]))
            and np.array_equal(y.cpu().numpy(),
                               np.stack([host[p][1] for p in pos])))


def one_batch_launches(trainer, x, y, tag):
    """Fused launches of one train and one eval batch of PeMS's DCRNNSeq
    (lags 12, K=2), against the model's count; returns the two counts."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    h, K = PEMS["lags"], PEMS["K"]
    per_train, per_eval = expected_launches(h, K, 1), 2 * h * 2 * (K - 1)
    bcsr.reset_launch_counts()
    trainer.train_step(x, y)
    one_train = launch_counts(bcsr)
    bcsr.reset_launch_counts()
    trainer.eval_step(x, y)
    one_eval = launch_counts(bcsr)
    log(f"  {tag} one train batch: fused {one_train['H']} (expected "
        f"{per_train}); one eval batch: {one_eval['H']} (expected "
        f"{per_eval}); K1 and K2 {one_train['K1'] + one_eval['K1']} and "
        f"{one_train['K2'] + one_eval['K2']} (expected 0)")
    if (one_train, one_eval) != ({"H": per_train, "K1": 0, "K2": 0},
                                 {"H": per_eval, "K1": 0, "K2": 0}):
        raise SystemExit(f"{tag} launch counts of one batch differ")
    return per_train, per_eval


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
        IndexLoader, StreamingWindower, iter_index_batches)
    from pytorch_geometric_temporal_tpu_torch.train import (
        BatchTrainer, ZScoreScaler)

    c = PEMS
    h, bs, K = c["lags"], c["batch_size"], c["K"]
    torch.cuda.reset_peak_memory_stats()
    with counted_builds() as builds, \
            tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data, means, stds = pems_zscored(c)
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
        x0, y0 = next(iter(IndexLoader(train.indices, windower, bs,
                                       shuffle=True)))
        if not first_batch_is_host_windows(train, data, x0, y0):
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
        per_train, per_eval = one_batch_launches(trainer, x0, y0, "(d)")

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
        busy = profile_steps(torch, lambda: trainer.train_step(x0, y0),
                             med * 1e3)

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
        f"one a diffusion direction), host seconds "
        f"{['%.3f' % v for v in builds.seconds]}")
    if builds.calls != 2:
        raise SystemExit("PeMS index path: operator builds differ from 2")
    # the step signatures (train or eval, batch size) in the order called:
    # (d)'s batch, the epochs and the test pass, one more epoch timed, the
    # profile, the epochs device-resident and streamed
    tr_sizes = batch_sizes(train)
    calls = ([("train", bs), ("eval", bs)]
             + c["epochs"] * ([("train", b) for b in tr_sizes]
                              + [("eval", b) for b in batch_sizes(val)])
             + [("eval", b) for b in batch_sizes(test)]
             + 3 * [("train", b) for b in tr_sizes] + 2 * [("train", bs)])
    check_captures(trainer, predicted_captures(calls),
                   "train and eval steps (one graph a batch size)")
    # phase 21 runs the same model on the same graph with scrambled ids;
    # phase 24 runs this path again, eager and captured
    kernel_report["pems"] = dict(curve=curve, test_mae=test_mae,
                                 busy_ms=busy, step_ms=med * 1e3,
                                 build_s=list(builds.seconds), graph=g,
                                 loader=train, scaler=scaler)
    f_hop = bs * 2 * c["f"]
    report_fused(torch, kernel_report, mats[0].fwd, f_hop,
                 "PeMS index DCRNN f32")
    report_fused(torch, kernel_report, mats[0].fwd, 64 * 66,
                 "PeMS DCRNN-64 f32")
    cost_point(torch, kernel_report, mats[0].fwd, f_hop,
               "pems-p15 P_fwd.fwd", held_out=True)
    sweep_f32_tile(torch, kernel_report, mats[0].fwd, f_hop,
                   "PeMS diffusion operator (N=11,160)")
    # the digest tiles the raw graph on the host: the diffusion operators'
    # weights are normalized on the card with atomics, so their last bits
    # may change from run to run
    raw = BCSRMatrix.from_graph(g, dtype=torch.float32).fwd
    digest = f32_digest(torch, [raw], [f_hop], DIGEST_SEED)
    log(f"  f32 digest, the raw PeMS graph's forward half (nnzb={raw.nnzb} "
        f"rem={raw.num_rem}) at F={f_hop}, x from numpy seed {DIGEST_SEED}: "
        f"{digest}")
    if digest != PHASE15_F32_DIGEST:
        raise SystemExit(f"phase 15: the f32 digest {digest} is not "
                         f"{PHASE15_F32_DIGEST}: a sum's order changed")


def eager_and_captured(torch, label, make, call, per_call, unit, smi):
    """One path run eagerly (``capture=False``) and captured, from the same
    parameters on the same inputs: ``make(capture)`` → (trainer, model),
    ``call(trainer, i)`` → the i-th step's loss.  ``CAPTURE["steps"]``
    counted calls (launches, losses, parameters after them), then
    ``CAPTURE["timed"]`` on the host clock and two under the profiler.
    Memory, both ways, above what was held before the trainer was made:
    the peaks allocated and reserved over the run (reserved counts the
    allocator's cache and each graph's private pool), and what the
    trainer still holds after it once the free cache is released
    (parameters and Adam's state; with capture also each graph's pool).
    Returns both runs' numbers."""
    import gc

    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    steps, timed = CAPTURE["steps"], CAPTURE["timed"]
    runs = {}
    for capture in (False, True):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_alloc = torch.cuda.memory_allocated()
        base_reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        trainer, model = make(capture)
        torch.cuda.synchronize()
        bcsr.reset_launch_counts()
        losses = torch.stack([call(trainer, i) for i in range(steps)])
        torch.cuda.synchronize()
        launches = launch_counts(bcsr)
        params = [p.detach().clone() for p in model.parameters()]
        times = []
        for i in range(timed):
            t0 = time.perf_counter()
            call(trainer, steps + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times) * 1e3
        log(f"  {label}, {'captured' if capture else 'eager'}: host "
            f"{unit} median {med:.3f} ms (min {min(times) * 1e3:.3f}, max "
            f"{max(times) * 1e3:.3f}; {timed} {unit}s, synchronized) on "
            f"{smi}")
        busy = profile_steps(torch, lambda: call(trainer, 0), med, top=6,
                             unit=unit)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base_alloc) / 2**30
        peak_reserved = (torch.cuda.max_memory_reserved()
                         - base_reserved) / 2**30
        torch.cuda.empty_cache()
        held = (torch.cuda.memory_reserved() - base_reserved) / 2**30
        runs[capture] = dict(losses=losses, params=params, launches=launches,
                             host_ms=med, busy_ms=busy, peak_gib=peak,
                             peak_reserved_gib=peak_reserved, held_gib=held, captures=trainer.captures,
                             replays=trainer.replays)
        del trainer, model
    e, c = runs[False], runs[True]
    loss_rel = float((c["losses"] - e["losses"]).abs().max()
                     / e["losses"].abs().max())
    param_err = max(float((a - b).abs().max())
                    for a, b in zip(c["params"], e["params"]))
    first_bits = bool(torch.equal(c["losses"][0], e["losses"][0]))
    want = {"H": steps * per_call, "K1": 0, "K2": 0}
    log(f"  {label}: captured against eager after {steps} {unit}s: losses "
        f"max rel err {loss_rel:.3e} (limit {CAPTURE_LOSS_RTOL}), parameters "
        f"max abs err {param_err:.3e} (limit {CAPTURE_PARAM_ATOL}); the "
        f"first {unit}'s loss (eager in both) "
        f"{'bit-equal' if first_bits else 'not bit-equal'}; CUDA graphs "
        f"{c['captures']} (predicted 1), {c['replays']} replays; fused "
        f"launches over the counted {unit}s eager {e['launches']['H']}, "
        f"captured {c['launches']['H']} (expected {want['H']}: {per_call} a "
        f"{unit}), K1/K2 {c['launches']['K1']}/{c['launches']['K2']}")
    log(f"  {label}: memory above the run's start, eager → captured: peak "
        f"allocated {e['peak_gib']:.3f} → {c['peak_gib']:.3f} GiB "
        f"({c['peak_gib'] / e['peak_gib'] - 1:+.1%}), peak reserved "
        f"{e['peak_reserved_gib']:.3f} → {c['peak_reserved_gib']:.3f} GiB "
        f"({c['peak_reserved_gib'] / e['peak_reserved_gib'] - 1:+.1%}), held "
        f"after the run with the free cache released {e['held_gib']:.3f} → "
        f"{c['held_gib']:.3f} GiB; on {smi}")
    for mode, r in (("eager", e), ("captured", c)):
        if r["busy_ms"] is not None:
            log(f"  {label}, {mode}: device busy {r['busy_ms']:.3f} ms a "
                f"{unit}, host {r['host_ms']:.3f} ms, busy share "
                f"{r['busy_ms'] / r['host_ms']:.3f}")
    if e["launches"] != want or c["launches"] != want:
        raise SystemExit(f"{label}: launch counts differ under replay")
    if (e["captures"], c["captures"]) != (0, 1):
        raise SystemExit(f"{label}: CUDA graphs {e['captures']} eager, "
                         f"{c['captures']} captured (predicted 0 and 1)")
    if not (loss_rel <= CAPTURE_LOSS_RTOL and param_err <= CAPTURE_PARAM_ATOL
            and torch.isfinite(c["losses"]).all()):
        raise SystemExit(f"{label}: the captured run differs from the eager "
                         f"one")
    return dict(eager=e, captured=c, loss_rel=loss_rel, param_err=param_err,
                first_bits=first_bits)


def busy_ms(torch, fn):
    """(device busy ms, device records) of one call of ``fn``: the
    device-side kernels, copies and memsets one by one, as
    :func:`device_time_by_kernel` counts them, with the CUDA activity
    alone traced (an eager epoch runs tens of thousands of operations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.events():
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and not ev.name.startswith("Optimizer.")):
            us += ev.time_range.elapsed_us()
            n += 1
    return us / 1e3, n


def timed_s(torch, fn):
    """(host seconds of one call of ``fn``, the device synchronized before
    and after, and its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def loop_eager_and_captured(torch, label, run, epochs, smi,
                            profiled=LOOP["profiled"]):
    """A training loop run eagerly (``capture=False``) and captured (the
    default), from the same parameters on the same schedule.
    ``run(capture, epochs)`` trains from scratch and returns a dict:
    ``values`` (floats: the curve, the test metric), ``tensors`` (the
    trained parameters or state), ``captures``, ``replays``, and
    optionally ``train_s`` (the loop's own host seconds of its epochs, the
    device synchronized, without the loading whose time varies by more
    than a few epochs; else the whole call's) and ``keep`` (an object that
    holds the loop's graphs) or ``held`` (bytes reserved with the free
    cache released, read while they lived); without either, what stays
    reserved after the run is read.  A steady epoch's host time is the
    difference of ``train_s`` between the whole run and a run of
    ``LOOP["short"]`` epochs (the eager one and the capturing one); its
    device busy time the profiled difference of two runs of ``profiled``
    epochs; memory above the run's start as phase 24 reads it.
    Fails unless every value and tensor is equal to the bit.  Returns both
    runs' numbers."""
    import gc

    short, (p0, p1) = LOOP["short"], profiled
    runs = {}
    for capture in (False, None):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_alloc = torch.cuda.memory_allocated()
        base_reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        secs, r = timed_s(torch, lambda: run(capture, epochs))
        r["peak_gib"] = (torch.cuda.max_memory_allocated() - base_alloc) / 2**30
        r["peak_reserved_gib"] = (torch.cuda.max_memory_reserved()
                                  - base_reserved) / 2**30
        if "held" not in r:
            torch.cuda.empty_cache()
            r["held"] = torch.cuda.memory_reserved()
        r["held_gib"] = (r.pop("held") - base_reserved) / 2**30
        r.pop("keep", None)
        secs_short, r_short = timed_s(torch, lambda: run(capture, short))
        t_long, t_short = (x.pop("train_s", t) for x, t in (
            (r, secs), (r_short, secs_short)))
        r["secs"] = secs
        r["host_ms"] = (t_long - t_short) / (epochs - short) * 1e3
        how = (f"({t_long:.3f} s training {epochs} epochs - {t_short:.3f} s "
               f"training {short}) / {epochs - short}, synchronized")
        (b0, n0), (b1, n1) = (busy_ms(torch, lambda e=e: run(capture, e))
                              for e in (p0, p1))
        r["busy_ms"], r["records"] = (b1 - b0) / (p1 - p0), (n1 - n0) // (p1 - p0)
        mode = "eager" if capture is False else "captured"
        log(f"  {label}, {mode}: {epochs} epochs in {secs:.3f} s; a steady "
            f"epoch {r['host_ms']:.3f} ms host ({how}), {r['busy_ms']:.3f} "
            f"ms device busy ({r['records']} device records; profiled "
            f"{p1} - {p0} epochs), busy share "
            f"{r['busy_ms'] / r['host_ms']:.3f}; CUDA graphs "
            f"{r['captures']}, {r['replays']} replays; on {smi}")
        runs[mode] = r
    e, c = runs["eager"], runs["captured"]
    values = e["values"] == c["values"]
    tensors = len(e["tensors"]) == len(c["tensors"]) and all(
        torch.equal(a, b) for a, b in zip(e["tensors"], c["tensors"]))
    log(f"  {label}: captured against eager after {epochs} epochs: "
        f"{len(c['values'])} losses and test metric equal to the bit "
        f"{values}, {len(c['tensors'])} trained tensors equal to the bit "
        f"{tensors}; busy captured / eager "
        f"{c['busy_ms'] / e['busy_ms']:.3f}, host eager / captured "
        f"{e['host_ms'] / c['host_ms']:.2f}x")
    log(f"  {label}: memory above the run's start, eager → captured: peak "
        f"allocated {e['peak_gib']:.3f} → {c['peak_gib']:.3f} GiB, peak "
        f"reserved {e['peak_reserved_gib']:.3f} → "
        f"{c['peak_reserved_gib']:.3f} GiB, held at the loop's end with the "
        f"free cache released {e['held_gib']:.3f} → {c['held_gib']:.3f} GiB; "
        f"on {smi}")
    if e["captures"] != 0 or not c["captures"]:
        raise SystemExit(f"{label}: CUDA graphs {e['captures']} eager, "
                         f"{c['captures']} captured")
    if not (values and tensors):
        raise SystemExit(f"{label}: the captured run differs from the eager "
                         f"one")
    return runs


def phase_capture(torch, report, smi):
    """Phases 3, 6, 15 and 16's paths eager and captured, from the same
    parameters on the same batches."""
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.signal import IndexLoader
    from pytorch_geometric_temporal_tpu_torch.train import (
        BatchTrainer, SnapshotTrainer, TrainState, bf16_policy, f16_policy,
        make_mixed_precision_step, mse)

    sl, ch, pm = report["slice"], report["cheb"], report["pems"]
    c = SLICE

    def make_slice(capture):
        model = DCRNNSeq(c["f"], c["hidden"], K=2,
                         generator=torch.Generator().manual_seed(0))
        return BatchTrainer(model, lambda xb: model(xb, sl["ops"]), lr=1e-3,
                            loss_fn=mse, capture=capture), model

    eager_and_captured(torch, "phase 3's path (DCRNNSeq, N=50k, bf16 BCSR)",
                       make_slice, lambda tr, i: tr.train_step(sl["x"],
                                                               sl["y"]),
                       expected_launches(c["t"], 2, 1), "step", smi)

    def make_cheb(capture):
        net = gconv_gru_net(torch, CHEB["lags"], CHEB["hidden"], CHEB["K"],
                            seed=1)

        def loss_and_state(carry, x, y, graph):
            out, h = net(x, ch["op"], carry)
            return mse(out, y), h

        return SnapshotTrainer(net, loss_and_state, lr=1e-2,
                               capture=capture), net

    eager_and_captured(torch, "phase 6's path (GConvGRU, N=50k, Chebyshev "
                       "BCSR, T=8)", make_cheb,
                       lambda tr, i: tr.train_epoch(ch["signal"], None),
                       cheb_launches(CHEB["t"], CHEB["K"], 1), "epoch", smi)

    p, loader = PEMS, pm["loader"]
    batches = []
    for xb, yb in IndexLoader(loader.indices, loader.windower,
                              p["batch_size"], shuffle=True, seed=1):
        if len(batches) == CAPTURE["steps"]:
            break
        batches.append((xb, yb))

    def make_pems(capture):
        model = DCRNNSeq(p["f"], p["f"], p["K"],
                         generator=torch.Generator().manual_seed(0))
        return BatchTrainer(model, lambda xb: model(xb, pm["graph"]),
                            lr=1e-3, scaler=pm["scaler"],
                            capture=capture), model

    eager_and_captured(torch, "phase 15's path (index-batched DCRNN, PeMS "
                       "N=11,160, batches of 64)", make_pems,
                       lambda tr, i: tr.train_step(*batches[i % len(batches)]),
                       expected_launches(p["lags"], p["K"], 1), "step", smi)

    def make_mixed(policy, dynamic_scale):
        def make(capture):
            model = DCRNNSeq(c["f"], c["hidden"], K=2,
                             generator=torch.Generator().manual_seed(0))

            def loss_fn(params, xb, yb):
                pred = torch.func.functional_call(model, params,
                                                  (xb, sl["ops"]))
                return (pred.float() - yb.float()).square().mean()

            state = TrainState.create(
                model, lambda ps: torch.optim.Adam(ps, lr=1e-3, eps=1e-8))
            step = make_mixed_precision_step(
                loss_fn, policy=policy, dynamic_scale=dynamic_scale,
                capture=capture)
            scale = f16_scale(torch, sl["x"].device) if dynamic_scale else None
            return StepRunner(step, state, scale), model
        return make

    eager_and_captured(
        torch, "phase 16's bf16 path (make_mixed_precision_step, DCRNNSeq "
        "N=50k, bf16 BCSR, bf16 compute)", make_mixed(bf16_policy, False),
        lambda run, i: run(sl["x"], sl["y"]), expected_launches(c["t"], 2, 1),
        "step", smi)
    eager_and_captured(
        torch, "phase 16's f16 path (dynamic loss scale, no overflow)",
        make_mixed(f16_policy, True), lambda run, i: run(sl["x"], sl["y"]),
        expected_launches(c["t"], 2, 1), "step", smi)


class StepRunner:
    """A step builder's step bound to its state, read as a trainer is:
    ``runner(*batch)`` runs one step and returns its loss; ``capture``,
    ``captures`` and ``replays`` come from the step's graphs.  With a
    ``scale`` the step is the f16 one, which threads it."""

    def __init__(self, step, state, scale=None):
        self.step, self.state, self.scale = step, state, scale
        self.capture = step.graphs.capture is not False

    def __call__(self, *batch):
        if self.scale is None:
            self.state, loss = self.step(self.state, *batch)
        else:
            self.state, self.scale, loss = self.step(self.state, self.scale,
                                                     *batch)
        return loss

    @property
    def captures(self):
        return self.step.graphs.captures

    @property
    def replays(self):
        return self.step.graphs.replays


@contextlib.contextmanager
def no_syncs(torch):
    """Every host sync on the card raises inside."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def f16_scale(torch, device):
    from pytorch_geometric_temporal_tpu_torch.train import DynamicLossScale

    return DynamicLossScale(
        scale=torch.tensor(MIXED["f16_scale"], device=device),
        steps_since_growth=torch.tensor(0, dtype=torch.int32, device=device),
        growth_interval=MIXED["growth_interval"])


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
        TrainState, bf16_policy, f16_policy, make_mixed_precision_step)

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
    step(state, x, y)  # warm-up step: the signature's first, eager
    torch.cuda.synchronize()
    dtypes.clear()
    bcsr.reset_launch_counts()
    # the first counted step captures the graph, the others replay it
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
    check_captures(StepRunner(step, state), 1, "bf16-compute step")
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
    log(f"  bf16-compute step, captured (host clock, synchronized, "
        f"{m['timed_steps']} steps): median {med * 1e3:.3f} ms, min "
        f"{min(step_s) * 1e3:.3f}, max {max(step_s) * 1e3:.3f}; phase 3's "
        f"f32-compute step median {sl['step_ms']:.3f} ms; on {smi}")
    busy = profile_steps(torch, lambda: step(state, x, y), med * 1e3)
    if busy is not None and sl["busy_ms"] is not None:
        log(f"  device busy per step: bf16 compute {busy:.3f} ms, f32 "
            f"compute (phase 3) {sl['busy_ms']:.3f} ms, ratio "
            f"{busy / sl['busy_ms']:.3f}, on {smi}")

    # f16 with a dynamic loss scale, captured: two clean steps (the first
    # eager, the second captures), then a planted overflow and two clean
    # steps as replays with every host sync an error
    s0 = m["f16_scale"]
    scale = f16_scale(torch, x.device)
    state16 = TrainState.create(
        model, lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8))
    step16 = make_mixed_precision_step(loss_fn, policy=f16_policy,
                                       dynamic_scale=True)
    dtypes.clear()
    first = []
    for _ in range(2):
        state16, scale, l0 = step16(state16, scale, x, y)
        first.append((float(l0), float(scale.scale)))
    x_bad = x * 1e9
    torch.cuda.synchronize()
    before = state16.snapshot()
    with no_syncs(torch):
        state16, scale, l_bad = step16(state16, scale, x_bad, y)
        halved = scale.scale.clone()
        after = state16.snapshot()
        clean = []
        for _ in range(2):
            state16, scale, loss = step16(state16, scale, x, y)
            clean.append(loss)
    torch.cuda.synchronize()
    same = (int(after["step"]) == int(before["step"]) and all(
        torch.equal(after["params"][k], v)
        for k, v in before["params"].items()) and all(
        torch.equal(after["opt_state"]["state"][i][key], v)
        for i, mom in before["opt_state"]["state"].items()
        for key, v in mom.items()))
    clean = [float(v) for v in clean]
    runner = StepRunner(step16, state16)
    log(f"  f16 compute, loss scale {s0}, growth interval "
        f"{m['growth_interval']}: two clean steps (eager, then captured) "
        f"losses {['%.6f' % v for v, _ in first]}, scale "
        f"{[v for _, v in first]}; then as replays under "
        f"torch.cuda.set_sync_debug_mode('error') (no host sync raised): "
        f"planted overflow (x·1e9) loss {float(l_bad)}, parameters, Adam "
        f"moments and steps and the state's step unchanged bit for bit: "
        f"{same}, scale {float(halved)}; two clean steps "
        f"{['%.6f' % v for v in clean]}, scale {float(scale.scale)}, state "
        f"step {int(state16.step)}; CUDA graphs {runner.captures} "
        f"(predicted 1), {runner.replays} replays; predictions "
        f"{sorted({str(d) for d in dtypes})}")
    if not (same and [v for _, v in first] == [s0, 2 * s0]
            and float(halved) == s0 and float(scale.scale) == 2 * s0
            and int(state16.step) == 4 and np.isfinite(clean).all()
            and not torch.isfinite(l_bad)
            and np.isfinite([v for v, _ in first]).all()
            and (runner.captures, runner.replays) == (1, 4)):
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


def graphs_line(lines):
    """(captures, replays) from the harness's last log line."""
    m = re.fullmatch(r"(\d+) CUDA graphs captured, (\d+) replays", lines[-1])
    if m is None:
        raise SystemExit(f"the harness's last line reads {lines[-1]!r}")
    return int(m.group(1)), int(m.group(2))


def phase_harness(torch, smi):
    """The harness protocol on Chickenpox, captured: an uninterrupted run,
    a run resumed from its own checkpoints, a planted NaN epoch; then the
    run eager and captured."""
    import shutil
    import tempfile

    from torch.utils._pytree import tree_leaves

    from pytorch_geometric_temporal_tpu_torch.protocols import harness

    c = HARNESS
    tmp = tempfile.mkdtemp(prefix="harness_")
    try:
        lines = []

        def run(epochs, name, graphs, **kw):
            t0 = time.perf_counter()
            best, hist = harness.main(epochs, ckpt_dir=os.path.join(
                tmp, name), log=lines.append, **kw)
            torch.cuda.synchronize()
            # an epoch graph and a validation graph, each replayed from its
            # signature's second call on
            if graphs_line(lines) != (2, graphs):
                raise SystemExit(f"{name}: {lines[-1]} (predicted 2 CUDA "
                                 f"graphs, {graphs} replays)")
            return hist, time.perf_counter() - t0

        whole, secs = run(c["epochs"], "whole", 2 * (c["epochs"] - 1))
        n_train = harness.chickenpox(device="cuda")[0].snapshot_count
        kept = sorted(int(d) for d in os.listdir(os.path.join(tmp, "whole")))
        summary = [ln for ln in lines if re.fullmatch(
            r"\d+ steps, [\d.]+ ms/step, [\d.]+ items/s", ln)]
        log(f"  {c['epochs']} epochs in {secs:.2f} s ({secs / c['epochs']:.3f}"
            f" s an epoch of {n_train} updates, host clock, on {smi}); "
            f"train MSE {['%.6f' % h['train_mse'] for h in whole]}; val MSE "
            f"{['%.6f' % h['val_mse'] for h in whole]}; StepTimer: "
            f"{summary}; checkpoints kept {kept}; {lines[-1]}")
        if kept != [(c["epochs"] - 1) * n_train, c["epochs"] * n_train]:
            raise SystemExit(f"retention kept {kept}")
        if len(summary) != 1 or not summary[0].startswith(
                f"{c['epochs']} steps, "):
            raise SystemExit(f"StepTimer's summary reads {summary}")
        losses = [h["train_mse"] for h in whole]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise SystemExit(f"harness loss does not fall: {losses}")

        run(c["resume_at"], "resumed", 2 * (c["resume_at"] - 1))
        lines.clear()
        rest, _ = run(c["epochs"], "resumed",
                      2 * (c["epochs"] - c["resume_at"] - 1))
        resumed = [ln for ln in lines if ln.startswith("resumed from step")]
        pairs = [(a, b) for a, b in zip(rest, whole[c["resume_at"]:])]
        worst = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in pairs
                    for k in ("train_mse", "val_mse"))
        bitwise = all(a == b for a, b in pairs)
        log(f"  resumed at epoch {c['resume_at']} ({resumed}), its own graphs "
            f"captured after the restore ({lines[-1]}): epochs "
            f"{[h['epoch'] for h in rest]}, largest relative difference "
            f"from the uninterrupted run {worst:.3e} (tol "
            f"{HARNESS_RESUME_TOL}); bitwise equal: {bitwise}")
        if (len(resumed) != 1 or [h["epoch"] for h in rest] != list(
                range(c["resume_at"], c["epochs"]))
                or not worst <= HARNESS_RESUME_TOL or not bitwise):
            raise SystemExit("the resumed run differs from the whole run")

        lines.clear()
        # epochs 0..3: four train calls, three validation calls
        guarded, _ = run(c["nan_epoch"] + 2, "guarded", 3 + 2,
                         nan_epochs={c["nan_epoch"]})
        rolled = [ln for ln in lines if "rolled back" in ln]
        after = guarded[-1]["train_mse"]
        want = whole[c["nan_epoch"]]["train_mse"]
        log(f"  NaN planted in epoch {c['nan_epoch']} (a replay's input): "
            f"{rolled}; epochs {[h['epoch'] for h in guarded]}; the next "
            f"epoch's loss {after:.6f} against the uninterrupted run's epoch "
            f"{c['nan_epoch']} {want:.6f}")
        if (len(rolled) != 1 or [h["epoch"] for h in guarded] != [
                e for e in range(c["nan_epoch"] + 2) if e != c["nan_epoch"]]
                or abs(after - want) > HARNESS_RESUME_TOL * abs(want)):
            raise SystemExit("DivergenceGuard did not roll the epoch back")

        def loop(capture, epochs):
            ckpt = tempfile.mkdtemp(dir=tmp)
            out, held, marks = [], [], []

            def take(line):
                out.append(line)
                if line.startswith("epoch "):
                    # an epoch's line comes after its loss and validation
                    # were read (synchronized) and its checkpoint copied
                    marks.append(time.perf_counter())
                if line.startswith(f"epoch {epochs - 1}:"):
                    # the last epoch's graphs still live
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    held.append(torch.cuda.memory_reserved())

            _, hist = harness.main(epochs, ckpt_dir=ckpt, log=take,
                                   capture=capture)
            steps = max(int(d) for d in os.listdir(ckpt) if d.isdigit())
            state = torch.load(os.path.join(ckpt, str(steps), "state.pt"),
                               weights_only=True)
            captures, replays = graphs_line(out)
            return dict(values=[h[k] for h in hist
                                for k in ("train_mse", "val_mse")],
                        tensors=[t for t in tree_leaves(state)
                                 if isinstance(t, torch.Tensor)],
                        captures=captures, replays=replays, held=held[-1],
                        train_s=marks[-1] - marks[0])

        loop_eager_and_captured(torch, "the harness on Chickenpox (an epoch: "
                                f"{n_train} updates, validation, guard copy, "
                                "checkpoint)", loop, c["epochs"], smi,
                                profiled=(2, 4))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def start_watchdog(deadline):
    """End this process at ``deadline`` (time.time()): a hung collective
    must not outlive the run."""
    timer = threading.Timer(max(1.0, deadline - time.time()), lambda: (
        print("chip_smoke: a rank is still running at the deadline",
              file=sys.stderr, flush=True), os._exit(124)))
    timer.daemon = True
    timer.start()


def dist_rank(rank, world, tmp, deadline):
    """One rank of phases 19 and 20, spawned: joins a gloo group through a
    file store, runs both phases' work on the card and writes what it
    measured to ``tmp/rank<r>.json``.  A failed check raises here, and the
    parent's spawn raises with it."""
    import torch

    start_watchdog(deadline)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pytorch_geometric_temporal_tpu_torch import parallel as par

    par.initialize_multihost(f"file://{os.path.join(tmp, 'store')}", world,
                             rank, backend="gloo", device="cuda")
    t0 = time.perf_counter()
    data, means, stds = pems_zscored(PEMS)
    out = {"setup_s": time.perf_counter() - t0}
    out["ddp"] = ddp_rank(torch, par, rank, world, data, means, stds)
    out["halo"] = halo_rank(torch, par, rank, world, data, means, stds)
    torch.distributed.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def pems_parts(torch, means, stds):
    """Phase 15's raw PeMS graph on the card, its scaler and the masked
    MAE on de-normalized values with its entry count."""
    from pytorch_geometric_temporal_tpu_torch.ops import Graph
    from pytorch_geometric_temporal_tpu_torch.train import (
        ZScoreScaler, masked_mae_loss)

    ei, w = pems_graph(PEMS)
    g = Graph.from_edge_index(ei, w, num_nodes=PEMS["n"])
    scaler = ZScoreScaler(mean=torch.tensor(means, device="cuda"),
                          std=torch.tensor(stds, device="cuda"))

    def loss(pred, y):
        return masked_mae_loss(scaler.inverse(pred), scaler.inverse(y))

    def count(y):
        return (scaler.inverse(y) != 0).sum()

    return g, loss, count


def ddp_rank(torch, par, rank, world, data, means, stds):
    """Phase 19 on one rank: ``IndexLoader(world_size, rank)`` batches
    through ``make_dp_train_step``."""
    import torch.distributed as dist

    from pytorch_geometric_temporal_tpu_torch.data._common import (
        make_index_loaders)
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr
    from pytorch_geometric_temporal_tpu_torch.parallel import collectives
    from pytorch_geometric_temporal_tpu_torch.train import (
        TrainState, apply_gradients)

    c, d = PEMS, DIST
    g, loss_of, count_of = pems_parts(torch, means, stds)
    train, _, _ = make_index_loaders(data, c["lags"],
                                     c["batch_size"] // world, shuffle=True,
                                     world_size=world, rank=rank)
    mesh = par.make_mesh({"dp": world})

    def new_model():
        return DCRNNSeq(c["f"], c["f"], c["K"],
                        generator=torch.Generator().manual_seed(0))

    model = par.replicate(new_model(), mesh)
    state = TrainState.create(model, lambda ps: torch.optim.Adam(ps, 1e-3))
    step = par.make_dp_train_step(
        lambda m, x, y: loss_of(m(x, g), y), mesh,
        weight_fn=lambda x, y: count_of(y))
    batches = iter(train)
    x, y = next(batches)
    out = {"batches": len(train), "batch": list(x.shape)}

    # rank 0: the single-process step on both ranks' batches, concatenated
    xs, ys = ([torch.empty_like(t) for _ in range(world)] for t in (x, y))
    dist.all_gather(xs, x)
    dist.all_gather(ys, y)
    if rank == 0:
        ref = new_model()
        ref.load_state_dict(model.state_dict())
        ref_state = TrainState.create(ref,
                                      lambda ps: torch.optim.Adam(ps, 1e-3))
        loss_ref = loss_of(ref(torch.cat(xs), g), torch.cat(ys))
        grads_ref = torch.autograd.grad(loss_ref, list(ref.parameters()))
        apply_gradients(ref_state, grads_ref)
    del xs, ys

    # the path: three steps, launches counted; the first step's gradient
    # is read where Adam is given it, after the all-reduce
    seen = []
    hook = state.opt_state.register_step_pre_hook(
        lambda opt, args, kwargs: seen.extend(
            p.grad.clone() for p in model.parameters()))
    torch.cuda.synchronize()
    bcsr.reset_launch_counts()
    state, loss = step(state, x, y)
    torch.cuda.synchronize()
    hook.remove()
    out["first_launches"] = launch_counts(bcsr)
    losses = [float(loss)]
    if rank == 0:
        out["loss_ref"] = float(loss_ref.detach())
        out["loss_err"] = abs(losses[0] - out["loss_ref"]) / abs(
            out["loss_ref"])
        errs = {name: rel_err(gr, gq)
                for (name, _), gr, gq in zip(model.named_parameters(), seen,
                                             grads_ref)}
        out["grad_err"] = max(errs.values())
        out["grad_worst"] = max(errs, key=errs.get)
        errs = {name: rel_err(p.detach(), q.detach())
                for (name, p), q in zip(model.named_parameters(),
                                        ref.parameters())}
        out["param_err"] = max(errs.values())
        out["param_worst"] = max(errs, key=errs.get)
    del seen
    for _ in range(d["steps"] - 1):
        x, y = next(batches)
        state, loss = step(state, x, y)
        losses.append(float(loss))
    torch.cuda.synchronize()
    out["launches"] = launch_counts(bcsr)
    out["losses"] = losses
    out["graphs"] = [step.graphs.captures, step.graphs.replays]
    par.assert_same_across_hosts(model)     # raises if the ranks differ

    # timing (host clock, synchronized): the steps as they run, then the
    # step's two all-reduces (the entry count, the flat gradients and loss)
    # alone on buffers of their sizes, then the device's busy time under
    # the profiler
    step_s, ar_s = [], []
    par.reset_collective_bytes()
    for _ in range(d["timed_steps"]):
        x, y = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, x, y)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    out["all_reduce_bytes"] = (par.collective_bytes["all_reduce"]
                               // d["timed_steps"])
    groups = [mesh.get_group("dp")]
    count = torch.ones(1, dtype=torch.float64, device="cuda")
    flat = torch.ones(sum(p.numel() for p in model.parameters()) + 1,
                      device="cuda")
    for _ in range(d["timed_steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collectives.all_reduce_(count, groups)
        collectives.all_reduce_(flat, groups)
        torch.cuda.synchronize()
        ar_s.append(time.perf_counter() - t0)
    out["step_ms"] = [v * 1e3 for v in step_s]
    out["all_reduce_ms"] = [v * 1e3 for v in ar_s]
    out["all_reduce_share"] = (statistics.median(ar_s)
                               / statistics.median(step_s))
    agg, _ = device_time_by_kernel(torch, lambda: step(state, x, y),
                                         d["profiled_steps"])
    out["busy_ms"] = sum(us for us, _ in agg.values()) / d[
        "profiled_steps"] / 1e3
    out["kernel_ms"] = sum(us for name, (us, _) in agg.items()
                           if "hybrid_spmm" in name) / d[
                               "profiled_steps"] / 1e3
    return out


def halo_rank(torch, par, rank, world, data, means, stds):
    """Phase 20 on one rank: DCRNNPartitionedSeq over the halo-partitioned
    PeMS graph against single-device DCRNNSeq on the segment path (rank
    0), the exchanges' bytes against ``ici_bytes_per_step``, and one
    aggregation through the gather and the scatter exchange."""
    import torch.distributed as dist

    from pytorch_geometric_temporal_tpu_torch.ops import spmm_segment
    from pytorch_geometric_temporal_tpu_torch.ops.operators import (
        host_diffusion_norms)

    c = PEMS
    g, loss_of, count_of = pems_parts(torch, means, stds)
    mesh = par.make_mesh({"graph": world})
    out = partitioned_run(torch, par, mesh, g, data, loss_of, count_of)
    hs, grads = out.pop("hs"), out.pop("grads")
    blocks = [torch.empty_like(hs) for _ in range(world)]
    dist.all_gather(blocks, hs)
    if rank == 0:
        out.update(compare_single(torch, g, data, loss_of,
                                  torch.cat(blocks, dim=1), grads))
    del blocks

    # gather and scatter, one aggregation each at F=256 on P_fwd, forward
    # and backward (gloo runs all-gather and reduce-scatter on CUDA tensors
    # in torch 2.11; where it cannot, the collective raises)
    p_fwd, _ = host_diffusion_norms(g)
    z = torch.randn(c["n"], c["batch_size"] * 2 * c["f"], device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    want = spmm_segment(p_fwd, z)
    npp = -(-c["n"] // world)
    lo = mesh.get_local_rank("graph") * npp
    want = want[lo:lo + npp]
    out["exchanges"] = {}
    for exchange, by in (("gather", "receiver"), ("scatter", "sender")):
        pg = par.PartitionedGraph.from_graph(p_fwd, world, by=by)
        zb = pg.shard_features(z, mesh).requires_grad_()
        par.reset_collective_bytes()
        got = par.spmm_partitioned(pg, zb, mesh, exchange=exchange)
        sent = sum(par.collective_bytes.values())
        got.square().sum().backward()
        out["exchanges"][exchange] = {
            "err": rel_err(got[:want.shape[0]].detach(), want),
            "bytes": sent, "formula": pg.ici_bytes_per_step(z.shape[1]),
            "bytes_all": sum(par.collective_bytes.values())}
    return out


def partitioned_run(torch, par, mesh, g, data, loss_of, count_of):
    """DCRNNPartitionedSeq(2, K=2) on this rank's node block of the first
    64 windows, (T, npp, 64, 2) node-leading, from the parameters of
    phase 19's model: hs, the masked MAE's gradients summed over the axis,
    the collective bytes and the formula's."""
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.signal import DeviceWindower
    from pytorch_geometric_temporal_tpu_torch.parallel import collectives

    c = PEMS
    P = mesh["graph"].size()
    group = mesh.get_group("graph")
    t0 = time.perf_counter()
    pops = par.PartitionedDiffusionOperators.from_graph(g, P)
    out = {"build_s": time.perf_counter() - t0,
           "halo": [pops.p_fwd.halo_size, pops.p_bwd.halo_size],
           "npp": pops.p_fwd.nodes_per_part}
    x, y = DeviceWindower(data, c["lags"])(np.arange(c["batch_size"]))
    single = DCRNNSeq(c["f"], c["f"], c["K"],
                      generator=torch.Generator().manual_seed(0))
    model = par.DCRNNPartitionedSeq(c["f"], c["f"], c["K"])
    model.load_state_dict(single.state_dict())
    shard = lambda t: pops.p_fwd.shard_features(  # noqa: E731
        t.permute(1, 2, 0, 3), mesh, node_axis=1)
    xb, yb = shard(x), shard(y)
    npp = pops.p_fwd.nodes_per_part
    real = max(0, min(npp, c["n"] - mesh.get_local_rank("graph") * npp))
    torch.cuda.synchronize()
    par.reset_collective_bytes()
    t0 = time.perf_counter()
    hs = model(xb, pops, mesh)
    out["fwd_bytes"] = sum(par.collective_bytes.values())
    count = count_of(yb[:, :real]).double().reshape(1)
    total = collectives.all_reduce_(count.clone(), [group])
    loss = loss_of(hs[:, :real], yb[:, :real]) * float(count / total)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    out["fwd_bwd_s"] = time.perf_counter() - t0
    out["all_bytes"] = (sum(par.collective_bytes.values())
                        - par.collective_bytes["all_reduce"])
    flat = torch.cat([gr.reshape(-1) for gr in grads]
                     + [loss.detach().reshape(1)])
    collectives.all_reduce_(flat, [group])
    out["loss"] = float(flat[-1])
    f_hop = c["batch_size"] * 2 * c["f"]
    per = [p.ici_bytes_per_step(f_hop) for p in (pops.p_fwd, pops.p_bwd)]
    # per step 2 bases x 2 directions x (K-1) hops at F = 64 x (2 + 2); no
    # backward for t=0's first basis, whose input holds no parameter
    out["fwd_formula"] = c["lags"] * 2 * (c["K"] - 1) * sum(per)
    out["all_formula"] = 2 * out["fwd_formula"] - (c["K"] - 1) * sum(per)
    par.reset_collective_bytes()
    par.spmm_partitioned(pops.p_fwd, xb[0].new_zeros(npp, f_hop), mesh,
                         exchange="halo")
    out["one_hop"] = [sum(par.collective_bytes.values()), per[0]]
    out["hs"] = hs.detach()
    out["grads"] = {name: gr for (name, _), gr in zip(
        model.named_parameters(), torch.split(flat[:-1], [
            p.numel() for p in model.parameters()]))}
    return out


def compare_single(torch, g, data, loss_of, hs, grads):
    """Single-device DCRNNSeq on the segment path over the same 64 windows
    and parameters: the partitioned forward (its first N rows) and
    parameter gradients against it."""
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.signal import DeviceWindower

    c = PEMS
    x, y = DeviceWindower(data, c["lags"])(np.arange(c["batch_size"]))
    single = DCRNNSeq(c["f"], c["f"], c["K"],
                      generator=torch.Generator().manual_seed(0))
    with config_override(spmm_backend="segment"):
        want = single(x, g)
        loss = loss_of(want, y)
        want_grads = torch.autograd.grad(loss, list(single.parameters()))
    got = hs[:, :c["n"]].permute(2, 0, 1, 3)
    errs = {name: rel_err(grads[name].reshape(w.shape), w)
            for (name, _), w in zip(single.named_parameters(), want_grads)}
    worst = max(errs, key=errs.get)
    return {"fwd_err": rel_err(got, want.detach()), "grad_err": errs[worst],
            "grad_worst": worst, "loss_ref": float(loss.detach())}


def phase_ddp(torch, kernel_report, smi, deadline):
    """Spawns the two ranks of phases 19 and 20 and reports phase 19."""
    import tempfile

    c, d = PEMS, DIST
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        torch.multiprocessing.start_processes(
            dist_rank, args=(d["world"], tmp, deadline), nprocs=d["world"],
            start_method="spawn")
        secs = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(d["world"])]
    per_step = expected_launches(c["lags"], c["K"], 1)
    r0 = ranks[0]["ddp"]
    log(f"  {d['world']} ranks spawned (gloo, CUDA tensors, one card) ran "
        f"phases 19 and 20 in {secs:.1f} s (series and graph made in "
        f"{max(r['setup_s'] for r in ranks):.1f} s a rank); each rank's "
        f"IndexLoader(world_size={d['world']}, rank=r): {r0['batches']} "
        f"batches of {r0['batch'][0]} an epoch, batch {r0['batch']}")
    for r, rk in enumerate(ranks):
        k = rk["ddp"]
        log(f"  rank {r}: fused launches of the first step {k['first_launches']['H']}"
            f" (expected {per_step}), of the {d['steps']} steps "
            f"{k['launches']['H']} (expected {d['steps'] * per_step}); K1 "
            f"{k['launches']['K1']}, K2 {k['launches']['K2']} (expected 0); "
            f"global masked MAE {['%.6f' % v for v in k['losses']]}")
        if (k["first_launches"] != {"H": per_step, "K1": 0, "K2": 0}
                or k["launches"] != {"H": d["steps"] * per_step, "K1": 0,
                                     "K2": 0}):
            raise SystemExit("phase 19: launch counts differ")
        kernel_report["H"]["launches"] += k["launches"]["H"]
    if any(rk["ddp"]["losses"] != r0["losses"] for rk in ranks):
        raise SystemExit("phase 19: the ranks' global losses differ")
    graphs = [rk["ddp"]["graphs"] for rk in ranks]
    log(f"  the ranks' steps ran eagerly (gloo goes through the host, which "
        f"a CUDA graph cannot capture): CUDA graphs and replays a rank "
        f"{graphs}")
    if any(g != [0, 0] for g in graphs):
        raise SystemExit("phase 19: a gloo step was captured")
    log(f"  against the single-process step on the concatenated batch of "
        f"{c['batch_size']}: loss {r0['losses'][0]:.7f} vs "
        f"{r0['loss_ref']:.7f}, relative {r0['loss_err']:.3e} (tol "
        f"{DDP_TOLS[0]}); the all-reduced gradient Adam is given up to "
        f"{r0['grad_err']:.3e} of each leaf's largest entry at "
        f"{r0['grad_worst']} (tol {DDP_TOLS[1]}); parameters after one Adam "
        f"step up to {r0['param_err']:.3e} of their largest entry at "
        f"{r0['param_worst']} (tol {DDP_TOLS[2]}); the ranks' parameters "
        f"equal after {d['steps']} steps (assert_same_across_hosts)")
    if not (r0["loss_err"] <= DDP_TOLS[0] and r0["grad_err"] <= DDP_TOLS[1]
            and r0["param_err"] <= DDP_TOLS[2]):
        raise SystemExit("phase 19: the data-parallel step differs from "
                         "the single-process step")
    for r, rk in enumerate(ranks):
        k = rk["ddp"]
        log(f"  rank {r}, two ranks time-sharing one card (no scaling "
            f"measured): step median {statistics.median(k['step_ms']):.3f} ms"
            f" (min {min(k['step_ms']):.3f}, max {max(k['step_ms']):.3f}; "
            f"host clock, synchronized, {d['timed_steps']} steps); the "
            f"step's two all-reduces timed alone (gloo through the host, "
            f"{k['all_reduce_bytes']} bytes sent a step) median "
            f"{statistics.median(k['all_reduce_ms']):.3f} ms (min "
            f"{min(k['all_reduce_ms']):.3f}, max {max(k['all_reduce_ms']):.3f})"
            f", {k['all_reduce_share']:.3f} of the median step; device busy "
            f"{k['busy_ms']:.3f} ms a step, the fused kernel "
            f"{k['kernel_ms']:.3f} ms of it (profiler, "
            f"{d['profiled_steps']} steps) on {smi}")
    return ranks


def phase_halo(torch, ranks, smi):
    """Reports phase 20's two ranks, then runs P=1 over NCCL here."""
    c = PEMS
    for r, rk in enumerate(ranks):
        h = rk["halo"]
        log(f"  P=2, rank {r}: halo H = {h['halo']} rows (P_fwd, P_bwd) "
            f"against {h['npp']} nodes a part; partition built in "
            f"{h['build_s']:.2f} s; forward + backward {h['fwd_bwd_s']:.3f} "
            f"s (host clock); all-to-all bytes sent: one hop at F="
            f"{c['batch_size'] * 2 * c['f']} {h['one_hop'][0]} (formula "
            f"{h['one_hop'][1]}), the forward {h['fwd_bytes']} (formula "
            f"{h['fwd_formula']}), forward + backward {h['all_bytes']} "
            f"(formula {h['all_formula']})")
        if not (h["one_hop"][0] == h["one_hop"][1] > 0
                and h["fwd_bytes"] == h["fwd_formula"]
                and h["all_bytes"] == h["all_formula"]):
            raise SystemExit("phase 20: collective bytes differ from "
                             "ici_bytes_per_step")
    check_halo("P=2 (gloo)", ranks[0]["halo"])
    for r, rk in enumerate(ranks):
        for exchange, e in rk["halo"]["exchanges"].items():
            log(f"  rank {r}: '{exchange}' exchange, one aggregation at F="
                f"{c['batch_size'] * 2 * c['f']}: {e['err']:.3e} of the "
                f"segment path's largest output (tol {HALO_TOLS[0]}); bytes "
                f"sent {e['bytes']} forward (formula {e['formula']}), "
                f"{e['bytes_all']} with the backward (twice the formula)")
            if not (e["err"] <= HALO_TOLS[0] and e["bytes"] == e["formula"]
                    and e["bytes_all"] == 2 * e["formula"]):
                raise SystemExit(f"phase 20: the {exchange} exchange differs")

    # P=1 over NCCL, here: the group of one make_mesh makes
    import torch.distributed as dist

    from pytorch_geometric_temporal_tpu_torch import parallel as par

    data, means, stds = pems_zscored(c)
    g, loss_of, count_of = pems_parts(torch, means, stds)
    mesh = par.make_mesh({"graph": 1})
    try:
        backend = dist.get_backend()
        out = partitioned_run(torch, par, mesh, g, data, loss_of, count_of)
        out.update(compare_single(torch, g, data, loss_of, out.pop("hs"),
                                  out.pop("grads")))
    finally:
        dist.destroy_process_group()
    log(f"  P=1 over {backend}: forward + backward {out['fwd_bwd_s']:.3f} s;"
        f" bytes sent {out['all_bytes']} (formula {out['all_formula']})")
    if backend != "nccl" or out["all_bytes"] != 0 or out["all_formula"]:
        raise SystemExit("phase 20: P=1 did not run over NCCL")
    check_halo("P=1 (NCCL)", out)


def phase_dp_nccl(torch, report, smi):
    """Phase 19's data-parallel step at P=1 over NCCL (the group of one
    ``make_mesh`` makes) at phase 15's width and depth: its first step
    against ``BatchTrainer``'s on the same batch, then eager against
    captured from the same parameters, and the bytes a replay sends."""
    import torch.distributed as dist

    from pytorch_geometric_temporal_tpu_torch import parallel as par
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr
    from pytorch_geometric_temporal_tpu_torch.signal import IndexLoader
    from pytorch_geometric_temporal_tpu_torch.train import (
        BatchTrainer, TrainState, masked_mae_loss)

    p, pm = PEMS, report["pems"]
    graph, scaler, loader = pm["graph"], pm["scaler"], pm["loader"]
    batches = []
    for xb, yb in IndexLoader(loader.indices, loader.windower,
                              p["batch_size"], shuffle=True, seed=1):
        if len(batches) == CAPTURE["steps"]:
            break
        batches.append((xb, yb))
    per_step = expected_launches(p["lags"], p["K"], 1)

    def loss_of(m, xb, yb):
        return masked_mae_loss(scaler.inverse(m(xb, graph)),
                               scaler.inverse(yb))

    def count_of(xb, yb):
        return (scaler.inverse(yb) != 0).sum()

    def new_model():
        return DCRNNSeq(p["f"], p["f"], p["K"],
                        generator=torch.Generator().manual_seed(0))

    def new_state(model):
        return TrainState.create(model, lambda ps: torch.optim.Adam(ps, 1e-3))

    mesh = par.make_mesh({"dp": 1})
    try:
        backend = str(dist.get_backend(mesh.get_group("dp")))
        model, ref = new_model(), new_model()
        state = new_state(model)
        trainer = BatchTrainer(ref, lambda xb: ref(xb, graph), lr=1e-3,
                               scaler=scaler, capture=False)
        seen = {"dp": [], "ref": []}
        hooks = [opt.register_step_pre_hook(
            lambda o, a, k, m=m, key=key: seen[key].extend(
                q.grad.clone() for q in m.parameters()))
            for opt, m, key in ((state.opt_state, model, "dp"),
                                (trainer.optimizer, ref, "ref"))]
        step = par.make_dp_train_step(loss_of, mesh, weight_fn=count_of)
        torch.cuda.synchronize()
        bcsr.reset_launch_counts()
        state, loss = step(state, *batches[0])
        torch.cuda.synchronize()
        launches = launch_counts(bcsr)
        loss_ref = trainer.train_step(*batches[0])
        for h in hooks:
            h.remove()
        loss_err = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
        grad_err = max(rel_err(a, b) for a, b in zip(seen["dp"],
                                                     seen["ref"]))
        param_err = max(rel_err(a.detach(), b.detach()) for a, b in zip(
            model.parameters(), ref.parameters()))
        log(f"  P=1 over {backend}, the first step (eager) against "
            f"BatchTrainer's on the same batch of {p['batch_size']}: loss "
            f"{float(loss):.7f} vs {float(loss_ref):.7f}, relative "
            f"{loss_err:.3e} (tol {DDP_TOLS[0]}); the gradient Adam is given "
            f"up to {grad_err:.3e} (tol {DDP_TOLS[1]}); parameters after it "
            f"up to {param_err:.3e} (tol {DDP_TOLS[2]}); fused launches "
            f"{launches['H']} (expected {per_step})")
        if backend != "nccl":
            raise SystemExit(f"phase 25: P=1 ran over {backend}, not NCCL")
        if not (loss_err <= DDP_TOLS[0] and grad_err <= DDP_TOLS[1]
                and param_err <= DDP_TOLS[2]):
            raise SystemExit("phase 25: the data-parallel step differs from "
                             "BatchTrainer's")
        if launches != {"H": per_step, "K1": 0, "K2": 0}:
            raise SystemExit("phase 25: launch counts differ")
        report["H"]["launches"] += launches["H"]
        del model, ref, state, trainer, seen

        def make(capture):
            m = new_model()
            return StepRunner(par.make_dp_train_step(
                loss_of, mesh, weight_fn=count_of, capture=capture),
                new_state(m)), m

        eager_and_captured(
            torch, "phase 19's data-parallel step at P=1 over NCCL (PeMS "
            "N=11,160, batches of 64)", make,
            lambda run, i: run(*batches[i % len(batches)]), per_step,
            "step", smi)

        # the bytes a replay sends: the all-reduce formula, 2·(P−1)·B/P
        # for each of the step's two buffers
        run, m = make(None)
        for i in range(2):              # eager, then the capture
            run(*batches[i])
        par.reset_collective_bytes()
        replays = 3
        for i in range(replays):
            run(*batches[i])
        torch.cuda.synchronize()
        size = mesh["dp"].size()
        buffers = (8, 4 * (sum(q.numel() for q in m.parameters()) + 1))
        formula = sum(2 * (size - 1) * b // size for b in buffers)
        sent = par.collective_bytes["all_reduce"] / replays
        log(f"  all-reduce bytes a replay {sent} (formula {formula} at "
            f"P={size}); CUDA graphs {run.captures}, replays {run.replays}")
        if sent != formula or (run.captures, run.replays) != (1, 1 + replays):
            raise SystemExit("phase 25: a replay's bytes differ from the "
                             "formula")
    finally:
        dist.destroy_process_group()


def check_halo(label, h):
    log(f"  {label} against single-device DCRNNSeq on the segment path: "
        f"loss {h['loss']:.7f} vs {h['loss_ref']:.7f}; forward "
        f"{h['fwd_err']:.3e} of the largest output (tol {HALO_TOLS[0]}), "
        f"parameter gradients up to {h['grad_err']:.3e} of their largest "
        f"entry at {h['grad_worst']} (tol {HALO_TOLS[1]})")
    if not (h["fwd_err"] <= HALO_TOLS[0] and h["grad_err"] <= HALO_TOLS[1]
            and abs(h["loss"] - h["loss_ref"]) <= HALO_TOLS[0] * abs(
                h["loss_ref"])):
        raise SystemExit(f"phase 20, {label}: the partitioned DCRNN differs "
                         f"from the single-device one")


def kernel_share(agg, pattern, n):
    """(device ms a step, launches a step, names) of the kernels in a
    profile over ``n`` steps whose names match ``pattern``."""
    hits = {k: v for k, v in agg.items() if pattern.search(k)}
    return (sum(us for us, _ in hits.values()) / n / 1e3,
            sum(c for _, c in hits.values()) // n, sorted(hits))


def hop_breakdown(torch, mat, f, n=20):
    """Device ms of one ``bcsr_spmm`` call at width ``f``, forward alone
    and forward + backward: the fused kernel, the permutation gathers'
    forward and backward kernels, and the rest (padding, layout copies)."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr_spmm

    x = torch.randn(mat.num_nodes, f, device="cuda", requires_grad=True)
    g = torch.randn(mat.num_nodes, f, device="cuda")
    out = {}
    for backward in (False, True):
        def call():
            y = bcsr_spmm(mat, x if backward else x.detach())
            if backward:
                y.backward(g)

        call()
        ops = dict.fromkeys(PERMUTE_OPS, 0.0)
        agg, _ = device_time_by_kernel(torch, call, n, ops)
        parts = {"kernel": kernel_share(agg, FUSED_KERNEL, n)[0],
                 "gather_fwd": ops["_Permute"] / n / 1e3,
                 "gather_bwd": ops["_PermuteBackward"] / n / 1e3,
                 "total": sum(us for us, _ in agg.values()) / n / 1e3}
        out["fwd_bwd" if backward else "fwd"] = parts
    return out


def reorder_costs(p, mat, width):
    """``_reorder_costs`` on the diffusion graph ``p`` whose auto-built
    operator is ``mat``, under each cost model (ns): the two orderings'
    costs, the charge for the gathers, and the decision, at the arguments
    ``spmm``'s auto route builds with (``from_graph``'s defaults, the
    flattened ``width``); the host seconds of the RCM pass and of each
    model's two cost passes.  The default model's decision must be the
    build's."""
    from pytorch_geometric_temporal_tpu_torch.native import (
        bandwidth_reduction_order)
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    args = inspect.signature(bcsr.BCSRMatrix.from_graph).parameters
    n = p.num_nodes
    s, r = host_edges(p)
    t0 = time.perf_counter()
    order = bandwidth_reduction_order(s, r, n)
    out = {"rcm_s": time.perf_counter() - t0}
    ip = np.empty_like(order)
    ip[order] = np.arange(n, dtype=np.int32)
    for costs in (bcsr.TPU_V5E, bcsr.H100):
        t0 = time.perf_counter()
        cost0, cost1, gather = bcsr._reorder_costs(
            r, s, ip[r], ip[s], n, bcsr.BLOCK, args["dtype"].default, width,
            args["min_block_edges"].default, costs=costs)
        out[costs.name] = dict(cost0=cost0, cost1=cost1, gather=gather,
                               keep=bool(cost1 + gather < cost0),
                               cost_s=time.perf_counter() - t0)
    if out[bcsr.DEFAULT_COSTS.name]["keep"] != (mat.perm is not None):
        raise SystemExit("phase 21: the decision differs from the build")
    if mat.perm is not None and not np.array_equal(
            mat.perm.cpu().numpy()[:n], order):
        raise SystemExit("phase 21: the operator's permutation is not the "
                         "RCM order")
    return out


def scrambled_variant(torch, label, state, graph, x, y, scaler, reorder):
    """Phase 21's model from ``state`` on (graph, x, y) under
    ``spmm_reorder=reorder``: operator builds of its first step (host
    seconds), the host step median over more steps, and one profile: the
    device's busy time a step, the fused kernel's and the gathers'."""
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer

    c = PEMS
    model = DCRNNSeq(c["f"], c["f"], c["K"])
    model.load_state_dict(state)
    trainer = BatchTrainer(model, lambda xb: model(xb, graph), lr=1e-3,
                           scaler=scaler)

    def step():
        with config_override(spmm_reorder=reorder):
            trainer.train_step(x, y)

    with counted_builds() as builds:
        step()
        torch.cuda.synchronize()
    step_s = []
    for _ in range(SCRAMBLED["timed_steps"]):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s) * 1e3
    log(f"  ({label}) spmm_reorder={reorder!r}: {builds.calls} operator "
        f"builds in its first step, host seconds "
        f"{['%.3f' % v for v in builds.seconds]}; step median {med:.3f} ms "
        f"(min {min(step_s) * 1e3:.3f}, max {max(step_s) * 1e3:.3f}; host "
        f"clock, synchronized, {len(step_s)} steps)")
    check_captures(trainer, 1, f"({label}) the train step")
    agg = {}
    busy = profile_steps(torch, step, med, top=8, agg_out=agg)
    if busy is None:
        raise SystemExit("phase 21: the profiler recorded no device time")
    kernel, launches, _ = kernel_share(agg, FUSED_KERNEL, 2)
    # a replay runs no host op, so the gathers' kernels are attributed to
    # _Permute / _PermuteBackward on an eager step of the same model
    twin = BatchTrainer(model, lambda xb: model(xb, graph), lr=1e-3,
                        scaler=scaler, capture=False)
    ops = dict.fromkeys(PERMUTE_OPS, 0.0)

    def eager_step():
        with config_override(spmm_reorder=reorder):
            twin.train_step(x, y)

    eager_step()
    eager_agg, eager_wall = device_time_by_kernel(torch, eager_step, 2, ops)
    eager_busy = sum(us for us, _ in eager_agg.values()) / 2e3
    out = dict(step_ms=med, busy_ms=busy, kernel=kernel,
               gather_fwd=ops["_Permute"] / 2e3,
               gather_bwd=ops["_PermuteBackward"] / 2e3)
    log(f"    the fused kernel {kernel:.3f} ms a step in {launches} launches;"
        f" on an eager step (device busy {eager_busy:.3f} ms, "
        f"{eager_wall / 2e3:.3f} ms wall under the profiler) the "
        f"permutation gathers (the kernels of _Permute and _PermuteBackward) "
        f"{out['gather_fwd']:.3f} ms forward and {out['gather_bwd']:.3f} ms "
        f"backward a step")
    return out


def phase_pems_scrambled(torch, kernel_report, smi):
    """Phase 15's model and recipe on the same graph and series with the
    sensor ids scrambled: spmm's auto route lays out both operators as the
    default cost model decides, and the decision is held to the card."""
    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.data._common import (
        make_index_loaders)
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import (
        BCSRMatrix, Graph, bcsr, reorder_graph)
    from pytorch_geometric_temporal_tpu_torch.ops.graph import diffusion_norms
    from pytorch_geometric_temporal_tpu_torch.signal import IndexLoader
    from pytorch_geometric_temporal_tpu_torch.train import (
        BatchTrainer, ZScoreScaler)

    c, p15 = PEMS, kernel_report["pems"]
    h, bs, K, n = c["lags"], c["batch_size"], c["K"], c["n"]
    data, means, stds = pems_zscored(c)
    ei, w = pems_graph(c)
    sigma = np.random.default_rng(PEMS_SCRAMBLE_SEED).permutation(n)
    data_s = np.empty_like(data)
    data_s[:, sigma] = data
    sigma_t = torch.from_numpy(sigma).cuda()
    g = Graph.from_edge_index(ei, w, num_nodes=n)
    g_s = Graph.from_edge_index(sigma[ei], w, num_nodes=n)
    train, val, test = make_index_loaders(data_s, h, bs, shuffle=True)
    scaler = ZScoreScaler(mean=torch.tensor(means, device="cuda"),
                          std=torch.tensor(stds, device="cuda"))
    x0s, y0s = next(iter(IndexLoader(train.indices, train.windower, bs,
                                     shuffle=True)))
    # un-permuted, the scrambled batch is phase 15's first batch
    x0, y0 = x0s[:, :, sigma_t], y0s[:, :, sigma_t]
    if not first_batch_is_host_windows(train, data, x0, y0):
        raise SystemExit("phase 21: the scrambled batch, un-permuted, is not "
                         "phase 15's")
    log(f"  sensor ids scrambled by σ (numpy seed {PEMS_SCRAMBLE_SEED}): "
        f"edges (σ[s], σ[r]), series columns data_s[:, σ[i]] = data[:, i]; "
        f"the first train batch {tuple(x0s.shape)}, un-permuted by σ, equals "
        f"phase 15's host windows bit for bit")

    model = DCRNNSeq(c["f"], c["f"], K,
                     generator=torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    # phase 15's unscrambled run at the same parameters (its two operator
    # builds fall outside the count below)
    ref = outputs_and_param_grads(torch, model, lambda: model(x0, g), y0)
    trainer = BatchTrainer(model, lambda xb: model(xb, g_s), lr=1e-3,
                           scaler=scaler)
    with config_override(spmm_backend="segment"):
        want = outputs_and_param_grads(torch, model, lambda: model(x0s, g_s),
                                       y0s)
    # (b) the first batch on the RCM-reordered operators, which TPU v5e's
    # model keeps here (built on another instance of the scrambled graph,
    # so that they are cached apart): outputs and parameter gradients
    # through _Permute and _PermuteBackward on the card, against the
    # segment path and against the unscrambled run un-permuted by σ
    g_rcm = Graph.from_edge_index(sigma[ei], w, num_nodes=n)
    with default_costs(bcsr.TPU_V5E):
        got = outputs_and_param_grads(torch, model,
                                      lambda: model(x0s, g_rcm), y0s)
    rcm_mats = [m for q in diffusion_norms(g_rcm)
                for m in q._op_cache.values() if isinstance(m, BCSRMatrix)]
    if len(rcm_mats) != 2 or any(m.perm is None for m in rcm_mats):
        raise SystemExit("phase 21: TPU v5e's model did not reorder both "
                         "operators")
    log("  (b) the RCM-reordered operators (perm kept on both):")
    compare_with_segment(torch, "scrambled-id DCRNN (RCM)", model, got, want,
                         *PEMS_TOLS)
    compare_with_segment(torch, "scrambled-id DCRNN (RCM)", model,
                         (got[0][:, :, sigma_t], got[1]), ref, *PEMS_TOLS,
                         against="the unscrambled run un-permuted by σ")
    del got, rcm_mats
    with counted_builds() as builds:
        # (b) the first batch on the run's own layout against the segment
        # path on the scrambled graph, and against the unscrambled run
        # un-permuted by σ
        got = outputs_and_param_grads(torch, model, lambda: model(x0s, g_s),
                                      y0s)
        log("  (b) the run's own layout (the default model's decision):")
        compare_with_segment(torch, "scrambled-id DCRNN", model, got, want,
                             *PEMS_TOLS)
        compare_with_segment(torch, "scrambled-id DCRNN", model,
                             (got[0][:, :, sigma_t], got[1]), ref, *PEMS_TOLS,
                             against="the unscrambled run un-permuted by σ")
        del got, want, ref

        # (c) launches of one train and one eval batch
        per_train, per_eval = one_batch_launches(trainer, x0s, y0s, "(c)")

        # (d) two epochs with validation and a test pass, launches counted
        per_epoch = len(train) * per_train + len(val) * per_eval
        curve, epoch_s = [], []
        torch.cuda.synchronize()
        bcsr.reset_launch_counts()
        t_fit = time.perf_counter()
        trainer.fit(train, SCRAMBLED["epochs"], val_loader=val,
                    callback=lambda e, loss, v: (
                        curve.append((loss, v)),
                        epoch_s.append(time.perf_counter() - t_fit)))
        tl, tn = torch.zeros((), device="cuda"), 0
        for xb, yb in test:
            tl, tn = tl + trainer.eval_step(xb, yb), tn + 1
        test_mae = float(tl) / tn
        launches = launch_counts(bcsr)
    calls = ([("train", bs), ("eval", bs)]
             + SCRAMBLED["epochs"] * ([("train", b) for b in batch_sizes(train)]
                                      + [("eval", b) for b in batch_sizes(val)])
             + [("eval", b) for b in batch_sizes(test)])
    check_captures(trainer, predicted_captures(calls),
                   "(c) train and eval steps (one graph a batch size)")
    want_h = SCRAMBLED["epochs"] * per_epoch + len(test) * per_eval
    log(f"  (c) fused launches over {SCRAMBLED['epochs']} epochs and the test "
        f"pass {launches['H']} (expected {want_h}); K1 {launches['K1']} and "
        f"K2 {launches['K2']} (expected 0)")
    if launches != {"H": want_h, "K1": 0, "K2": 0}:
        raise SystemExit("phase 21: launch counts differ")
    kernel_report["H"]["launches"] += launches["H"]
    fmt = [("%.4f" % a, "%.4f" % b) for a, b in curve]
    log(f"  (d) epochs (train, val) masked MAE {fmt}, test {test_mae:.4f}, "
        f"epochs end at {['%.2f' % v for v in epoch_s]} s; phase 15's "
        f"unscrambled run {[('%.4f' % a, '%.4f' % b) for a, b in p15['curve']]}"
        f", test {p15['test_mae']:.4f}")
    if not (all(np.isfinite([v for pair in curve for v in pair] + [test_mae]))
            and curve[-1][0] < curve[0][0]):
        raise SystemExit("phase 21: losses not finite or the epoch loss did "
                         "not fall")

    # (a) the two auto-built operators, laid out as the default cost model
    # decides ((f) holds the decision to the build)
    norms = diffusion_norms(g_s)
    mats = [m for q in norms for m in q._op_cache.values()
            if isinstance(m, BCSRMatrix)]
    log(f"  (a) operator builds of the scrambled run: {builds.calls} "
        f"(expected 2), host seconds {['%.3f' % v for v in builds.seconds]} "
        f"(phase 15's unscrambled builds "
        f"{['%.3f' % v for v in p15['build_s']]}); "
        + "; ".join(f"{name}: perm {'kept' if m.perm is not None else 'none'}"
                    f", fwd nnzb={m.fwd.nnzb} rem={m.fwd.num_rem}, bwd "
                    f"nnzb={m.bwd.nnzb} rem={m.bwd.num_rem}"
                    for name, m in zip(("P_fwd", "P_bwd"), mats)))
    if builds.calls != 2 or len(mats) != 2 or any(
            m.fwd.blocks.dtype != torch.float32 for m in mats):
        raise SystemExit("phase 21: expected two f32 operators")

    # (e) five variants at the same parameters on the same batch: the run's
    # own layout (auto, the default H100 model), the RCM order as TPU v5e's
    # model keeps it (built on another instance of the scrambled graph, so
    # that its operators are cached apart), as the ids come, reorder_graph
    # once, and the unscrambled graph
    g_v5e = Graph.from_edge_index(sigma[ei], w, num_nodes=n)
    g2, perm, _ = reorder_graph(g_s)
    perm_t = torch.from_numpy(perm).cuda().long()
    x0r, y0r = x0s[:, :, perm_t], y0s[:, :, perm_t]
    runs = {"auto": scrambled_variant(torch, "auto", state, g_s, x0s, y0s,
                                      scaler, "auto")}
    with default_costs(bcsr.TPU_V5E):
        runs["i"] = scrambled_variant(torch, "i", state, g_v5e, x0s, y0s,
                                      scaler, "auto")
    runs.update({
        "ii": scrambled_variant(torch, "ii", state, g_s, x0s, y0s, scaler,
                                "off"),
        "iii": scrambled_variant(torch, "iii", state, g2, x0r, y0r, scaler,
                                 "off"),
        "iv": scrambled_variant(torch, "iv", state, g, x0, y0, scaler,
                                "auto"),
    })

    def p_fwd_operator(graph, reorder):
        # spmm's cache key for f32 tiles (ops/spmm.py: _auto_bcsr)
        return diffusion_norms(graph)[0]._op_cache[("bcsr", "None", reorder)]

    ops = {"auto": p_fwd_operator(g_s, "auto"),
           "i": p_fwd_operator(g_v5e, "auto"),
           "ii": p_fwd_operator(g_s, None),
           "iii": p_fwd_operator(g2, None), "iv": p_fwd_operator(g, "auto")}
    if ops["ii"].perm is not None or ops["iii"].perm is not None:
        raise SystemExit("phase 21: spmm_reorder='off' reordered")
    if ops["i"].perm is None:
        raise SystemExit("phase 21: TPU v5e's model did not reorder")
    if ops["iv"].perm is not None:
        raise SystemExit("phase 21: the unscrambled operator was reordered")
    f_hop = bs * 2 * c["f"]
    titles = {"auto": "scrambled, spmm_reorder='auto' (H100 model)",
              "i": "scrambled, reordered (TPU v5e model's choice)",
              "ii": "scrambled, as the ids come (off)",
              "iii": "reorder_graph once, no gathers a hop",
              "iv": "unscrambled (phase 15)"}
    for key, mat in ops.items():
        half = mat.fwd
        log(f"  ({key}) {titles[key]}: P_fwd forward half nnzb={half.nnzb} "
            f"rem={half.num_rem}, perm "
            f"{'kept' if mat.perm is not None else 'none'}")
        if key in ("i", "ii"):
            cost_point(torch, kernel_report, half, f_hop,
                       f"pems-p21-{key} P_fwd.fwd", held_out=True)
        report_fused(torch, kernel_report, half, f_hop,
                     f"PeMS scrambled ({key}) f32")
        runs[key]["kernel_cold"] = kernel_report["paths"][-1][1]["ms"]
        runs[key]["hop"] = hop_breakdown(torch, mat, f_hop)
        hb = runs[key]["hop"]
        log(f"    one hop at F={f_hop} (device ms, profiler, warm): forward "
            f"{hb['fwd']['total']:.4f} (kernel {hb['fwd']['kernel']:.4f}, "
            f"gathers {hb['fwd']['gather_fwd']:.4f}); forward + backward "
            f"{hb['fwd_bwd']['total']:.4f} (kernel "
            f"{hb['fwd_bwd']['kernel']:.4f}, gathers forward "
            f"{hb['fwd_bwd']['gather_fwd']:.4f}, backward "
            f"{hb['fwd_bwd']['gather_bwd']:.4f})")
    log(f"  (e) a train step at the same parameters on the same batch, on "
        f"{smi}:")
    for key, r in runs.items():
        log(f"    ({key}) {titles[key]}: device busy {r['busy_ms']:.3f} ms, "
            f"fused kernel {r['kernel']:.3f} ms, gathers forward "
            f"{r['gather_fwd']:.3f} ms and backward {r['gather_bwd']:.3f} ms; "
            f"host step median {r['step_ms']:.3f} ms; the kernel cold at "
            f"F={f_hop} {r['kernel_cold']:.4f} ms")
    gi = runs["i"]
    log(f"    (i)'s gathers: backward {gi['gather_bwd'] / gi['gather_fwd']:.2f}"
        f" times the forward")

    # (f) both cost models' decisions beside the measurement; the default
    # model's decision must be the build's and pick the faster variant
    costs_of = {}
    for name, q, m in zip(("P_fwd", "P_bwd"), norms, mats):
        cm = costs_of[name] = reorder_costs(q, m, f_hop)
        log(f"  (f) {name}: host RCM {cm['rcm_s']:.3f} s; _reorder_costs at "
            f"F={f_hop}, f32 tiles, min_block_edges 32: " + "; ".join(
                f"{key} ({cm[key]['cost_s']:.3f} s) as the ids come "
                f"{cm[key]['cost0'] / 1e3:.1f} us, reordered "
                f"{cm[key]['cost1'] / 1e3:.1f} us + gathers "
                f"{cm[key]['gather'] / 1e3:.1f} us = "
                f"{(cm[key]['cost1'] + cm[key]['gather']) / 1e3:.1f} us: "
                f"{'reorder' if cm[key]['keep'] else 'keep the ids'}"
                for key in ("tpu_v5e", "h100")))
    h = costs_of["P_fwd"][bcsr.H100.name]
    hop_gathers = (runs["i"]["hop"]["fwd_bwd"]["gather_fwd"]
                   + runs["i"]["hop"]["fwd_bwd"]["gather_bwd"]) * 1e3
    log(f"  (f) P_fwd: the H100 model's charge for the four gathers a hop "
        f"{h['gather'] / 1e3:.1f} us against {hop_gathers:.1f} us of gather "
        f"kernels in (i)'s hop (profiler, forward + backward, warm), "
        f"{(h['gather'] / 1e3 / hop_gathers - 1) * 100:+.1f}%; the decision "
        f"would turn to reorder only below "
        f"{(h['cost0'] - h['cost1']) / 1e3:.1f} us")
    hop_i = runs["i"]["kernel_cold"] + runs["i"]["hop"]["fwd"]["gather_fwd"]
    hop_ii = runs["ii"]["kernel_cold"]
    busy = {k: r["busy_ms"] for k, r in runs.items()}
    faster = "i" if busy["i"] < busy["ii"] else "ii"
    apart = abs(busy["i"] - busy["ii"]) > DECISION_MARGIN * min(
        busy["i"], busy["ii"])
    chose = "i" if ops["auto"].perm is not None else "ii"
    log(f"  (f) measured on {smi} at F={f_hop}: a forward hop (the kernel "
        f"cold + the two gathers) reordered {hop_i:.4f} ms against "
        f"{hop_ii:.4f} ms as the ids come; device busy a train step "
        f"reordered (i) {busy['i']:.3f} against {busy['ii']:.3f} ms as the "
        f"ids come (ii): ({faster}) faster by "
        f"{abs(busy['i'] / busy['ii'] - 1) * 100:.1f}% (margin "
        f"{DECISION_MARGIN * 100:.0f}%); the auto run chose ({chose}) and "
        f"its busy {busy['auto']:.3f} ms is "
        f"{(busy['auto'] / busy[chose] - 1) * 100:+.2f}% of ({chose})'s "
        f"(limit {AUTO_BUSY_TOL * 100:.0f}%)")
    if apart and chose != faster:
        raise SystemExit("phase 21: the auto decision is the slower variant")
    if abs(busy["auto"] / busy[chose] - 1) > AUTO_BUSY_TOL:
        raise SystemExit("phase 21: the auto run's busy differs from its "
                         "variant's")


def recovery_edges(rng):
    """``bench.py:bench_reorder_recovery``'s draw (the first draws of
    ``rng``): the banded graph under scrambled ids, weights normalized by
    the weighted in-degree; (edge_index, weights)."""
    c = RECOVERY
    n, e = c["n"], c["n"] * c["deg"]
    s = rng.integers(0, n, size=e)
    r = np.clip(s + rng.integers(-c["band"], c["band"] + 1, size=e), 0, n - 1)
    scram = rng.permutation(n)
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    d = np.bincount(r, weights=w, minlength=n).astype(np.float32)
    return np.stack([scram[s], scram[r]]), w / np.maximum(d[r], 1e-6)


def recovery_graph(torch):
    """:func:`recovery_edges`' graph and x, on the card."""
    from pytorch_geometric_temporal_tpu_torch.ops import Graph

    c = RECOVERY
    rng = np.random.default_rng(c["seed"])
    ei, w = recovery_edges(rng)
    g = Graph.from_edge_index(ei, w, num_nodes=c["n"])
    x = torch.from_numpy(rng.normal(size=(c["n"], c["f"])).astype(
        np.float32)).cuda()
    return g, x


def phase_recovery(torch, kernel_report, smi):
    """(a) the reorder-recovery twin: the fused kernel on the scrambled
    N=20,000 operator as the ids come and reordered; (b) AVWGCN's sparse
    top-k at N=20,000."""
    from pytorch_geometric_temporal_tpu_torch.ops import (
        BCSRMatrix, bcsr, bcsr_spmm, spmm_segment)

    c = RECOVERY
    n, f = c["n"], c["f"]
    g, x = recovery_graph(torch)
    s_e, r_e = host_edges(g)
    # the plain operator at TPU v5e's θ and at the default H100 model's,
    # and the reordered one as the H100 model decides
    mats, theta = {}, {}
    for key, reorder, costs in (("plain_v5e", None, bcsr.TPU_V5E),
                                ("plain", None, bcsr.H100),
                                ("reordered", "auto", bcsr.H100)):
        t0 = time.perf_counter()
        mats[key] = mat = BCSRMatrix.from_graph(
            g, dtype=torch.bfloat16, min_block_edges="auto", expected_f=f,
            reorder=reorder, costs=costs)
        secs = time.perf_counter() - t0
        ip = (np.arange(n) if mat.perm is None
              else mat.iperm.cpu().numpy()[:n])
        theta[key] = thetas(ip[s_e], ip[r_e], n, torch.bfloat16, f)
        tiles_b = mat.fwd.nnzb * 128 * 128 * 2
        log(f"  ({key}) reorder={reorder!r}, costs={costs.name}: built in "
            f"{secs:.2f} s (host); min_block_edges='auto' θ at F={f} "
            f"{theta[key]}; fwd nnzb={mat.fwd.nnzb} rem={mat.fwd.num_rem}, "
            f"bwd nnzb={mat.bwd.nnzb} rem={mat.bwd.num_rem}; bf16 tiles "
            f"{tiles_b / 1e9:.3f} GB a half, {operator_bytes(mat) / 1e9:.3f} "
            f"GB on the card in all; perm "
            f"{'kept' if mat.perm is not None else 'none'}")
    if (mats["plain_v5e"].perm is not None or mats["plain"].perm is not None
            or mats["reordered"].perm is None):
        raise SystemExit("phase 22: reorder='auto' did not reorder")

    # the kernels against their plain versions on every half at F=64
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, mats["plain"].fwd.num_cols
                                        - n))
    for key, mat in mats.items():
        for side in ("fwd", "bwd"):
            errs = check_kernels(torch, bcsr, getattr(mat, side),
                                 x_pad.to(torch.bfloat16))
            log(f"  {key} {side} F={f}: {fmt_errs(errs)}")
            if any(e > t for e, t in errs.values()):
                raise SystemExit(f"phase 22: kernel mismatch on {key}.{side}")
            kernel_report["H"]["max_abs_err"] = max(
                kernel_report["H"]["max_abs_err"], errs["fused"][0])

    # one bcsr_spmm a operator, against the segment path
    want = spmm_segment(g, x)
    scale = float(want.abs().max())
    bcsr.reset_launch_counts()
    outs = {key: bcsr_spmm(mat, x) for key, mat in mats.items()}
    launches = launch_counts(bcsr)
    if launches != {"H": len(mats), "K1": 0, "K2": 0}:
        raise SystemExit(f"phase 22: launches {launches}, expected one a call")
    kernel_report["H"]["launches"] += launches["H"]
    for key, out in outs.items():
        err = float((out - want).abs().max()) / scale
        log(f"  {key}: bcsr_spmm against spmm_segment {err:.3e} of the "
            f"largest output {scale:.4f} (tol {DYN_STEP_TOL}); one fused "
            f"launch")
        if not err <= DYN_STEP_TOL:
            raise SystemExit(f"phase 22: {key} differs from the segment path")

    ks = {}
    for key, mat in mats.items():
        report_fused(torch, kernel_report, mat.fwd, f,
                     f"recovery N=20,000 {key} bf16")
        ks[key] = kernel_report["paths"][-1][1]
        cost_point(torch, kernel_report, mat.fwd, f,
                   f"recovery-p22-{key} fwd", held_out=True)
    v5e_theta, h100_theta = theta["plain_v5e"]["tpu_v5e"], theta["plain"][
        "h100"]
    log(f"  (a) on {smi}: the plain operator cold at F={f}: θ={h100_theta} "
        f"(H100 model) {ks['plain']['ms']:.4f} ms against θ={v5e_theta} "
        f"(TPU v5e model) {ks['plain_v5e']['ms']:.4f} ms (ratio "
        f"{ks['plain_v5e']['ms'] / ks['plain']['ms']:.2f}); torch.sparse.mm "
        f"{ks['plain']['library_ms']:.4f} ms")
    if h100_theta != v5e_theta and ks["plain"]["ms"] > ks["plain_v5e"]["ms"]:
        raise SystemExit("phase 22: the plain operator at the H100 model's "
                         "θ is slower than at TPU v5e's")
    mat_r = mats["reordered"]
    out_pad = bcsr.bcsr_matmul(mat_r.fwd, x_pad)
    g_in = cold_ms(torch, lambda: x_pad[mat_r.perm])
    g_out = cold_ms(torch, lambda: out_pad[mat_r.iperm])
    for key in ("plain_v5e", "plain"):
        ratio = ks[key]["ms"] / ks["reordered"]["ms"]
        ratio_g = ks[key]["ms"] / (ks["reordered"]["ms"] + g_in + g_out)
        log(f"  (a) on {smi}: the fused kernel cold at F={f} as the ids come "
            f"({key}) {ks[key]['ms']:.4f} ms, reordered "
            f"{ks['reordered']['ms']:.4f} ms (ratio {ratio:.2f}); the "
            f"gathers cold x[perm] {g_in:.4f} ms and out[iperm] {g_out:.4f} "
            f"ms (ratio with them {ratio_g:.2f})")
    log(f"  the JAX package's record of the ratio at its θ on a TPU v5e "
        f"(BENCH_r05.json, another chip): {RECOVERY_RECORD_TPU_V5E}x")
    del mats, outs, mat_r, x_pad, out_pad

    avwgcn_topk_on_the_card(torch, smi)


def avwgcn_topk_on_the_card(torch, smi):
    from pytorch_geometric_temporal_tpu_torch.models import AVWGCN
    from pytorch_geometric_temporal_tpu_torch.models.conv import (
        _topk_support)

    c = AVW
    rng = np.random.default_rng(c["seed"])
    e_np = rng.normal(size=(c["n"], c["d"])).astype(np.float32)
    x_np = rng.normal(size=(c["n"], c["f"])).astype(np.float32)
    model = AVWGCN(c["f"], c["out"], c["K"], c["d"], topk=c["topk"],
                   generator=torch.Generator().manual_seed(0))
    twin = AVWGCN(c["f"], c["out"], c["K"], c["d"], topk=c["topk"],
                  device="cpu")
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    e = torch.from_numpy(e_np).cuda().requires_grad_()
    x = torch.from_numpy(x_np).cuda()

    def fwd_bwd():
        out = model(x, e)
        loss = (out ** 2).mean()
        loss.backward()
        return out, loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, loss = fwd_bwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    g_pool = float(model.weights_pool.grad.abs().sum())
    g_e = float(e.grad.abs().sum())
    cols = _topk_support(e.detach(), c["topk"])[0].cpu()
    cols_cpu = _topk_support(torch.from_numpy(e_np), c["topk"])[0]
    with torch.no_grad():
        out_cpu = twin(torch.from_numpy(x_np), torch.from_numpy(e_np))
    scale = float(out_cpu.abs().max())
    err = float((out.detach().cpu() - out_cpu).abs().max())
    agg, _ = device_time_by_kernel(torch, fwd_bwd, 3)
    busy = sum(us for us, _ in agg.values()) / 3 / 1e3
    log(f"  (b) AVWGCN(out 4, K=2, embeddings 4, topk=8) at N={c['n']}, f="
        f"{c['f']}: loss {float(loss):.6f}; gradient sums weights_pool "
        f"{g_pool:.4e}, E {g_e:.4e}; kept columns equal to the CPU's: "
        f"{bool(torch.equal(cols, cols_cpu))}; outputs against the CPU "
        f"{err:.3e} (tol {AVW_TOL} of the output scale {scale:.4f}); device "
        f"busy forward + backward {busy:.3f} ms (profiler, 3 calls), peak "
        f"memory {peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB "
        f"held, on {smi}")
    if not (np.isfinite(float(loss)) and g_pool > 0 and g_e > 0
            and torch.equal(cols, cols_cpu) and err <= AVW_TOL * scale):
        raise SystemExit("phase 22: AVWGCN's sparse top-k on the card "
                         "differs from the CPU")


def sweep_edges(rng, nrb, tile_range, rem_range):
    """(receivers, senders, tiles, rems) of one synthetic half of phase 23:
    row block rb holds tiles[rb] blocks of ``tile_edges`` edges in distinct
    column blocks and rems[rb] edges spread over its other column blocks."""
    c = COST_SWEEP
    tiles = rng.integers(tile_range[0], tile_range[1] + 1, size=nrb)
    rems = rng.integers(rem_range[0], rem_range[1] + 1, size=nrb)
    rows, cols = [], []
    for rb in range(nrb):
        cbs = rng.permutation(nrb)
        k = tiles[rb] * c["tile_edges"]
        rows.append(rb * 128 + rng.integers(0, 128, size=k + rems[rb]))
        cols.append(np.concatenate([
            np.repeat(cbs[:tiles[rb]], c["tile_edges"]),
            rng.choice(cbs[tiles[rb]:], size=rems[rb])]) * 128
            + rng.integers(0, 128, size=k + rems[rb]))
    return (np.concatenate(rows).astype(np.int32),
            np.concatenate(cols).astype(np.int32), tiles, rems)


def phase_cost_model(torch, report, smi):
    """The H100 cost model against the card: the fused kernel on phase 23's
    synthetic halves at every width and tile dtype, warm and cold; the
    permutation gathers; the committed constants' (ops/bcsr.py: H100)
    predictions against every point, the held-out operators of phases 15,
    21 and 22 among them, and the constants refitted on this run's sweep
    (tools/fit_kernel_costs.py)."""
    import importlib.util

    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    spec = importlib.util.spec_from_file_location(
        "fit_kernel_costs", Path(__file__).resolve().parent / "tools"
        / "fit_kernel_costs.py")
    fit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fit)
    c = COST_SWEEP
    t0 = time.perf_counter()
    rng = np.random.default_rng(c["seed"])
    for label, nrb, tile_range, rem_range in COST_SHAPES:
        rows, cols, tiles, rems = sweep_edges(rng, nrb, tile_range, rem_range)
        vals = rng.uniform(0.1, 1.0, rows.size).astype(np.float32)
        for dtype in (torch.bfloat16, torch.float32):
            half = bcsr._build_half(rows, cols, vals, nrb * 128, 128, dtype,
                                    c["theta"], device="cuda")
            got = half.row_block_layout()
            if not (np.array_equal(got[0], tiles)
                    and np.array_equal(got[1], rems)):
                raise SystemExit(f"phase 23: {label} is not laid out as "
                                 f"drawn")
            for f in c["fs"]:
                cost_point(torch, report, half, f, label, held_out=False)
            del half
    from pytorch_geometric_temporal_tpu_torch.ops import Graph

    for dtype in (torch.bfloat16, torch.float32):
        hub = bcsr.BCSRMatrix.from_graph(hub_graph(Graph), dtype=dtype,
                                         min_block_edges=10**6).fwd
        tiles, rems = hub.row_block_layout()
        hub_csr = _csr_of(torch, hub.rem_rows, hub.rem_cols.long(),
                          hub.rem_vals.to(dtype),
                          (hub.num_rows, hub.num_cols))
        for f in c["fs"]:
            x = torch.randn(hub.num_cols, f, device="cuda").to(dtype)
            log("hub-point " + json.dumps({
                "dtype": "bf16" if dtype == torch.bfloat16 else "f32",
                "f": f, "edges": hub.num_rem,
                "longest_row": int(torch.diff(hub.rem_row_ptr).max()),
                "cold_ms": cold_ms(torch, lambda: bcsr.hybrid_spmm(hub, x),
                                   c["cold_reps"]),
                "library_ms": cold_ms(
                    torch, lambda: torch.sparse.mm(hub_csr, x),
                    c["cold_reps"]),
                "model_ms": float(bcsr._half_ns(
                    bcsr.H100, tiles, rems, f,
                    dtype == torch.bfloat16)[0]) / 1e6}))
    gathers = []
    for n_pad in c["gather_rows"]:
        idx = torch.randperm(n_pad, device="cuda")
        for f in c["fs"]:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(n_pad, f, device="cuda").to(dtype)
                g = {"n_pad": n_pad, "f": f, "bytes": x.element_size(),
                     "warm_ms": warm_ms(torch, lambda: x[idx], x,
                                        c["warm_reps"])}
                log("gather-point " + json.dumps(g))
                gathers.append(g)
    log(f"  {len(report['cost_points'])} points on {len(COST_SHAPES)} "
        f"synthetic shapes x {len(c['fs'])} widths x 2 tile dtypes and the "
        f"held-out operators, {len(gathers)} gathers, in "
        f"{time.perf_counter() - t0:.1f} s on {smi}")
    shapes, points = report["cost_shapes"], report["cost_points"]
    med = fit.report(shapes, points, gathers, fit.committed(),
                     f"the committed constants (ops/bcsr.py: H100) on {smi}",
                     log=lambda line: log("  " + line))
    fit.report(shapes, points, gathers, fit.fit(shapes, points, gathers),
               f"refit on this run's sweep on {smi}",
               log=lambda line: log("  " + line))
    worst = max(med[0], med[1], med[3])
    if worst > COST_MEDIAN_TOL:
        raise SystemExit(f"phase 23: the committed model's median relative "
                         f"error {worst * 100:.1f}% passes "
                         f"{COST_MEDIAN_TOL * 100:.0f}% (sweep "
                         f"{med[0] * 100:.1f}%, held out {med[1] * 100:.1f}%"
                         f", gathers {med[3] * 100:.1f}%)")


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
    t_start_wall = time.time()
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
    report = {"f32_other_libs": other_libs, "f32_sweep": [],
              "cost_shapes": {}, "cost_points": []}
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
    phase_protocols(torch, smi)
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
    log("== phase 26: edge-mode ASTGCN's hop-1 kernel at the benchmark "
        "cell's shapes")
    phase_weighted_hop(torch, report, smi)
    log("== phase 27: an ASTGCN block's tail kernel at the benchmark cell's "
        "shapes")
    phase_block_tail(torch, report, smi)
    log("== phase 15: index-batched DCRNN on the PeMS-scale stand-in")
    phase_index_pems(torch, report, smi)
    log("== phase 16: DCRNNSeq at N=50k in bf16 compute "
        "(make_mixed_precision_step), then f16 with a loss scale")
    phase_mixed(torch, report, smi)
    log("== phase 24: phases 3, 6, 15 and 16's paths eager and captured "
        "(CUDA graphs) from the same parameters on the same batches")
    phase_capture(torch, report, smi)
    del report["slice"], report["cheb"]
    log("== phase 17: HeteroGCLSTM at N=50k + 20k through SnapshotTrainer")
    phase_hetero(torch, report, smi)
    log("== phase 18: the training harness on Chickenpox")
    phase_harness(torch, smi)
    log("== phase 19: PGT-I's DDP recipe at PeMS scale, two ranks on the "
        "card (the same ranks then run phase 20 at P=2)")
    ranks = phase_ddp(torch, report, smi, t_start_wall + WATCHDOG_S - 10)
    log("== phase 20: halo-partitioned DCRNN at PeMS scale, P=2 over gloo "
        "and P=1 over NCCL")
    phase_halo(torch, ranks, smi)
    log("== phase 25: phase 19's data-parallel step at P=1 over NCCL, "
        "eager and captured (CUDA graphs)")
    phase_dp_nccl(torch, report, smi)
    log("== phase 21: index-batched DCRNN on the PeMS stand-in with "
        "scrambled sensor ids (spmm_reorder='auto')")
    phase_pems_scrambled(torch, report, smi)
    log("== phase 22: the reorder-recovery twin at N=20,000 and AVWGCN's "
        "sparse top-k")
    phase_recovery(torch, report, smi)
    log("== phase 23: the BCSR builder's H100 cost model against the card")
    phase_cost_model(torch, report, smi)

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
    k = report["WH"]
    kernels.append({
        "name": "weighted_hop", "route": "cuda",
        "source": "pytorch_geometric_temporal_tpu_torch/csrc/weighted_hop.cu",
        "replaces": "none: the JAX package's hop 1 is XLA's gather and "
                    "segment sum",
        "launches": k["launches"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    k = report["BT"]
    kernels.append({
        "name": "block_tail", "route": "cuda",
        "source": "pytorch_geometric_temporal_tpu_torch/csrc/block_tail.cu",
        "replaces": "none: the JAX package's block tail is flax's Conv and "
                    "LayerNorm, fused by XLA",
        "launches": k["launches"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
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
