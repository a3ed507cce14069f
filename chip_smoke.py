#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``pytorch_geometric_temporal_tpu_torch`` only (no JAX):

1. card: name and power limit (nvidia-smi), torch/CUDA versions, and the
   nvcc build of the kernels (``csrc/*.cu``, one nvcc per source, in
   parallel) with its time;
2. kernels against their plain PyTorch versions on the card: the fused
   hybrid SpMM (the main path) and its baseline pair K1 (tile SpMM) and K2
   (remainder scatter) on f32 and bf16 tiles, both halves, F in {8, 32,
   36, 96, 200} (36 ragged), a hybrid operator, an all-tiles operator, an
   all-remainder operator and a graph with empty row blocks; then at the
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
   which launches no BCSR kernel.

Exits non-zero, and prints no result, without CUDA or when any check
fails.  The last line is ``{"ok": true, "device": {...}}``; the line before
it holds the per-kernel JSON record.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12,     # dense tensor-core rate
              "f32": 67e12}       # CUDA-core FMA rate
SLICE = dict(n=50_000, deg=40, f=32, hidden=64, t=4, band=96, seed=3)
STEPS = 5          # counted training steps (the main path)
TIMED_STEPS = 20   # further steps timed on the host clock


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

    t0 = time.perf_counter()
    csrc.load()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {csrc.build_info['seconds']})")
    for line in csrc.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())
    return smi


def phase_kernel_cases(torch):
    from pytorch_geometric_temporal_tpu_torch.ops import Graph, bcsr
    from pytorch_geometric_temporal_tpu_torch.ops.bcsr import BCSRMatrix

    rng = np.random.default_rng(0)
    n = 1000
    ei, w = banded_graph(rng, n, 20_000, band=40, frac_local=0.96)
    # empty row blocks: nodes 384..639 (row blocks 3 and 4) get no edges
    keep = ~((ei[1] >= 384) & (ei[1] < 640))
    graphs = {
        "hybrid": (ei, w, 32),
        "all-tiles": (ei, w, 0),
        "all-remainder": (ei, w, 10**6),
        "empty-rows": (ei[:, keep], w[keep], 32),
    }
    worst = 0.0
    for name, (e_i, e_w, mbe) in graphs.items():
        g = Graph.from_edge_index(e_i, e_w, num_nodes=n)
        for dtype in (torch.float32, torch.bfloat16):
            mat = BCSRMatrix.from_graph(g, dtype=dtype, min_block_edges=mbe)
            for side in ("fwd", "bwd"):
                half = getattr(mat, side)
                for f in (8, 32, 36, 96, 200):
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

    # fused: each input once — the tiles and their pointers, the x rows of
    # the referenced column blocks and of the remainder columns (a union),
    # 8 B per remainder edge (column, value) and the row pointers — and the
    # f32 output written once
    x_used = torch.zeros(half.num_cols, dtype=torch.bool, device="cuda")
    x_used.view(nb, 128)[half.block_cols.long()] = True
    x_used[half.rem_row_cols.long()] = True
    x_rows_h = int(x_used.sum())
    h_bytes = (half.nnzb * 128 * 128 * s_t + (nb + 1 + half.nnzb) * 4
               + x_rows_h * f * s_x + half.num_rem * 8
               + (half.num_rows + 1) * 4 + half.num_rows * f * 4)
    h_ops = {dt: k1_ops, "f32": k2_ops}
    h_bound, h_by = bound_of(h_bytes, h_ops)
    whole_csr = _csr_of(torch, torch.cat([rows, rrows]),
                        torch.cat([cols, half.rem_cols.long()]),
                        torch.cat([vals, rvals]), shape)
    h = {
        "ms": cold_ms(torch, lambda: bcsr.hybrid_spmm(half, x)),
        "plain_ms": cold_ms(torch,
                            lambda: bcsr.hybrid_spmm_plain(half, x)),
        "library_ms": cold_ms(torch, lambda: torch.sparse.mm(whole_csr, x)),
        "bound_ms": h_bound, "bound_by": h_by,
        "bytes": h_bytes, "ops": sum(h_ops.values()),
    }
    pair_ms = cold_ms(
        torch, lambda: bcsr.rem_scatter_(half, x, bcsr.tile_spmm(half, x)))
    for name, k in (("fused hybrid_spmm", h), ("K1 tile_spmm", k1),
                    ("K2 rem_scatter_", k2)):
        log(f"  {name}: {k['ms']:.4f} ms  bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}, {k['bytes']} B, {k['ops']} flop; share "
            f"{k['bound_ms'] / k['ms']:.3f})  plain {k['plain_ms']:.4f} ms  "
            f"torch.sparse.mm ({dt} CSR) {k['library_ms']:.4f} ms")
    log(f"  fused counts {x_rows_h} x rows; K1 then K2 as a pair "
        f"{pair_ms:.4f} ms (sum of singles {k1['ms'] + k2['ms']:.4f}); "
        f"fused / pair {h['ms'] / pair_ms:.3f}; fused / torch.sparse.mm "
        f"over the whole half {h['ms'] / h['library_ms']:.3f}")
    h["max_abs_err"] = errs["fused"]
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
    ei, w = banded_graph(rng, c["n"], e, c["band"])
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
    kernel_report.update(H=h, K1=k1, K2=k2)

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
    # bf16 tiles and bf16-cast activations in every hop: ~2^-9 relative
    # rounding per product term
    fwd_tol, grad_tol = 2e-2, 3e-2
    log(f"  vs segment path: forward max abs err {fwd_err:.3e} (tol "
        f"{fwd_tol}), input-grad max rel err {grad_rel:.3e} (tol {grad_tol})")
    if not (fwd_err <= fwd_tol and grad_rel <= grad_tol):
        raise SystemExit("slice does not match the segment path")

    trainer = BatchTrainer(model, lambda xb: model(xb, ops), lr=1e-3,
                           loss_fn=mse)
    trainer.train_step(x, y)  # warm-up step (allocator, cuBLAS handles)
    torch.cuda.synchronize()

    bcsr.reset_launch_counts()
    losses = [float(trainer.train_step(x, y)) for _ in range(STEPS)]
    launches = {"H": bcsr.hybrid_spmm.launches,
                "K1": bcsr.tile_spmm.launches,
                "K2": bcsr.rem_scatter_.launches}
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
    profile_steps(torch, lambda: trainer.train_step(x, y), med * 1e3)


def profile_steps(torch, step, step_ms, n=2, top=12):
    """Device time by kernel over ``n`` training steps (torch.profiler's
    device-side events only), and the device's busy share of the
    unprofiled median step ``step_ms`` (one stream, so kernel times do not
    overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    agg = {}
    for ev in prof.events():
        # device-side kernels and copies; GPU user annotations (the
        # optimizer's range) overlap them and are left out
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and not ev.name.startswith("Optimizer.")):
            us, cnt = agg.get(ev.name, (0.0, 0))
            agg[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    rows = sorted(((us, cnt, name) for name, (us, cnt) in agg.items()),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("  profile: no device time recorded (not measured)")
        return
    busy_ms = busy / n / 1e3
    log(f"  profile over {n} steps: device busy {busy_ms:.3f} ms per step "
        f"({wall_us / n / 1e3:.3f} ms wall under the profiler); busy share "
        f"of the unprofiled median step {busy_ms / step_ms:.3f}; top "
        f"kernels by device time:")
    for dev, count, key in rows[:top]:
        log(f"    {dev / n / 1e3:8.3f} ms/step {count // n:5d}x/step  "
            f"{100 * dev / busy:5.1f}%  {key[:90]}")


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
    if (bcsr.hybrid_spmm.launches or bcsr.tile_spmm.launches
            or bcsr.rem_scatter_.launches):
        raise SystemExit("dense path launched a BCSR kernel")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite loss: {losses}")
    log(f"  METR-LA shape: masked-MAE losses "
        f"{['%.4f' % v for v in losses]}, step times (s) "
        f"{['%.4f' % v for v in step_s]}")


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

    log("== phase 1: card and kernel build")
    smi = phase_card(torch)
    log("== phase 2: kernels against their plain versions")
    phase_kernel_cases(torch)
    log("== phase 3: DCRNNSeq training at N=50k over BCSR operators")
    report = {}
    phase_slice(torch, report)
    log("== phase 4: dense path (METR-LA shape)")
    phase_dense(torch)

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
    log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
