"""The tracing readings ``PERF.md`` records, taken on the card; not run by the
benchmark:

    python3 perfbench/idle_report.py --workload <cell> --seed <n> \
        [--window 20] [--pairs 3]

Sets the cell up as ``run.py`` does, runs its loop for ``--window`` seconds,
then ``2 × --pairs`` traced sub-windows of ``harness.TRACE_SECONDS`` each, in
turns: one as ``run.py --trace 1`` traces, with the port's spans, and one
with every span of the port the shared null context (what the spans cost
while a profiler runs).  Prints one JSON line a sub-window: its train steps
a second, whether an epoch's end fell in it, the host ms a train step
(fetch and step); with spans also the idle time by cause
(``idle.attribute``), against ``trace.summarize``'s on the same events; the
starved ms a train step under the loader's and the step's spans and the
queued ms; ``spmm_launches_per_step``; the fused kernel's device records
against the launches the step records count (the share the profiler
lost); the longest gaps; each span's mean host ms; and the port's
device-side annotations and how many of them the profiler flags as
annotations.  A last line times a span's enter and exit on the host, with
no profiler session and in one.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


@contextlib.contextmanager
def _spans_off():
    from pytorch_geometric_temporal_tpu_torch import _counters

    saved = _counters.span, _counters.step
    _counters.span = _counters.step = lambda name: _counters._NULL
    try:
        yield
    finally:
        _counters.span, _counters.step = saved


def _traced(loop, device, seconds):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import harness, trace

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sub = harness._Log()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.SUBWINDOW):
            harness._sync(device)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                loop.step(sub, spans=True)
            harness._sync(device)
            elapsed = time.perf_counter() - t0
    return prof, sub, elapsed


def readings(prof, sub, records) -> dict:
    """What one traced sub-window with spans reads."""
    import types

    from perfbench import idle, manifest, trace
    from perfbench.metrics import _common

    s, d = trace.summarize(prof), idle.attribute(prof)
    if s is None or d is None:
        return {}
    n = sum(1 for kind, _ in sub.kinds if kind == "train")
    launches = manifest.load_metric("spmm_launches_per_step").read(
        types.SimpleNamespace(sub_kinds=sub.kinds))
    fused = sum(r.counted.get("bcsr_launches", (0,))[0] for r in records)
    fused_records = sum(k for name, (_, k) in s.kernels.items()
                        if _common.SPMM_KERNELS.search(name))
    idle_s = s.window_s - s.busy_s
    mine = [e for e in prof.events() if e.name.startswith(idle.PROGRAM_PREFIX)
            and e.device_type.name == "CUDA"]
    host = {}
    for e in prof.events():
        if (e.name.startswith(idle.PROGRAM_PREFIX)
                and e.device_type.name != "CUDA"):
            h = host.setdefault(e.name[len(idle.PROGRAM_PREFIX):], [0, 0.0])
            h[0] += 1
            h[1] += (e.time_range.end - e.time_range.start) * 1e-3
    return {
        "train_steps": n, "window_s": s.window_s, "busy_s": s.busy_s,
        "idle_s": idle_s, "attributed_s": d.idle_s,
        "partition_rel_err": abs(d.idle_s - idle_s) / idle_s if idle_s else 0,
        "idle_by_span": d.idle_by_span, "queued_s": d.queued_s,
        "unattributed_s": d.unattributed_s,
        "unattributed_share": d.unattributed_s / idle_s if idle_s else 0,
        "loader_starve_ms": 1e3 * d.starved_s("loader.") / n,
        "step_starve_ms": 1e3 * d.starved_s("step.") / n,
        "launch_bubble_ms": 1e3 * d.queued_s / n,
        "spmm_launches_per_step": launches,
        "fused_launches": fused, "fused_records": fused_records,
        "lost_share": 1 - fused_records / fused if fused else None,
        "gaps": d.gaps,
        "span_ms": {k: [c, ms / c] for k, (c, ms) in sorted(host.items())},
        "program_device_annotations": len(mine),
        "flagged_as_annotations": sum(
            bool(getattr(e, "is_user_annotation", False)) for e in mine),
        "program_names_in_kernels": sorted(
            k for k in s.kernels if k.startswith(idle.PROGRAM_PREFIX)),
    }


def report(cell, seed: int, window: float, pairs: int, device,
           seconds: float | None = None) -> list:
    import torch

    from perfbench import harness
    from pytorch_geometric_temporal_tpu_torch import _counters

    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    tf32 = bool(cell.config["recipe"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    seconds = harness.TRACE_SECONDS if seconds is None else seconds
    _, prog, loop, _, _ = harness.set_up(cell, seed, device)
    harness.warm_shapes(prog)
    log, t0 = harness._Log(), time.perf_counter()
    while time.perf_counter() - t0 < window:
        loop.step(log)
    lines = []
    for i in range(2 * pairs):
        spans = (i % 4) in (0, 3)       # on, off, off, on, ...
        _counters.clear_step_records()
        with contextlib.nullcontext() if spans else _spans_off():
            prof, sub, elapsed = _traced(loop, device, seconds)
        n = sum(1 for kind, _ in sub.kinds if kind == "train")
        line = {"workload": cell.name, "seed": seed, "i": i, "spans": spans,
                "steps_per_s": n / elapsed,
                "epoch_end": any(kind == "eval" for kind, _ in sub.kinds),
                "host_ms_per_step": (sum(sub.fetch_ms) + sum(sub.step_host_ms))
                / max(n, 1), "card": harness._power_limit(device)}
        if spans:
            line.update(readings(prof, sub, _counters.step_records()))
        # the profile's events are cyclic garbage: collected here, not in
        # the next sub-window
        del prof
        gc.collect()
        print(json.dumps(line), flush=True)
        lines.append(line)
    line = {"workload": cell.name, "span_us": span_cost()}
    print(json.dumps(line), flush=True)
    lines.append(line)
    return lines


def span_cost(n: int = 20000) -> dict:
    """Host µs of one ``span`` and one ``step`` entered and left, with no
    profiler session and in a CPU-only one."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_geometric_temporal_tpu_torch import _counters

    def per(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            with fn("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    out = {"span_off": per(_counters.span), "step_off": per(_counters.step)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_on"] = per(_counters.span)
        out["step_on"] = per(_counters.step)
    _counters.clear_step_records()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--window", type=float, default=20.0)
    p.add_argument("--pairs", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE.parent))
    from perfbench import manifest, run

    run.set_caches()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    report(manifest.load_cell(args.workload), args.seed, args.window,
           args.pairs, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
