"""Profiling and observability utilities.

Port of the JAX package's ``utils/profiling.py``: a step timer with
throughput accounting, a ``torch.profiler`` trace context that writes a
trace file, host and device memory statistics, and a per-iteration device
time that cancels fixed per-call cost (timed with CUDA events on the
card).
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
import torch


class StepTimer:
    """Wall-clock step timing with rolling throughput.

    Usage::

        timer = StepTimer(items_per_step=batch * seq_len)
        for batch in loader:
            with timer:
                loss = float(train_step(...))   # must block on the result
        print(timer.summary())
    """

    def __init__(self, items_per_step: int = 1, warmup: int = 1):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def steps(self) -> int:
        return len(self.times)

    def mean_step_time(self) -> float:
        t = self.times[self.warmup:] or self.times
        return sum(t) / max(len(t), 1)

    def throughput(self) -> float:
        m = self.mean_step_time()
        return self.items_per_step / m if m > 0 else 0.0

    def summary(self) -> str:
        return (
            f"{self.steps} steps, {self.mean_step_time() * 1e3:.2f} ms/step, "
            f"{self.throughput():.1f} items/s"
        )

    def write_csv(self, path: str):
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["step", "seconds"])
            for i, t in enumerate(self.times):
                w.writerow([i, t])


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block (host, and the card's kernels
    when CUDA is available); on exit the Chrome-format trace is written to
    ``log_dir/trace_<pid>_<ns>.json`` (view in Perfetto or
    ``chrome://tracing``).  Yields the profiler, whose ``key_averages()``
    can be read after the block.

    The trace carries the port's spans beside the device's records, on
    the same clock: ``pgtt.loader.*`` inside the index loaders' batches and
    ``pgtt.step.<fn>`` around each step call, with ``step.warm`` /
    ``step.capture`` / ``step.copy_in`` / ``step.replay`` /
    ``step.clone_out`` inside a captured step and ``step.forward`` /
    ``step.backward`` / ``step.optimizer`` inside an eager one (the list:
    ``_counters``).  Each step call in the block also leaves its counts in
    ``_counters.step_records()`` (the fused kernel's launches, collective
    bytes).  With no profiler running a span costs one check."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_memory_stats(device=None) -> dict:
    """Memory statistics of a CUDA device in bytes, under XLA's key names:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (tensors allocated now and
    at the peak), ``bytes_reserved`` (held by the caching allocator) and
    ``bytes_limit`` (the device's memory).  ``{}`` for a CPU device, and
    when ``device`` is None and CUDA is not available."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


def host_memory_stats() -> dict:
    """Host process memory (bytes): current and peak RSS.

    Reads ``/proc/self/status`` (Linux); returns an empty dict elsewhere.
    """
    out = {}
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    out["rss"] = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    out["peak_rss"] = int(line.split()[1]) * 1024
    except OSError:  # pragma: no cover - non-Linux
        pass
    return out


def _on_cuda(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(t) for t in tree)
    return False


def device_time_per_iter(fn, x, iters: int = 400, lo_frac: float = 0.25,
                         reps: int = 3, operands=()) -> float:
    """Seconds per iteration of ``x -> fn(x, *operands)``, with the fixed
    cost of a run cancelled.

    Runs the loop ``a = fn(a, *operands)`` at two lengths, ``iters`` and
    ``lo = iters * lo_frac``, and takes the slope
    ``(T(iters) - T(lo)) / (iters - lo)`` of the best of ``reps`` timings
    of each, so what a run costs whatever its length drops out.  On CUDA
    tensors each run is timed with CUDA events, on the CPU with the host
    clock.  ``fn`` must return what it takes (shape-preserving) and keep it
    finite across the loop; it runs under ``torch.no_grad``.
    """
    lo = max(int(iters * lo_frac), 1)
    cuda = _on_cuda(x) or _on_cuda(operands)

    def run(n):
        a = x
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                a = fn(a, *operands)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            a = fn(a, *operands)
        return time.perf_counter() - t0

    with torch.no_grad():
        run(iters)  # warm-up: allocator, library handles, kernel builds
        t_hi = t_lo = float("inf")
        for _ in range(reps):
            t_hi = min(t_hi, run(iters))
            t_lo = min(t_lo, run(lo))
    return max(t_hi - t_lo, 1e-12) / (iters - lo)
