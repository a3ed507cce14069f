"""One run of one cell: set-up, the timed window, the traced sub-window,
the comparison that decides ``correct``, and the result.

The window drives the program's own path: ``make_index_loaders(...,
shuffle=True)`` → ``IndexLoader`` → ``DeviceWindower`` → ``BatchTrainer``
(``train_step`` a batch, captured on the card) → the model that the
configuration's family builds (``families/<family>.py``), whose graph
aggregations run through ``spmm``; ``eval_step`` over the validation loader
at each epoch's end, then one host sync, where the epoch's mean losses are
read, as ``BatchTrainer.fit`` does.  The window runs train steps, with the
epoch ends that fall among them, until ``--seconds`` have passed; it ends
with the step that passes them.  The loop is the benchmark's own, so that
it can put CUDA events and spans around each call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import check, manifest, trace
from . import traffic as traffic_lib

# top-level module names the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pytorch_geometric_temporal_tpu")
FIRST_STEPS = 3
# the traced sub-window after the window: train steps for this long
TRACE_SECONDS = 3.0
_NULL = contextlib.nullcontext()


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def _mark(what: str) -> None:
    """A set-up stage's end, as seconds since the process started."""
    print(f"set-up: {what} at {process_age_s():.2f} s", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Marks on the device's stream: CUDA events read once at the end; the
    host clock on the CPU (dry runs only)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _span(name: str, on: bool):
    if not on:
        return _NULL
    return torch.profiler.record_function(trace.SPAN_PREFIX + name)


class _Recorder:
    """Passes each batch's starts through to the program's windower and
    keeps a copy of the first few."""

    def __init__(self, windower, keep: int):
        self.windower, self.keep, self.starts = windower, keep, []

    def __call__(self, starts):
        if len(self.starts) < self.keep:
            self.starts.append(np.array(starts, dtype=np.int64, copy=True))
        return self.windower(starts)


@dataclasses.dataclass
class Program:
    trainer: object
    model: torch.nn.Module
    train: object
    val: object
    recorder: _Recorder
    names: dict             # program parameter name -> reference name
    device: torch.device
    captured: bool          # train_step and eval_step replay CUDA graphs


def build_program(family, config: dict, inputs, seed: int, device,
                  capture=None) -> Program:
    """The program on the cell's inputs, its model from ``family``;
    ``capture`` is ``BatchTrainer``'s (None: captured on the card)."""
    from pytorch_geometric_temporal_tpu_torch.data._common import (
        make_index_loaders)
    from pytorch_geometric_temporal_tpu_torch.ops import Graph
    from pytorch_geometric_temporal_tpu_torch.train import (
        BatchTrainer, ZScoreScaler)

    r = config["recipe"]
    graph = Graph.from_edge_index(
        np.stack([inputs.senders, inputs.receivers]), inputs.weights,
        num_nodes=inputs.num_nodes, device=device)
    _mark("graph on the device")
    train, val, _ = make_index_loaders(
        inputs.series, int(r["seq_len"]), int(r["batch_size"]), shuffle=True,
        ratio=tuple(config["data"]["split"]), device=device)
    _mark("loaders (the series on the device)")
    recorder = _Recorder(train.windower, FIRST_STEPS)
    train.windower = recorder
    # the port's initializers draw on the CPU from a CPU generator
    gen = torch.Generator().manual_seed(
        int(np.random.SeedSequence([int(seed), 1]).generate_state(1)[0]))
    model = family.build(config, inputs, graph, device, gen)
    _mark("model")
    scaler = ZScoreScaler(mean=torch.tensor(inputs.means, device=device),
                          std=torch.tensor(inputs.stds, device=device))
    trainer = BatchTrainer(model.module, model.forward, lr=float(r["lr"]),
                           loss_fn=model.loss(scaler), scaler=scaler,
                           device=device, capture=capture)
    dev = torch.device(device)
    captured = dev.type == "cuda" and capture is not False
    return Program(trainer, model.module, train, val, recorder, model.names,
                   dev, captured)


class _FirstSteps:
    """What the first three train steps produced, copied to the host."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.params0 = self._params()
        self.windows, self.losses = [], []
        self.exp_avg1 = self.params3 = None

    def _params(self):
        return {self.prog.names[n]: p.detach().cpu().clone()
                for n, p in self.prog.model.named_parameters()}

    def after_step(self, x, y, loss):
        i = len(self.losses)
        if i >= FIRST_STEPS:
            return
        self.windows.append((x.cpu(), y.cpu()))
        self.losses.append(loss)
        if i == 0:
            # no state after the step: the optimizer got no gradient
            state = self.prog.trainer.optimizer.state
            self.exp_avg1 = {
                self.prog.names[n]: state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)).detach().cpu().clone()
                for n, p in self.prog.model.named_parameters()}
        if i == FIRST_STEPS - 1:
            self.params3 = self._params()

    def as_record(self) -> dict:
        return {"params0": self.params0, "windows": self.windows,
                "losses": [float(v) for v in self.losses],
                "grad1": {k: v / (1.0 - check.BETA1)
                          for k, v in self.exp_avg1.items()},
                "params3": self.params3}


@dataclasses.dataclass
class _Log:
    steps: list = dataclasses.field(default_factory=list)      # marks
    losses: list = dataclasses.field(default_factory=list)
    kinds: list = dataclasses.field(default_factory=list)      # (kind, B)
    fetch_ms: list = dataclasses.field(default_factory=list)
    step_host_ms: list = dataclasses.field(default_factory=list)
    epochs: list = dataclasses.field(default_factory=list)     # mean losses
    epoch_at: list = dataclasses.field(default_factory=list)   # host s
    pos: list = dataclasses.field(default_factory=list)         # in epoch
    samples: int = 0


class _Loop:
    """The window's loop over the program, as ``BatchTrainer.fit`` runs
    it: train batches from the shuffled train loader, epoch after epoch;
    at each epoch's end the validation pass and one host sync, where the
    epoch's mean losses are read.  ``step`` runs one train step, and the
    epoch's end first where the loader has run out."""

    def __init__(self, prog: Program, clock: _Clock):
        self.prog, self.clock = prog, clock
        self.it = iter(prog.train)
        self.total = torch.zeros((), device=prog.device)
        self.n_train = 0

    def _end_epoch(self, log: _Log, spans: bool) -> None:
        trainer = self.prog.trainer
        vt, n_val = torch.zeros((), device=self.prog.device), 0
        it = iter(self.prog.val)
        while True:
            with _span("eval_fetch", spans):
                batch = next(it, None)
            if batch is None:
                break
            with _span("eval_step", spans):
                vt = vt + trainer.eval_step(*batch)
            log.kinds.append(("eval", int(batch[0].shape[0])))
            n_val += 1
        with _span("epoch_end", spans):
            log.epochs.append((float(self.total) / max(self.n_train, 1),
                               float(vt) / max(n_val, 1)))
        log.epoch_at.append(time.perf_counter())
        self.it = iter(self.prog.train)
        self.total = torch.zeros((), device=self.prog.device)
        self.n_train = 0

    def step(self, log: _Log, spans: bool = False,
             first: "_FirstSteps | None" = None) -> None:
        while True:
            m0 = self.clock.mark()
            t0 = time.perf_counter()
            with _span("fetch", spans):
                batch = next(self.it, None)
            t1 = time.perf_counter()
            if batch is not None:
                break
            self._end_epoch(log, spans)
        x, y = batch
        with _span("train_step", spans):
            loss = self.prog.trainer.train_step(x, y)
        t2 = time.perf_counter()
        log.steps.append((m0, self.clock.mark()))
        log.pos.append(self.n_train)
        log.losses.append(loss)
        log.kinds.append(("train", int(x.shape[0])))
        log.fetch_ms.append((t1 - t0) * 1e3)
        log.step_host_ms.append((t2 - t1) * 1e3)
        log.samples += int(x.shape[0])
        self.total, self.n_train = self.total + loss, self.n_train + 1
        if first is not None:
            first.after_step(x, y, loss)


def warm_shapes(prog: Program) -> None:
    """Runs each batch shape of an epoch that the first steps did not
    (the train loader's last batch; the validation loader's full and last
    batches) on windows of its split, through the program's windower:
    twice each on a captured trainer (a shape's first call runs eagerly,
    its second captures), once on an eager one."""
    calls = 2 if prog.captured else 1
    bs = prog.train.batch_size
    windower = prog.recorder.windower
    todo = []
    n = len(prog.train.indices)
    if n % bs and n > bs:
        todo.append((prog.trainer.train_step, prog.train.indices, n % bs))
    n = len(prog.val.indices)
    for size in sorted({min(n, bs), n % bs} - {0}):
        todo.append((prog.trainer.eval_step, prog.val.indices, size))
    for call, indices, size in todo:
        x, y = windower(indices[:size])
        for _ in range(calls):
            call(x, y)


def _power_limit(device) -> str:
    if device.type != "cuda":
        return "none (CPU)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({type(exc).__name__})"
    return out.stdout.strip() or "not read"


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads."""

    config: dict
    summary: trace.Summary | None      # the traced sub-window
    sub_kinds: list                    # its steps: [(kind, batch)]
    fetch_ms: list                     # the window's host spans
    step_host_ms: list
    step_ms: list                      # the window's steps (CUDA events)
    family: object                     # families/<family>.py: work
    operators: dict                    # the family's operators(inputs)


def _percentile(values, q):
    """The ``q``-th percentile by linear interpolation (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(name: str, log: _Log, step_ms: list, window_s: float,
               peak: int, setup_s: float) -> float:
    """An end-to-end metric by its name in ``BENCHMARK.json``."""
    return {"train_samples_per_s": lambda: log.samples / window_s,
            "step_ms_p90": lambda: _percentile(step_ms, 90),
            "peak_mem_gib": lambda: peak / 2**30,
            "setup_s": lambda: setup_s}[name]()


def set_up(cell: manifest.Cell, seed: int, device):
    """Inputs from the seed, the program built on them, and its first
    three train steps through the window's own loop (a captured trainer's
    first call of the shape runs eagerly, its second captures).  Returns
    (inputs, program, the loop, what the three steps produced, their
    starts)."""
    _mark("torch and the port imported")
    inputs = traffic_lib.make(cell.config, cell.traffic, seed, device)
    _mark("inputs drawn")
    capture = cell.traffic.get("capture")
    prog = build_program(cell.family, cell.config, inputs, seed, device,
                         None if capture is None else bool(capture))
    _mark("program built")
    first = _FirstSteps(prog)
    loop, warm = _Loop(prog, _Clock(prog.device)), _Log()
    for _ in range(FIRST_STEPS):
        loop.step(warm, first=first)
    _sync(prog.device)
    _mark("first steps (operators built, kernels loaded, a graph captured)")
    return (inputs, prog, loop, first.as_record(),
            prog.recorder.starts[:FIRST_STEPS])


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace_on: bool,
             device="cuda") -> dict:
    """One run; returns the result object the last line prints."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    config = cell.config
    # the configurations state f32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = bool(config["recipe"]["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["recipe"]["tf32"])

    def say(*a):
        print(*a, file=sys.stderr, flush=True)

    inputs, prog, loop, record, starts = set_up(cell, seed, device)
    warm_shapes(prog)
    _sync(device)
    _mark("every other batch shape warmed")
    log = _Log()
    t_start = time.perf_counter()
    setup_s = process_age_s()
    while True:
        loop.step(log)
        if time.perf_counter() - t_start >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_reserved(device)
            if device.type == "cuda" else 0)

    summary, sub = None, _Log()
    if trace_on:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.SUBWINDOW):
                _sync(device)
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < TRACE_SECONDS:
                    loop.step(sub, spans=True)
                _sync(device)
        summary = trace.summarize(prof)
        del prof

    step_ms = [loop.clock.ms(a, b) for a, b in log.steps]
    losses = torch.stack([v.detach().float().cpu() for v in log.losses])
    failed = int((~torch.isfinite(losses)).sum())
    ends = ", ".join(f"{t - t_start:.2f}" for t in log.epoch_at)
    say(f"window: {len(step_ms)} train steps, {log.samples} samples in "
        f"{window_s:.3f} s; epoch ends at [{ends}] s; epoch losses (train, "
        f"val) {log.epochs}")

    operators = cell.family.operators(inputs)
    # the program's state goes before the reference runs
    del prog, loop, log.losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    want = check.reference_run(cell, inputs, starts, record["params0"],
                               device)
    values = check.readings(record, want, record["params0"], inputs, starts)
    correct, checks = check.judge(values, config["limits"])

    if trace_on:
        run = Run(config, summary, sub.kinds, log.fetch_ms, log.step_host_ms,
                  step_ms, cell.family, operators)
        metrics = {}
        for m in cell.per_layer:
            value = manifest.load_metric(m["name"], cell.here).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(
            m["name"], log, step_ms, window_s, peak, setup_s),
            "unit": m["unit"]} for m in cell.end_to_end}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(step_ms),
           "failed": failed, "metrics": metrics, "device": dev}
    if trace_on and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = trace.breakdown(summary)
    med = statistics.median(step_ms)
    slow = [ms > 1.01 * med for ms in step_ms]
    bins = [0] * 20
    for i, hit in enumerate(slow):
        bins[i * 20 // len(slow)] += hit
    say("step ms percentiles " + ", ".join(
        f"p{q} {_percentile(step_ms, q):.3f}" for q in (50, 80, 90, 95, 98, 99))
        + f", mean {statistics.fmean(step_ms):.3f}; steps over 1.01 x the "
        f"median {sum(slow)} of {len(step_ms)} ("
        f"{sum(h for h, p in zip(slow, log.pos) if p == 0)} an epoch's first),"
        f" by twentieths of the window {bins}")
    say(f"card: {_power_limit(device)}; step ms max {max(step_ms):.3f}; "
        f"set-up {setup_s:.3f} s; peak reserved {peak / 2**30:.3f} GiB")
    for name, c in checks.items():
        say(f"check {name} {c['value']:.6g} limit {c['limit']:.6g}")
    out["checks"] = checks
    return out
