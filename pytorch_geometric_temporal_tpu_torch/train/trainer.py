"""Training loops (port of the JAX package's ``train/trainer.py``).

- :class:`SnapshotTrainer` — the snapshot-loop protocol: loss accumulated
  over ALL snapshots of a :class:`~..signal.StackedSignal`, one optimizer
  update per epoch on the mean loss (full-sequence BPTT), optional
  rematerialization per snapshot.
- :class:`BatchTrainer` — the index-batching protocol: one update per
  batch, MSE by default, or masked MAE on z-score de-normalized values
  when a scaler is given.

The optimizer is ``torch.optim.Adam`` with optax's ``adam`` defaults
(betas 0.9/0.999, eps 1e-8, no weight decay), so an update matches the JAX
trainers'.

The JAX trainers ``jax.jit`` their steps: one dispatch a batch or epoch.
Here, on CUDA, each step is captured once as a CUDA graph and replayed
(``capture=``, on by default for a CUDA trainer; ``capture=False`` runs every
operation from Python, as on the CPU).  As ``jit`` traces once a signature,
a graph is captured once for each signature of the step's inputs — tensor
shapes, strides and dtypes, and the identity of the signal an epoch reads:

- the first call with a signature runs eagerly, on a side stream: a real
  step, which also builds what the step builds once (operators, kernel
  library and attributes, Adam's state) before any capture;
- the second captures the step into a graph with its own memory pool and
  replays it;
- every later call copies its tensors into the graph's static inputs and
  replays; a signal is read in place, and the trainer holds it.

A step returns fresh tensors, not the graph's outputs.  Random draws
from PyTorch's default CUDA generator differ from replay to replay as from
step to step.  A draw from a CUDA ``torch.Generator`` of the caller's is
captured only when the trainer was handed it (``generators=``): each
replay then draws from that generator's state at the call, as the eager
step does (reseed it before a call for the same mask every step, as the
JAX step passes its key in); a draw from any other generator cannot be
captured.  A step that cannot be captured raises with the operation that
blocked it; nothing falls back to eager execution.  ``captures`` and
``replays`` count the graphs captured and the replays run.  The step
builders of ``train/precision.py`` and ``parallel/data_parallel.py`` capture
their steps the same way (:class:`_DeviceGraphs`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from .. import _counters
from .._device import resolve_device
from . import losses as losses_lib


def _adam(model: torch.nn.Module, lr: float,
          capturable: bool = False) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, capturable=capturable)


def _resolve_capture(capture: Optional[bool], device: torch.device) -> bool:
    if capture is None:
        return device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA trainer (CUDA graphs); "
                         f"this one is on {device}")
    return bool(capture)


# ---------------------------------------------------------------------------
# CUDA graphs of a step, one for each input signature
# ---------------------------------------------------------------------------


class _Id:
    """An object as a key by its identity.  The key holds the object, as
    ``jit``'s cache holds what it traced, so its id is not reused."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Id) and other.obj is self.obj


def _leaf_key(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.stride(), leaf.dtype
    try:
        hash(leaf)
    except TypeError:
        return _Id(leaf)
    return type(leaf), leaf


def _signature(args: tuple, held: tuple):
    """(key, leaves, spec) of a call: ``args``' structure, each tensor's
    shape, strides and dtype and every other leaf by value (by identity
    when unhashable), and the identity of each ``held`` object."""
    leaves, spec = pytree.tree_flatten(args)
    key = (spec, tuple(_leaf_key(v) for v in leaves),
           tuple(_Id(o) for o in held))
    return key, leaves, spec


def _static_like(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A buffer on ``device`` that the step sees as it would see ``t``
    there: a CUDA view keeps its strides (an index loader's windows are
    views), a host tensor takes the layout ``.to(device)`` gives it."""
    if t.device == device and 0 not in t.stride():
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                   device=device)
    return torch.empty_like(t, device=device)


def _not_capturable(name: str, exc: BaseException) -> RuntimeError:
    """The error for a step whose capture failed; it is raised from
    ``exc``, whose traceback shows the operation that blocked it."""
    text = (str(exc).strip().splitlines() or [""])[0]
    return RuntimeError(
        f"{name}: the step cannot be captured as a CUDA graph "
        f"({type(exc).__name__}: {text}); the traceback above shows the "
        f"operation that blocked it.  Pass capture=False to run the step "
        f"eagerly.")


class _Graph:
    __slots__ = ("graph", "statics", "out", "counted")

    def __init__(self, graph, statics, out, counted):
        self.graph, self.statics = graph, statics
        self.out, self.counted = out, counted


def _clone(tree):
    return pytree.tree_map_only(torch.Tensor, torch.Tensor.clone, tree)


def _step_name(name: str) -> str:
    """A step's name in its span and record: the step function's own name
    (``BatchTrainer.train_step`` -> ``train_step``)."""
    return name.rsplit(".", 1)[-1]


class _StepGraphs:
    """The CUDA graphs of one step function, one for each signature of its
    inputs (the counterpart of ``jax.jit``'s cache of compiled programs)."""

    def __init__(self, name: str, device: torch.device,
                 stream: torch.cuda.Stream, generators=()):
        self.name, self.device, self.stream = name, device, stream
        self.step = _step_name(name)
        self.generators = tuple(generators)
        self.warm = set()
        self.graphs = {}
        self.replays = 0

    def __call__(self, fn: Callable, args: tuple, held: tuple = ()):
        """``fn(*args)`` → a tree of tensors, returned as fresh tensors.
        ``args``' tensors are copied into the graph's static inputs;
        ``held`` objects are read and written in place, so their identity
        is part of the signature."""
        span = _counters.span
        with _counters.step(self.step):
            key, leaves, spec = _signature(args, held)
            entry = self.graphs.get(key)
            if entry is None:
                if key not in self.warm:
                    self.warm.add(key)
                    with span("step.warm"):
                        return self._eager(fn, args)
                with span("step.capture"):
                    entry = self.graphs[key] = self._capture(fn, leaves, spec)
            with span("step.copy_in"):
                for static, t in zip(entry.statics, leaves):
                    if static is not None:
                        static.copy_(t)
            with span("step.replay"):
                entry.graph.replay()
                _counters.add(entry.counted)
            self.replays += 1
            with span("step.clone_out"):
                return _clone(entry.out)

    def _eager(self, fn, args):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn(*args)
        current.wait_stream(self.stream)
        return out

    def _capture(self, fn, leaves, spec) -> _Graph:
        statics = [_static_like(t, self.device)
                   if isinstance(t, torch.Tensor) else None for t in leaves]
        for static, t in zip(statics, leaves):
            if static is not None:
                static.copy_(t)
        args = pytree.tree_unflatten(
            [t if s is None else s for s, t in zip(statics, leaves)], spec)
        before = _counters.read()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            # a replay reads the generator's seed and offset at its call
            # and advances the offset by what the graph draws
            graph.register_generator_state(gen)
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                out = fn(*args)
        except Exception as exc:
            raise _not_capturable(self.name, exc) from exc
        finally:
            # the capture called the kernels' wrappers and the collectives,
            # which counted work that did not run
            counted = _counters.counted_since(before)
            _counters.add(counted, -1)
        out = pytree.tree_map_only(torch.Tensor, torch.Tensor.detach, out)
        return _Graph(graph, statics, out, counted)


class _DeviceGraphs:
    """The graphs of a step function that a builder returns before it
    knows its device: at each call the state's device decides, as a
    trainer's device does, whether the call captures (``capture=None``:
    on CUDA; True on the CPU raises), and each CUDA device gets its own
    :class:`_StepGraphs` at its first call."""

    def __init__(self, name: str, capture: Optional[bool]):
        self.name, self.capture = name, capture
        self.step = _step_name(name)
        self._graphs = {}

    def captures_on(self, device: torch.device) -> bool:
        return _resolve_capture(self.capture, device)

    def __call__(self, device: torch.device, fn: Callable, args: tuple,
                 held: tuple = ()):
        """``fn(*args)``, eagerly or through the device's graphs."""
        if not self.captures_on(device):
            with _counters.step(self.step):
                return fn(*args)
        graphs = self._graphs.get(device)
        if graphs is None:
            graphs = self._graphs[device] = _StepGraphs(
                self.name, device, torch.cuda.Stream(device))
        return graphs(fn, args, held)

    @property
    def captures(self) -> int:
        """CUDA graphs captured so far."""
        return sum(len(g.graphs) for g in self._graphs.values())

    @property
    def replays(self) -> int:
        """Graph replays run so far."""
        return sum(g.replays for g in self._graphs.values())


class _Captures:
    """The trainers' side of the graphs: one :class:`_StepGraphs` a step
    function, sharing the side stream, with their counts summed."""

    def _init_capture(self, capture: Optional[bool], names,
                      generators=()) -> None:
        self.capture = _resolve_capture(capture, self.device)
        self._graphs = None
        if self.capture:
            stream = torch.cuda.Stream(self.device)
            self._graphs = {n: _StepGraphs(f"{type(self).__name__}.{n}",
                                           self.device, stream, generators)
                            for n in names}

    @property
    def captures(self) -> int:
        """CUDA graphs captured so far (0 when not capturing)."""
        return sum(len(g.graphs) for g in (self._graphs or {}).values())

    @property
    def replays(self) -> int:
        """Graph replays run so far (0 when not capturing)."""
        return sum(g.replays for g in (self._graphs or {}).values())


class SnapshotTrainer(_Captures):
    """Full-BPTT snapshot-loop training, one Adam update per epoch.

    Args:
        model: the module whose parameters are trained; moved to ``device``.
        loss_and_state_fn: ``(carry, x, y, graph) -> (loss, carry)`` called
            per snapshot; ``carry`` threads recurrent state across
            snapshots (``()`` or None if stateless).
        lr: Adam learning rate.
        remat: run each snapshot under ``torch.utils.checkpoint`` so the
            backward pass recomputes its activations (memory O(1) in T).
        device: where the model lives (CUDA unless given "cpu").
        capture: run :meth:`train_epoch` and :meth:`evaluate` as replays of
            CUDA graphs (default: on for a CUDA trainer; True on the CPU
            raises).  A graph reads the signal in place and copies
            ``init_carry``'s tensors.
    """

    def __init__(self, model: torch.nn.Module, loss_and_state_fn: Callable,
                 lr: float = 1e-2, remat: bool = False, device=None,
                 capture: Optional[bool] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = _adam(self.model, lr,
                               capturable=self.device.type == "cuda")
        if remat:
            def step(carry, x, y, g):
                return checkpoint(loss_and_state_fn, carry, x, y, g,
                                  use_reentrant=False)
        else:
            step = loss_and_state_fn
        self._step = step
        self._init_capture(capture, ("train_epoch", "evaluate"))

    def _epoch_loss(self, signal, init_carry):
        def body(carry, x, y, g):
            state, acc = carry
            loss, state = self._step(state, x, y, g)
            return (state, acc + loss), ()

        zero = torch.zeros((), device=self.device)
        (state, total), _ = signal.scan(body, (init_carry, zero))
        return total / signal.snapshot_count, state

    def _train(self, signal, init_carry):
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self._epoch_loss(signal, init_carry)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_epoch(self, signal, init_carry=()) -> torch.Tensor:
        """One update on the mean loss over the signal's snapshots;
        returns that (detached, on-device) loss."""
        if self._graphs is None:
            with _counters.step("train_epoch"):
                return self._train(signal, init_carry)
        return self._graphs["train_epoch"](
            lambda carry: self._train(signal, carry), (init_carry,),
            held=(signal,))

    @torch.no_grad()
    def evaluate(self, signal, init_carry=()) -> torch.Tensor:
        """Mean loss over the signal's snapshots, no update."""
        def run(carry):
            return self._epoch_loss(signal, carry)[0]

        if self._graphs is None:
            with _counters.step("evaluate"):
                return run(init_carry)
        return self._graphs["evaluate"](run, (init_carry,), held=(signal,))

    def fit(self, signal, epochs: int, init_carry=(),
            callback: Optional[Callable] = None, log_every: int = 1):
        """Run ``epochs`` updates.  The callback receives, every
        ``log_every`` epochs, the index of the last epoch and its
        on-device loss — ``float()`` it only if you want to block."""
        log_every = max(log_every, 1)
        for epoch in range(epochs):
            loss = self.train_epoch(signal, init_carry)
            if callback is not None and (
                    (epoch + 1) % log_every == 0 or epoch + 1 == epochs):
                callback(epoch, loss)
        return self.model


class BatchTrainer(_Captures):
    """Per-batch training of ``model``.

    Args:
        model: the module whose parameters are trained; moved to ``device``.
        apply_fn: ``x_batch -> predictions`` (e.g. ``lambda x: model(x,
            ops)``); defaults to ``model``.
        lr: Adam learning rate.
        loss_fn: ``(pred, target) -> scalar``; defaults to masked MAE on
            de-normalized values when a scaler is given, else MSE.
        scaler: optional ZScoreScaler applied inversely before the loss.
        device: where batches go (CUDA unless given "cpu").
        capture: run :meth:`train_step` and :meth:`eval_step` as replays of
            CUDA graphs (default: on for a CUDA trainer; True on the CPU
            raises); a batch of a new shape is captured anew.
        generators: CUDA ``torch.Generator`` objects the step draws from
            (a dropout mask's), registered with each graph it captures, so
            a replay draws what the eager step would draw from the
            generator's state at the call.
    """

    def __init__(self, model: torch.nn.Module,
                 apply_fn: Optional[Callable] = None, lr: float = 1e-3,
                 loss_fn: Optional[Callable] = None, scaler=None,
                 device=None, capture: Optional[bool] = None,
                 generators=()):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.apply_fn = apply_fn if apply_fn is not None else self.model
        self.optimizer = _adam(self.model, lr,
                               capturable=self.device.type == "cuda")
        if loss_fn is None:
            if scaler is not None:
                def loss_fn(pred, target):
                    return losses_lib.masked_mae_loss(
                        scaler.inverse(pred), scaler.inverse(target))
            else:
                loss_fn = losses_lib.mse
        self.loss_fn = loss_fn
        self._init_capture(capture, ("train_step", "eval_step"), generators)

    def _train(self, x, y):
        span = _counters.span
        x, y = x.to(self.device), y.to(self.device)
        self.optimizer.zero_grad(set_to_none=True)
        with span("step.forward"):
            loss = self.loss_fn(self.apply_fn(x), y)
        with span("step.backward"):
            loss.backward()
        with span("step.optimizer"):
            self.optimizer.step()
        return loss.detach()

    def _eval(self, x, y):
        x, y = x.to(self.device), y.to(self.device)
        with _counters.span("step.forward"):
            return self.loss_fn(self.apply_fn(x), y)

    def train_step(self, x, y) -> torch.Tensor:
        """One update; returns the (detached, on-device) batch loss."""
        if self._graphs is None:
            with _counters.step("train_step"):
                return self._train(x, y)
        return self._graphs["train_step"](self._train, (x, y))

    @torch.no_grad()
    def eval_step(self, x, y) -> torch.Tensor:
        if self._graphs is None:
            with _counters.step("eval_step"):
                return self._eval(x, y)
        return self._graphs["eval_step"](self._eval, (x, y))

    def fit(self, loader, epochs: int, val_loader=None,
            callback: Optional[Callable] = None):
        """Per-batch training loop.  Losses accumulate on the device; the
        host syncs once per epoch, at the callback."""
        for epoch in range(epochs):
            total, nb = torch.zeros((), device=self.device), 0
            for x, y in loader:
                total = total + self.train_step(x, y)
                nb += 1
            val = None
            if val_loader is not None:
                vt, vn = torch.zeros((), device=self.device), 0
                for x, y in val_loader:
                    vt = vt + self.eval_step(x, y)
                    vn += 1
                val = float(vt) / max(vn, 1)
            if callback is not None:
                callback(epoch, float(total) / max(nb, 1), val)
        return self.model
