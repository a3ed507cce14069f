"""Training state and managed (asynchronous) checkpointing.

Port of the JAX package's ``train/state.py`` in PyTorch's idiom:

- :class:`TrainState` holds the step count (a device scalar, as in the JAX
  package), the module whose parameters are trained (``params``) and the
  ``torch.optim`` optimizer, which holds the optimizer's state
  (``opt_state``: Adam's moments and step counts, made at ``create`` as
  optax's ``init`` makes them).  Unlike the JAX pytree it is updated in
  place; :meth:`TrainState.snapshot` is the copy to take where the JAX code
  keeps a reference.
- :class:`CheckpointManager` keeps the contract of the orbax manager the
  JAX package wraps: ``save`` under ``save_interval_steps``, retention of
  the newest ``max_to_keep`` steps, restore of the latest step by default
  (None on an empty directory), ``wait``/``close`` and use as a context
  manager.  It writes with ``torch.save`` in a background thread.  Because
  the optimizer changes its tensors in place, ``save`` copies every tensor
  to the host before it returns (orbax likewise snapshots the buffers
  synchronously); only the file write overlaps the next steps.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import re
import shutil
import threading
from typing import Any, Callable, Optional, Union

import torch

STATE_FILE = "state.pt"


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied to host memory: a
    :class:`TrainState` becomes its :meth:`~TrainState.state_dict`, a module
    or an optimizer its ``state_dict()``; dicts, lists and tuples are walked;
    other leaves pass through.  Returns after the copies are complete."""
    if isinstance(tree, TrainState):
        tree = tree.state_dict()
    elif isinstance(tree, (torch.nn.Module, torch.optim.Optimizer)):
        tree = tree.state_dict()
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return type(tree)((k, to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def clone_tree(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor cloned where it lies."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return type(tree)((k, clone_tree(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def restore_into(template: Any, loaded: Any) -> Any:
    """Load ``loaded`` (as written by :func:`to_host`) into ``template``: a
    TrainState, a module or an optimizer is loaded in place and returned; a
    tensor comes back on the template's device in its dtype; containers
    are walked."""
    if isinstance(template, (TrainState, torch.nn.Module,
                             torch.optim.Optimizer)):
        template.load_state_dict(loaded)
        return template
    if isinstance(template, torch.Tensor):
        return loaded.to(template.device, template.dtype)
    if isinstance(template, dict):
        return type(template)((k, restore_into(v, loaded[k]))
                              for k, v in template.items())
    if isinstance(template, (list, tuple)):
        return type(template)(restore_into(t, v)
                              for t, v in zip(template, loaded))
    return loaded


def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Turn ``capturable`` on in each param group that has the option and
    holds CUDA parameters, as the trainers build their Adam on the card:
    its step counts then stay on the device and its ``step()`` can be
    captured in a CUDA graph.  Only before the optimizer has state; a
    group that already has state keeps its setting."""
    for group in optimizer.param_groups:
        if (group.get("capturable") is False
                and any(p.is_cuda for p in group["params"])
                and not any(optimizer.state.get(p) for p in group["params"])):
            group["capturable"] = True


def init_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Give every parameter without optimizer state its initial state now,
    as optax's ``init`` does, rather than at the first update: one
    ``step()`` on zero gradients, after which the parameters are put back
    and every state tensor is zeroed (Adam's moments and step count, SGD's
    momentum all start at zero).  A step that keeps or rolls back the state
    on the device then finds every tensor it needs before the first
    update."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    new = [p for p in params if not optimizer.state.get(p)]
    if not new:
        return
    saved = [(p, p.grad) for p in params]
    with torch.no_grad():
        values = [p.detach().clone() for p in new]
        for p in params:
            p.grad = None
        for p in new:
            p.grad = torch.zeros_like(p)
        optimizer.step()
        for p, v in zip(new, values):
            p.copy_(v)
            for t in optimizer.state[p].values():
                if isinstance(t, torch.Tensor):
                    t.zero_()
    for p, g in saved:
        p.grad = g


def check_capturable(state: "TrainState", name: str) -> None:
    """Raise unless every param group of the state's optimizer that has the
    option is ``capturable`` (a captured step needs it)."""
    off = [i for i, g in enumerate(state.opt_state.param_groups)
           if g.get("capturable") is False]
    if off:
        raise ValueError(
            f"{name}: the state's optimizer cannot be captured in a CUDA "
            f"graph: param groups {off} have capturable=False.  Build it "
            f"with capturable=True, or let TrainState.create turn it on "
            f"before the optimizer has state, or pass capture=False.")


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state: dict) -> None:
    """``optimizer.load_state_dict(state)`` that keeps the tensors the
    optimizer already holds: the loaded values are copied into them, so a
    captured step, which reads and writes them in place, stays valid.  The
    optimizer never shares a tensor with ``state``."""
    held = {p: dict(s) for p, s in optimizer.state.items()}
    optimizer.load_state_dict(clone_tree(state))
    with torch.no_grad():
        for p, old in held.items():
            now = optimizer.state[p]
            for key, t in old.items():
                v = now.get(key)
                if (isinstance(t, torch.Tensor) and isinstance(v, torch.Tensor)
                        and v.shape == t.shape and v.dtype == t.dtype):
                    t.copy_(v)
                    now[key] = t


@dataclasses.dataclass
class TrainState:
    """(step, params, optimizer) of one training run.

    ``step`` is a 0-d int32 tensor on the parameters' device, as the JAX
    state's is: an update increments it there, so a step need not sync
    with the host (read it with ``int(state.step)``).  ``params`` is the
    ``nn.Module`` whose parameters are trained (an ``nn.ParameterDict`` for
    a bare dict of tensors); ``opt_state`` is the ``torch.optim`` optimizer
    over its parameters, which holds the optimizer's state.  All three are
    updated in place by :func:`apply_gradients`.
    """

    step: torch.Tensor
    params: torch.nn.Module
    opt_state: torch.optim.Optimizer

    @staticmethod
    def create(params: torch.nn.Module,
               optimizer: Union[torch.optim.Optimizer, Callable]
               ) -> "TrainState":
        """Step 0.  ``optimizer`` is an optimizer over ``params``'
        parameters, or a factory called with them (``lambda p:
        torch.optim.Adam(p, 1e-2)``) — the counterpart of optax's
        ``optimizer.init(params)``, which this is: the optimizer's state is
        made now (:func:`init_optimizer_state`), after ``capturable`` is
        turned on for CUDA parameters (:func:`make_capturable`)."""
        if not isinstance(optimizer, torch.optim.Optimizer):
            optimizer = optimizer(params.parameters())
        first = next(params.parameters(), None)
        device = first.device if first is not None else torch.device("cpu")
        make_capturable(optimizer)
        init_optimizer_state(optimizer)
        return TrainState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          params=params, opt_state=optimizer)

    def state_dict(self) -> dict:
        """References to the live tensors: ``{"step", "params" (the module's
        state dict), "opt_state" (the optimizer's)}``."""
        return {"step": self.step, "params": self.params.state_dict(),
                "opt_state": self.opt_state.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Copy a state dict into the step, the module and the optimizer,
        in place (a captured step reads their tensors in place).  A step
        saved as an int, as before the step became a tensor, loads too.
        The optimizer never shares a tensor with ``state``."""
        self.step.copy_(torch.as_tensor(state["step"]))
        self.params.load_state_dict(state["params"])
        load_optimizer_state(self.opt_state, state["opt_state"])

    def snapshot(self) -> dict:
        """A copy of the whole state, tensors cloned where they lie; hand it
        to :meth:`load_state_dict` to roll back."""
        return clone_tree(self.state_dict())


def apply_gradients(state: TrainState, grads,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> TrainState:
    """One optimizer update from ``grads`` (a dict by parameter name, or a
    sequence in ``named_parameters()`` order); increments the step on its
    device and returns ``state``, updated in place.  ``optimizer``
    defaults to the state's and must be it when given."""
    if optimizer is not None and optimizer is not state.opt_state:
        raise ValueError("apply_gradients: the optimizer is not the state's")
    named = dict(state.params.named_parameters())
    pairs = (((named[k], g) for k, g in grads.items())
             if isinstance(grads, dict) else zip(named.values(), grads))
    for p, g in pairs:
        p.grad = None if g is None else g.to(p.dtype)
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    state.step += 1     # in place for the tensor step
    return state


def _step_dirs(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if re.fullmatch(r"\d+", d)
                  and os.path.isfile(os.path.join(directory, d, STATE_FILE)))


class CheckpointManager:
    """Asynchronous checkpoint manager for :class:`TrainState` (or any
    tree of tensors).

    ``save`` copies the state to host memory, then a background thread
    writes ``<directory>/<step>/state.pt`` (through a temporary directory
    and a rename, so a step on disk is complete) and deletes the steps
    beyond ``max_to_keep``.  A step is saved when it is past the latest
    saved step and a multiple of ``save_interval_steps``, or when no step
    was saved yet (orbax's default policy).  With ``async_save=False`` the
    write happens inside ``save``.

    Usage::

        with CheckpointManager(dir, max_to_keep=3) as mgr:
            state = mgr.restore(template=state) or state
            for ...:
                state = train_step(state, ...)
                mgr.save(int(state.step), state)
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 async_save: bool = True, save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.save_interval_steps = save_interval_steps
        self._steps = _step_dirs(self.directory)
        self._error: Optional[BaseException] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    # -- background writer ------------------------------------------------

    def _write(self, step: int, host_state, drop):
        tmp = os.path.join(self.directory, f"{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host_state, os.path.join(tmp, STATE_FILE))
        final = os.path.join(self.directory, str(step))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in drop:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def _worker(self):
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                if self._error is None:
                    self._write(*job)
            except BaseException as exc:  # re-raised by wait()/save()
                self._error = exc
            finally:
                self._queue.task_done()

    def _raise_pending_error(self):
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint write failed") \
                from exc

    # -- API ----------------------------------------------------------------

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return not self._steps or step % self.save_interval_steps == 0

    def save(self, step: int, state: Any) -> bool:
        """Queue a save of ``state`` at ``step``; returns whether a save
        was started.  Every tensor is on the host when this returns."""
        self._raise_pending_error()
        step = int(step)
        if not self.should_save(step):
            return False
        host_state = to_host(state)
        self._steps.append(step)
        drop = []
        if self.max_to_keep is not None and len(self._steps) > self.max_to_keep:
            drop = self._steps[:-self.max_to_keep]
            self._steps = self._steps[-self.max_to_keep:]
        if not self.async_save:
            self._write(step, host_state, drop)
            return True
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        self._queue.put((step, host_state, drop))
        return True

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None) -> Any:
        """Restore ``step`` (default: the latest); None when the directory
        holds no checkpoint.  With a ``template`` (a TrainState, a module,
        an optimizer or a tree of tensors) the values are loaded into it
        (see :func:`restore_into`); without one the saved tree comes back
        on the host."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        loaded = torch.load(os.path.join(self.directory, str(step),
                                         STATE_FILE), weights_only=True)
        return loaded if template is None else restore_into(template, loaded)

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def all_steps(self):
        return list(self._steps)

    def wait(self):
        """Block until the queued saves are on disk."""
        if self._thread is not None:
            self._queue.join()
        self._raise_pending_error()

    def close(self):
        self.wait()
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
