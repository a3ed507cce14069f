"""The full training harness: state, checkpoints, guard, timer, early stop.

Twin of the JAX package's ``examples/recurrent/harness_example.py`` (the
counterpart of a Lightning run): Chickenpox (the port's bundled file),
lags 32, train ratio 0.2, ``DCRNN(K=1)`` with 16 filters, ReLU and a linear
head, Adam 1e-2, MSE, one update per training snapshot.  It composes

- :class:`~..train.TrainState` — step, module and optimizer,
- :class:`~..train.CheckpointManager` (``max_to_keep=2``) — asynchronous
  saves after each healthy epoch and resume from the latest,
- :class:`~..train.DivergenceGuard` — a NaN or exploding epoch is rolled
  back to the state before it (parameters, optimizer moments and step),
- :class:`~..utils.StepTimer` and a validation-loss history,
- early stopping on the validation loss (``patience``, ``min_delta``).

The JAX example keeps ``prev_state = state`` as its rollback target, which
holds because its state is immutable; here the optimizer changes tensors
in place, so the target is a copy (:meth:`TrainState.snapshot`).

The JAX example jits its epoch (a ``lax.scan`` of one update a snapshot)
and its validation pass.  On the card (``capture``, the trainers' switch)
each runs here as replays of a CUDA graph that reads and writes the state's
tensors in place: the first epoch runs eagerly, the second captures the
whole epoch, every update of it, and later epochs replay; a poisoned
epoch's features enter the graph as a copy into its input.  A restore from
a checkpoint and the guard's rollback copy into the same tensors, so the
graph stays valid, and a resumed run captures its own after the restore.

    python -m pytorch_geometric_temporal_tpu_torch.protocols.harness [epochs]
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Iterable, Optional

import torch

from .._device import resolve_device
from ..data import ChickenpoxDatasetLoader
from ..models import DCRNN
from ..signal import StackedSignal, temporal_signal_split
from ..train import (CheckpointManager, DivergenceGuard, TrainState,
                     apply_gradients, mse)
from ..train.state import check_capturable
from ..train.trainer import _DeviceGraphs, _adam
from ..utils import StepTimer
from .bundled_accuracy import _Net

LAGS = 32
FILTERS = 16
LR = 1e-2
TRAIN_RATIO = 0.2


def chickenpox(lags: int = LAGS, device=None):
    """(train, val) stacked Chickenpox signals, split at ``TRAIN_RATIO``."""
    dataset = ChickenpoxDatasetLoader().get_dataset(lags=lags, device=device)
    train, val = temporal_signal_split(dataset, TRAIN_RATIO)
    return StackedSignal.from_signal(train), StackedSignal.from_signal(val)


def main(epochs: int = 20, patience: int = 10, min_delta: float = 0.0,
         ckpt_dir: Optional[str] = None, device=None, params=None,
         nan_epochs: Iterable[int] = (), log=print,
         capture: Optional[bool] = None):
    """Train with resume, guard and early stopping; returns ``(best
    validation MSE, history)``, one ``{"epoch", "train_mse", "val_mse"}``
    per healthy epoch (unrounded).

    ``ckpt_dir`` (default ``$CKPT_DIR``, else a new temporary directory)
    holds the checkpoints; a run on a directory with checkpoints resumes
    from its latest.  ``params`` is a flax parameter tree to start from in
    place of the seeded draw.  ``nan_epochs`` poisons the inputs of those
    epochs with NaN, for the guard to roll back.  ``capture``: None runs the
    epoch and the validation pass as replays of CUDA graphs on the card,
    False eagerly; True on the CPU raises.  The last line logged counts the
    graphs captured and their replays.
    """
    device = resolve_device(device)
    train, val = chickenpox(device=device)
    graph = train.graph()
    gen = torch.Generator().manual_seed(0)
    model = _Net(DCRNN(LAGS, FILTERS, K=1, device=device, generator=gen),
                 FILTERS, device, gen)
    if params is not None:
        model.params_from_flax(params)
    state = TrainState.create(model, _adam(model, LR))
    n_train = train.snapshot_count

    def predict(x):
        return model.head(model.recurrent(x, graph))

    def train_epoch(features):
        """One update per snapshot; the mean of the losses before each."""
        total = torch.zeros((), device=device)
        for t in range(n_train):
            loss = mse(predict(features[t]), train.targets[t])
            grads = torch.autograd.grad(loss, list(model.parameters()))
            apply_gradients(state, grads)
            total = total + loss.detach()
        return total / n_train

    @torch.no_grad()
    def val_loss():
        total = torch.zeros((), device=device)
        for t in range(val.snapshot_count):
            total = total + mse(predict(val.features[t]), val.targets[t])
        return total / val.snapshot_count

    # the JAX example's two jitted functions; a graph holds the state
    train_graphs = _DeviceGraphs("harness.train_epoch", capture)
    val_graphs = _DeviceGraphs("harness.val_loss", capture)
    held = (state, state.params, state.opt_state, state.step)
    if train_graphs.captures_on(device):
        check_capturable(state, "harness.train_epoch")

    ckpt_dir = ckpt_dir or os.environ.get("CKPT_DIR") or tempfile.mkdtemp(
        prefix="harness_")
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
    if mgr.restore(template=state) is not None:
        log(f"resumed from step {int(state.step)} in {ckpt_dir}")

    guard = DivergenceGuard(explode_factor=10.0)
    timer = StepTimer(items_per_step=n_train)
    history = []
    best_val, bad_epochs = float("inf"), 0
    nan_epochs = set(nan_epochs)
    for epoch in range(int(state.step) // n_train, epochs):
        prev_state = state.snapshot()  # rollback target: the whole state
        features = (train.features * float("nan") if epoch in nan_epochs
                    else train.features)
        with timer:
            # blocks for the timer
            train_mse = float(train_graphs(device, train_epoch, (features,),
                                           held))
        _, _, ok = guard.check(state.params, state.opt_state, train_mse)
        if not ok:
            # the step goes back too, or step // n_train would skew resume
            state.load_state_dict(prev_state)
            log(f"epoch {epoch}: diverged (loss {train_mse:.4f}), "
                "rolled back")
            continue
        v = float(val_graphs(device, val_loss, (), held))
        history.append({"epoch": epoch, "train_mse": train_mse,
                        "val_mse": v})
        mgr.save(int(state.step), state)
        log(f"epoch {epoch}: train {train_mse:.4f} val {v:.4f}")
        # EarlyStopping(monitor='val_loss', patience, min_delta)
        if v < best_val - min_delta:
            best_val, bad_epochs = v, 0
        else:
            bad_epochs += 1
            if bad_epochs >= patience:
                log(f"early stop at epoch {epoch} "
                    f"(no val improvement for {patience} epochs)")
                break
    mgr.close()
    log(timer.summary())
    log(f"best val MSE {best_val:.4f}; checkpoints in {ckpt_dir}")
    log(f"{train_graphs.captures + val_graphs.captures} CUDA graphs "
        f"captured, {train_graphs.replays + val_graphs.replays} replays")
    return best_val, history


if __name__ == "__main__":
    main(epochs=int(sys.argv[1]) if len(sys.argv) > 1 else 20)
