"""The comparison that decides ``correct``.

Set-up drives the program's training step from the seed through its first
three steps, through the window's own call and feed, and keeps what they
produced: the windows the loader gathered, each step's loss, Adam's first
moment after step 1 (the first gradient as the optimizer got it, times
1 − β1) and the parameters after step 3.  Once the window has closed and
the program's state is freed, the reference of the configuration's family
(``reference/<family>.py``) cuts the same windows from the benchmark's own
series, rebuilds the operators from the edge list and takes the same three
steps from the same initial parameters, with TF32 off.  The numbers
compared:

- ``windows``: the largest |program − reference| over the three batches'
  inputs and targets (exact: limit 0), and every start inside the train
  split;
- ``loss``: the largest relative gap of a step's loss;
- ``grad``: by the worst leaf, the gap between the program's and the
  reference's first-gradient norm, over the larger of the reference leaf's
  norm and the median leaf's;
- ``step``: the same for the parameters' change over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (their change under Adam is round-off).
"""

from __future__ import annotations

import contextlib
import math
import statistics

import numpy as np
import torch

NAMES = ("windows", "loss", "grad", "step")
BETA1 = 0.9
ROUNDOFF_LEAF = 1e-3


def norm_gap(got: dict, want: dict, keep=None) -> float:
    """max over leaves of | ‖got‖ − ‖want‖ | / max(‖want‖, median ‖want‖)."""
    names = [k for k in want if keep is None or k in keep]
    if not names:
        return math.inf
    wn = {k: float(torch.linalg.vector_norm(want[k].double())) for k in names}
    med = statistics.median(wn.values())
    worst = 0.0
    for k in names:
        gn = float(torch.linalg.vector_norm(got[k].double()))
        gap = abs(gn - wn[k]) / max(wn[k], med, 1e-30)
        if not math.isfinite(gn):
            gap = math.inf
        worst = max(worst, gap)
    return worst


@contextlib.contextmanager
def _tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_run(cell, inputs, starts, params0: dict, device,
                  precision: str = "float32", batch_fraction: float = 1.0):
    """The reference's three steps over the windows at ``starts`` from
    ``params0``: {"windows", "losses", "grad1", "params3"}.  ``precision``
    and ``batch_fraction`` make the control (the reference computed in
    TF32) and a planted fault (each step's loss over the first part of
    its batch); the benchmark's runs use neither."""
    ref, config = cell.family.REFERENCE, cell.config
    model, recipe = config["model"], config["recipe"]
    lags = int(recipe["seq_len"])
    # the windows are cut on the host, from the benchmark's own series
    series = torch.from_numpy(inputs.series)
    means = torch.from_numpy(inputs.means).to(device)
    stds = torch.from_numpy(inputs.stds).to(device)
    ops = ref.Operators(inputs.senders, inputs.receivers, inputs.weights,
                        inputs.num_nodes, device)
    wins, batches = [], []
    for s in starts:
        x, y = (w.to(device) for w in ref.windows(series, s, lags))
        wins.append((x, y))
        keep = max(1, int(round(x.shape[0] * batch_fraction)))
        batches.append((x[:keep], y[:keep]))
    params = {k: v.to(device) for k, v in params0.items()}
    with _tf32_off():
        losses, first, last = ref.train(
            params, ops, batches, means, stds, model, float(recipe["lr"]),
            int(config["reference"]["block"]), precision)
    return {"windows": wins, "losses": losses, "grad1": first,
            "params3": last}


def readings(got: dict, want: dict, params0: dict, inputs, starts) -> dict:
    """The four numbers for ``got`` (the program's record, or the control
    in its place) against the reference's ``want``, both
    {"windows", "losses", "grad1", "params3"}."""
    train_starts = set(inputs.starts[0].tolist())
    win_gap = 0.0
    for s, (px, py), (x, y) in zip(starts, got["windows"], want["windows"]):
        if not set(np.asarray(s).tolist()) <= train_starts:
            win_gap = math.inf
        for a, b in ((px, x), (py, y)):
            d = (a.to(b.device) - b).abs().max()
            win_gap = max(win_gap, float(torch.nan_to_num(d, nan=math.inf)))
    loss_gap = max(abs(g - w) / abs(w) if math.isfinite(g) else math.inf
                   for g, w in zip(got["losses"], want["losses"]))
    dev = next(iter(want["grad1"].values())).device
    grad_gap = norm_gap({k: v.to(dev) for k, v in got["grad1"].items()},
                        want["grad1"])
    gnorm = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in want["grad1"].items()}
    med = statistics.median(gnorm.values())
    moving = {k for k, v in gnorm.items() if v >= ROUNDOFF_LEAF * med}
    p0 = {k: v.to(dev) for k, v in params0.items()}
    step_gap = norm_gap(
        {k: got["params3"][k].to(dev) - p0[k] for k in p0},
        {k: want["params3"][k] - p0[k] for k in p0}, keep=moving)
    return {"windows": win_gap, "loss": loss_gap, "grad": grad_gap,
            "step": step_gap}


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) with every number at or under
    its limit (a NaN is over)."""
    out = {k: {"value": values[k], "limit": float(limits[k])} for k in NAMES}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out
