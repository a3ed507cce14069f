"""METR-LA accuracy protocol: DCRNN sequence-to-sequence training.

Counterpart of the JAX package's ``benchmarks/metrla_protocol.py``
(``_train_jax`` and ``run_parity``'s own side).  The upstream protocol
trains DCRNN on METR-LA windows (12 steps in, 12 out) and reports the
masked MAE on z-score de-normalized values.  Real METR-LA bytes are not in
the repository, so unless ``METR-LA.zip`` is staged in the data search
path :func:`load_series` generates the seeded synthetic stand-in — 207
sensors on a k-NN geometric graph with Gaussian-kernel weights, speeds
driven by a spatially correlated AR process with rush-hour congestion
profiles, ~2% missing readings (zeros, which the loss masks), plus the
time-of-day channel — and says so in its ``source``.

:func:`train` is the training loop (``DCRNNSeq(out_channels=F, K)``, Adam
1e-3, drop-last batches, one test pass); :func:`run` splits the windows
70/10/20, draws the batch schedule from ``seed + 1`` and returns the report.
Run directly for a JSON report a line: ``python -m
pytorch_geometric_temporal_tpu_torch.protocols.metrla_protocol [--init-seeds
1 2 3] [--params init.npz] [--epochs 3 --t-len 720] [--device cpu]`` — ``--init-seeds`` trains the
same series and schedule from other initial draws, ``--params`` from a flax
parameter tree saved with ``numpy.savez`` under ``a/b/c`` keys.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..data._io import available
from ..data.metr_la import METRLADatasetLoader, _dense_to_sparse
from ..models import DCRNNSeq
from ..ops.graph import Graph
from ..signal import DeviceWindower
from ..train.trainer import _adam

IN_T = 12   # input window
OUT_T = 12  # predict horizon (windows are gathered as 2·IN_T steps)

STEPS_PER_DAY = 288  # 5-minute sampling


def make_traffic_series(seed: int = 0, n: int = 207, t: int = 2880,
                        k_nn: int = 8):
    """Seeded synthetic traffic series shaped like METR-LA.

    Returns ``(series (T, N, 2) f32, edge_index (2, E), edge_weight (E,))``.
    Channel 0 is speed (mph, 0 = missing), channel 1 time-of-day in [0, 1).
    """
    rng = np.random.default_rng(seed)

    # sensor geometry -> directed k-NN graph with Gaussian kernel weights
    # (the recipe behind the real METR-LA adjacency: exp(-d²/σ²))
    pos = rng.uniform(size=(n, 2))
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    nbrs = np.argsort(d, axis=1)[:, :k_nn]
    senders = np.repeat(np.arange(n), k_nn)
    receivers = nbrs.reshape(-1)
    dist = d[senders, receivers]
    sigma = dist.std() + 1e-9
    w = np.exp(-((dist / sigma) ** 2)).astype(np.float32)
    ei = np.stack([senders, receivers]).astype(np.int64)

    # spatially correlated congestion dynamics: z[t] = ρ·(mix·z[t-1]) + ε,
    # mixed through the row-normalized adjacency so neighbours co-vary
    a = np.zeros((n, n), np.float32)
    a[senders, receivers] = w
    p = a / np.maximum(a.sum(1, keepdims=True), 1e-9)
    mix = 0.6 * np.eye(n, dtype=np.float32) + 0.4 * p

    tod = (np.arange(t) % STEPS_PER_DAY) / STEPS_PER_DAY
    rush = (np.exp(-((tod - 8 / 24) ** 2) / (2 * 0.05**2))
            + np.exp(-((tod - 17.5 / 24) ** 2) / (2 * 0.06**2)))
    amp = rng.uniform(10.0, 30.0, size=n).astype(np.float32)

    z = np.zeros((t, n), np.float32)
    eps = rng.normal(scale=1.0, size=(t, n)).astype(np.float32)
    for i in range(1, t):
        z[i] = 0.88 * (mix @ z[i - 1]) + 0.35 * eps[i]
    speed = np.clip(65.0 - rush[:, None] * amp[None, :] - 8.0 * z, 0.0, 70.0)

    # ~2% missing readings recorded as 0 (the masked-MAE null value)
    speed[rng.random(size=speed.shape) < 0.02] = 0.0

    series = np.stack(
        [speed, np.broadcast_to(tod[:, None], (t, n)).copy()], axis=-1
    ).astype(np.float32)
    return series, ei, w


def load_series(seed: int = 0, t: int = 2880, n: int = 207):
    """(data_norm (T, N, F), ei, w, means, stds, source).

    Real METR-LA when ``n == 207`` and ``METR-LA.zip`` resolves through the
    data search path (``source`` ``"metr-la"``, the whole series whatever
    ``t``; a staged file that does not parse raises); else the seeded
    synthetic stand-in (``"synthetic-seeded"``).  Both are z-scored per
    feature over the whole series, as the reference normalizes METR-LA."""
    if n == 207 and available("METR-LA.zip"):
        loader = METRLADatasetLoader(index=True)
        x, means, stds = loader._normalized_X()  # (N, F, T)
        ei, w = _dense_to_sparse(loader.A)
        return x.transpose((2, 0, 1)), ei, w, means, stds, "metr-la"
    series, ei, w = make_traffic_series(seed=seed, t=t, n=n)
    means = series.mean(axis=(0, 1))
    stds = series.std(axis=(0, 1))
    data = (series - means) / stds
    return data.astype(np.float32), ei, w, means, stds, "synthetic-seeded"


def _windows(data: np.ndarray) -> np.ndarray:
    """All window start indices; x = data[i:i+12], y = data[i+12:i+24]."""
    return np.arange(data.shape[0] - (IN_T + OUT_T) + 1)


def train(data, ei, w, means, stds, schedule, test_idx, batch_size: int,
          K: int, device=None, params=None,
          seed: int = 0) -> Tuple[float, List[float], DCRNNSeq]:
    """Train ``DCRNNSeq(out_channels=F, K)`` over ``schedule`` (one array of
    window starts per epoch, cut into drop-last batches) and return (test
    masked MAE on de-normalized values, the last batch loss of every epoch,
    the model).  ``params`` is a flax parameter tree to start from instead
    of the initial draw seeded by ``seed``."""
    device = resolve_device(device)
    n, f = data.shape[1], data.shape[2]
    g = Graph.from_edge_index(ei, np.asarray(w, np.float32), num_nodes=n,
                              device=device)
    std = torch.as_tensor(np.asarray(stds, np.float32), device=device)
    # Missing readings are masked by comparing the STORED normalized labels
    # with the normalized zero, computed in the normalization's own pure
    # f32 arithmetic; de-normalizing the labels and testing != 0 instead is
    # a floating-point knife edge (a fused multiply-add rounds differently
    # and flips mask bits).  |pred − y|·std is the de-normalized MAE with
    # the mean cancelled exactly.
    m32 = np.asarray(means, np.float32)
    s32 = np.asarray(stds, np.float32)
    norm0 = torch.as_tensor((np.float32(0.0) - m32) / s32, device=device)

    model = DCRNNSeq(f, f, K, device=device,
                     generator=torch.Generator().manual_seed(seed))
    if params is not None:
        model.params_from_flax(params)
    # x = data[i:i+12], y = data[i+12:i+24], gathered on the device
    windows = DeviceWindower(data, IN_T, device=device)

    def loss_fn(x, y):
        pred = model(x, g)
        mask = (y != norm0).to(torch.float32)
        mask = mask / torch.clamp(mask.mean(), min=1e-16)
        return torch.nan_to_num(torch.abs(pred - y) * std * mask).mean()

    optimizer = _adam(model, 1e-3)
    curve = []
    for epoch_batches in schedule:
        last = None
        for i in range(0, len(epoch_batches) - batch_size + 1, batch_size):
            x, y = windows(epoch_batches[i: i + batch_size])
            optimizer.zero_grad(set_to_none=True)
            last = loss_fn(x, y)
            last.backward()
            optimizer.step()
        curve.append(last.detach())

    maes = []
    with torch.no_grad():
        for i in range(0, len(test_idx) - batch_size + 1, batch_size):
            maes.append(loss_fn(*windows(test_idx[i: i + batch_size])))
    return (float(torch.stack(maes).mean()), [float(v) for v in curve],
            model)


def run(epochs: int = 12, batch_size: int = 64, seed: int = 0,
        t_len: int = 2880, K: int = 3, n: int = 207, device=None,
        params=None, init_seed=None) -> dict:
    """Train on the first 70% of the windows, test on the last 20%; the
    report holds the de-normalized masked test MAE (mph on the speed
    channel), the training curve and the training seconds (host clock, the
    device synchronized).  ``seed`` makes the series, the schedule and the
    initial draw; ``init_seed`` another initial draw, ``params`` a flax
    parameter tree to start from, on the same series and schedule."""
    device = resolve_device(device)
    data, ei, w, means, stds, source = load_series(seed=seed, t=t_len, n=n)
    idx = _windows(data)
    n_train = int(0.7 * len(idx))
    n_val = int(0.1 * len(idx))
    train_idx = idx[:n_train]
    test_idx = idx[n_train + n_val:]

    rng = np.random.default_rng(seed + 1)
    schedule = [rng.permutation(train_idx) for _ in range(epochs)]

    t0 = time.perf_counter()
    mae, curve, _ = train(data, ei, w, means, stds, schedule, test_idx,
                          batch_size, K, device=device, params=params,
                          seed=seed if init_seed is None else init_seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {
        "source": source,
        "epochs": epochs,
        "test_masked_mae_denorm": round(mae, 4),
        "train_curve": [round(v, 4) for v in curve],
        "seconds": time.perf_counter() - t0,
    }


def _tree_from_npz(path) -> dict:
    """The nested parameter tree of an ``.npz`` whose keys are ``a/b/c``."""
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = flat[key]
    return tree


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--t-len", type=int, default=2880)
    ap.add_argument("--device", default=None)
    ap.add_argument("--init-seeds", type=int, nargs="*", default=[None])
    ap.add_argument("--params", default=None)
    args = ap.parse_args()
    starts = [dict(init_seed=s) for s in args.init_seeds]
    if args.params is not None:
        starts.append(dict(params=_tree_from_npz(args.params)))
    for start in starts:
        rec = run(epochs=args.epochs, t_len=args.t_len, device=args.device,
                  **start)
        rec["start"] = ("parameters of " + args.params if "params" in start
                        else f"initial draw {start['init_seed'] or 0}")
        print(json.dumps(rec), flush=True)
