"""The one traffic generator: a cell's series, sensor graph and window split,
all drawn from ``--seed``.

A configuration (``configs/<name>.json``) fixes the deployment: the sensor
count, the features, the graph's degree and band, the series' shape and
length.  A traffic mix (``workloads/<name>.json``) fixes how the run feeds
it: whether sensor ids are scrambled, whether the trainer captures.  Both
are data; this file reads them, and a new cell adds files, not code.

The stand-in follows the all-California PeMS stand-in of the reference
repository's index-batching example: per sensor a base speed, a daily
sine and Gaussian noise, clipped to the speed range, beside the time of
day; a banded graph of ``degree`` edges a sensor to sensors within
``±offset``.  Every seed gives the same sizes; only the values, the
graph's edges and the scrambling permutation change.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# time steps drawn and z-scored at a time: a block of about 180 MB at
# 11,160 sensors, so the device holds the series and little more
CHUNK_STEPS = 2048


@dataclasses.dataclass
class Inputs:
    """What the benchmark hands to both the program and the reference."""

    series: np.ndarray      # (T, N, F) f32, z-scored per feature
    means: np.ndarray       # (F,) f32
    stds: np.ndarray        # (F,) f32
    senders: np.ndarray     # (E,) int64
    receivers: np.ndarray   # (E,) int64
    weights: np.ndarray     # (E,) f32
    num_nodes: int
    starts: tuple           # (train, val, test) window starts, int64


def _seeds(seed: int, n: int):
    return np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)


def series_length(data: dict) -> int:
    return int(data["series_days"]) * int(data["steps_per_day"])


def split_starts(length: int, lags: int, ratio) -> tuple:
    """The window starts of the train, validation and test splits: every
    start that leaves ``2·lags`` steps, cut 70/10/20 in time order as the
    index-batching recipe cuts them."""
    starts = np.arange(length - (2 * lags - 1), dtype=np.int64)
    n = starts.shape[0]
    n_train = round(n * ratio[0])
    n_test = round(n * ratio[2])
    return starts[:n_train], starts[n_train:n - n_test], starts[n - n_test:]


def _draw(data: dict, t: int, seed: int, device) -> torch.Tensor:
    """The raw (T, N, 2) series on ``device``: per sensor a base speed, a
    daily sine and Gaussian noise, clipped, beside the time of day; drawn
    ``CHUNK_STEPS`` steps at a time from one generator."""
    n, spd = int(data["num_nodes"]), int(data["steps_per_day"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lo, hi = data["speed_range"]
    base = lo + (hi - lo) * torch.rand(n, generator=gen, device=device)
    raw = torch.empty((t, n, 2), dtype=torch.float32, device=device)
    for a in range(0, t, CHUNK_STEPS):
        b = min(a + CHUNK_STEPS, t)
        tod = (torch.arange(a, b, device=device) % spd).to(torch.float64) / spd
        noise = torch.randn((b - a, n), generator=gen, device=device)
        raw[a:b, :, 0] = (base[None, :] - data["daily_amplitude"]
                          * torch.sin(2 * np.pi * tod).float()[:, None]
                          + data["noise_std"] * noise).clamp(
                              *data["speed_clip"])
        raw[a:b, :, 1] = tod.float()[:, None]
    return raw


def _zscore_(raw: torch.Tensor, inverse=None):
    """Z-scores ``raw`` in place per feature (mean and population std in
    float64, each value computed in float64 and rounded to f32), applying
    the column permutation ``inverse`` on the way.  Returns (means, stds)."""
    t = raw.shape[0]
    count = t * raw.shape[1]
    total = torch.zeros(raw.shape[-1], dtype=torch.float64, device=raw.device)
    for a in range(0, t, CHUNK_STEPS):
        total += raw[a:a + CHUNK_STEPS].sum(dim=(0, 1), dtype=torch.float64)
    means = total / count
    sq = torch.zeros_like(total)
    for a in range(0, t, CHUNK_STEPS):
        sq += ((raw[a:a + CHUNK_STEPS].double() - means) ** 2).sum(dim=(0, 1))
    stds = torch.sqrt(sq / count)
    for a in range(0, t, CHUNK_STEPS):
        block = raw[a:a + CHUNK_STEPS]
        if inverse is not None:
            block = block[:, inverse]
        raw[a:a + CHUNK_STEPS] = ((block.double() - means) / stds).float()
    return means.cpu().numpy(), stds.cpu().numpy()


def make(config: dict, traffic: dict, seed: int, device) -> Inputs:
    """Draw a cell's inputs from ``seed``.  The series is drawn and
    z-scored on ``device``, in blocks, and handed over as a host array
    (the loaders take one); the device's copy is freed."""
    data = config["data"]
    n = int(data["num_nodes"])
    t = series_length(data)
    s_graph, s_series, s_sigma = _seeds(seed, 3)

    rng = np.random.default_rng(int(s_graph))
    deg, off = int(data["degree"]), int(data["offset"])
    s = np.repeat(np.arange(n, dtype=np.int64), deg)
    r = np.clip(s + rng.integers(-off, off + 1, size=s.shape[0]), 0, n - 1)
    w = rng.uniform(*data["weight_range"], s.shape[0]).astype(np.float32)

    raw = _draw(data, t, s_series, device)
    inverse = None
    if traffic.get("scramble_ids", False):
        # sensor ids as they come in a real deployment: one seeded
        # permutation σ of the ids, edges (σ[s], σ[r]), columns
        # series[:, σ[i]] = series[:, i], i.e. series[:, j] = the ordered
        # series[:, σ⁻¹[j]]
        sigma = np.random.default_rng(int(s_sigma)).permutation(n)
        s, r = sigma[s], sigma[r]
        inverse = torch.as_tensor(np.argsort(sigma), device=raw.device)
    means, stds = _zscore_(raw, inverse)
    series = raw.cpu().numpy()
    del raw
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    lags = int(config["recipe"]["seq_len"])
    return Inputs(series=series, means=means.astype(np.float32),
                  stds=stds.astype(np.float32), senders=s, receivers=r,
                  weights=w, num_nodes=n,
                  starts=split_starts(t, lags, data["split"]))
