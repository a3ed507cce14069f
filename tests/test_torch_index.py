"""Port parity of index batching (``signal/index_dataset.py``,
``data/_common.make_index_loaders``) against the JAX package's.

Every window is a pure gather, so the two packages must agree bitwise: the
same arrays, dtypes and batch order for the same inputs, seed, shuffle,
``drop_last``, ``world_size`` and ``rank``.  Also here: the host-side start
validation, a streaming epoch's bounded RSS on a 48 MB file (the JAX
package's test uses 192 MB), and ``BatchTrainer.fit`` over an
``IndexLoader`` against the JAX package's from the same flax parameters.
"""

import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu import signal as jsig
from pytorch_geometric_temporal_tpu.data import _common as jcommon
from pytorch_geometric_temporal_tpu_torch import signal as tsig
from pytorch_geometric_temporal_tpu_torch.data import _common as tcommon

H = 4


def series(rng, t=60, n=5, f=2, dtype=np.float32):
    return rng.normal(size=(t, n, f)).astype(dtype)


def same(got, want):
    """Port tensor (or array) equals the JAX array: dtype, shape, bits."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def small_npy(tmp_path_factory):
    path = tmp_path_factory.mktemp("idx") / "series.npy"
    np.save(path, series(np.random.default_rng(3), t=80))
    return path


@pytest.mark.parametrize("lazy", [False, True])
def test_index_dataset_matches(small_npy, lazy):
    idx = np.array([0, 7, 80 - 2 * H, 3])
    data = small_npy if lazy else np.load(small_npy)
    got = tsig.IndexDataset(idx, data, H, lazy=lazy)
    want = jsig.IndexDataset(idx, data, H, lazy=lazy)
    assert len(got) == len(want) == 4
    assert isinstance(got.data, np.memmap) == lazy
    for i in range(len(idx)):
        for a, b in zip(got[i], want[i]):
            same(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64,
                                   np.int32, np.float16])
def test_device_windower_matches(rng, dtype):
    data = (series(rng) * 10).astype(dtype)
    got = tsig.DeviceWindower(data, H, device="cpu")
    want = jsig.DeviceWindower(data, H)
    for idx in ([0, 5, 60 - 2 * H], [17], np.arange(30)):
        for a, b in zip(got(np.asarray(idx)), want(np.asarray(idx))):
            same(a, b)


def test_device_windower_narrows_64_bit_types():
    # the JAX package's arrays are 32-bit with its 64-bit mode off
    x, _ = tsig.DeviceWindower(np.zeros((10, 2)), 2, device="cpu")([0])
    assert x.dtype == torch.float32
    x, _ = tsig.DeviceWindower(np.zeros((10, 2), np.int64), 2,
                               device="cpu")([0])
    assert x.dtype == torch.int32


@pytest.mark.parametrize("starts,match", [
    ([0, 80 - 2 * H + 1], "overruns"),
    ([3, -2], "negative window start"),
])
def test_windowers_validate_starts_on_the_host(small_npy, starts, match):
    starts = np.array(starts)
    dev = tsig.DeviceWindower(np.load(small_npy), H, device="cpu")
    stream = tsig.StreamingWindower(small_npy, H, device="cpu")
    for call in (dev, stream.host_batch, stream):
        with pytest.raises(ValueError, match=match):
            call(starts)


def test_streaming_matches_device_windower_and_jax(small_npy):
    full = np.load(small_npy)
    dev = tsig.DeviceWindower(full, H, device="cpu")
    stream = tsig.StreamingWindower(small_npy, H, device="cpu",
                                    reopen_every=2)
    jstream = jsig.StreamingWindower(small_npy, H, reopen_every=2)
    assert stream.shape == jstream.shape and stream.dtype == jstream.dtype
    held = []
    for idx in ([0, 3, 50], [9, 1, 2], [80 - 2 * H, 0, 4]):
        idx = np.asarray(idx)
        got = stream(idx)
        held.append((idx, got))
        for a, b in zip(got, dev(idx)):
            same(a, b.numpy())
        for a, b in zip(got, jstream(idx)):
            same(a, b)
        np.testing.assert_array_equal(stream.host_batch(idx),
                                      jstream.host_batch(idx))
    # every batch is the caller's own: the next call reuses the host buffer
    for idx, (x, y) in held:
        same(x, dev(idx)[0])
        same(y, dev(idx)[1])


def test_load_time_shard_matches(small_npy):
    indices = np.arange(80 - 2 * H + 1)[1::2][:10]
    for lazy in (True, False):
        got, g_shift = tsig.load_time_shard(small_npy, indices, H, lazy=lazy)
        want, w_shift = jsig.load_time_shard(small_npy, indices, H,
                                             lazy=lazy)
        assert isinstance(got, np.memmap) == lazy
        same(np.asarray(got), np.asarray(want))
        same(g_shift, w_shift)
    with pytest.raises(ValueError, match="at least one index"):
        tsig.load_time_shard(small_npy, np.array([], dtype=np.int64), H)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("world_size,rank", [(1, 0), (3, 0), (3, 2),
                                             (4, 1)])
def test_index_loader_order_and_len_match(rng, shuffle, drop_last,
                                          world_size, rank):
    data = series(rng, t=101, n=3, f=1)
    indices = np.arange(101 - 2 * H + 1)
    kw = dict(batch_size=8, shuffle=shuffle, seed=5, drop_last=drop_last,
              world_size=world_size, rank=rank)
    got = tsig.IndexLoader(indices, tsig.DeviceWindower(data, H,
                                                        device="cpu"), **kw)
    want = jsig.IndexLoader(indices, jsig.DeviceWindower(data, H), **kw)
    for _ in range(3):
        batches = list(got)
        jbatches = list(want)
        assert len(got) == len(batches) == len(jbatches) == len(want)
        for (x, y), (jx, jy) in zip(batches, jbatches):
            same(x, jx)
            same(y, jy)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True), dict(shuffle=False, drop_last=False),
    dict(shuffle=True, world_size=2, rank=1, drop_last=False),
])
def test_iter_index_batches_matches(kw):
    indices = np.arange(3, 40)
    got = list(tsig.iter_index_batches(
        indices, 6, rng=np.random.default_rng(2), **kw))
    want = list(jsig.iter_index_batches(
        indices, 6, rng=np.random.default_rng(2), **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        same(a, b)


@pytest.mark.parametrize("kw", [
    dict(shuffle=False),
    dict(shuffle=True, ratio=(0.6, 0.2, 0.2)),
    dict(shuffle=True, world_size=2, rank=1),
    dict(shuffle=False, world_size=0, rank=-1),
])
def test_make_index_loaders_match(rng, kw):
    data = series(rng, t=90, n=4, f=2, dtype=np.float64)
    got = tcommon.make_index_loaders(data, H, 5, device="cpu", **kw)
    want = jcommon.make_index_loaders(data, H, 5, **kw)
    for tl, jl in zip(got, want):
        same(tl.indices, jl.indices)
        for _ in range(2):
            jb = list(jl)
            tb = list(tl)
            assert len(tb) == len(jb) == len(jl) == len(tl)
            for (x, y), (jx, jy) in zip(tb, jb):
                same(x, jx)
                same(y, jy)


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


def test_streaming_epoch_bounded_rss(tmp_path):
    """A whole epoch over a 48 MB file keeps the process RSS growth, from
    the first batch on (its 3 MB buffer is then allocated), well below the
    file: about the pages mapped between re-opens (2 batches · 8 windows ·
    384 KB); read 3.7 MB, limit 0.45 of the file as in the JAX package's
    test."""
    T, N, F, h = 3000, 2000, 2, 12
    path = tmp_path / "series.npy"
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=(T, N, F))
    for lo in range(0, T, 250):
        t = np.arange(lo, min(lo + 250, T), dtype=np.float32)
        mm[lo : lo + 250] = (t[:, None, None]
                             + np.arange(N, dtype=np.float32)[None, :, None]
                             ) % 97.0
    mm.flush()
    del mm
    file_bytes = T * N * F * 4
    windower = tsig.StreamingWindower(path, h, device="cpu", reopen_every=2)
    indices = np.arange(T - 2 * h + 1)
    rss0 = None
    peak_delta, total, nb = 0, 0.0, 0
    for batch in tsig.iter_index_batches(indices, 8, shuffle=True,
                                         drop_last=True):
        win = windower.host_batch(batch)
        assert win.shape == (8, 2 * h, N, F)
        total += float(win[0, 0, 0, 0]) + float(win[-1, -1, -1, -1])
        nb += 1
        rss0 = _rss() if rss0 is None else rss0
        peak_delta = max(peak_delta, _rss() - rss0)
    assert nb == len(indices) // 8
    assert np.isfinite(total)
    assert peak_delta < file_bytes * 0.45, (
        f"RSS grew {peak_delta / 1e6:.0f} MB on a {file_bytes / 1e6:.0f} MB "
        f"file")


def test_batch_trainer_over_index_loader_matches_jax():
    """``BatchTrainer.fit`` over ``make_index_loaders``' loaders (N=30 on
    the dense branch, T=200, lags 4, batches of 8, shuffled, masked MAE on
    de-normalized values) from the JAX run's initial parameters: every
    epoch's train and validation loss within 1e-5 relative of the JAX
    package's (read: 5.1e-7 at most; f32 sums in another order)."""
    import jax
    import optax

    from pytorch_geometric_temporal_tpu import models as jmodels
    from pytorch_geometric_temporal_tpu import ops as jops
    from pytorch_geometric_temporal_tpu import train as jtrain
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import Graph
    from pytorch_geometric_temporal_tpu_torch.train import (
        BatchTrainer, ZScoreScaler)

    torch.set_num_threads(1)
    rng = np.random.default_rng(11)
    n, t, f, lags, bs, epochs = 30, 200, 2, 4, 8, 2
    # no reading is 0: whether a de-normalized 0 comes back as exactly 0
    # (and is masked) depends on how each framework rounds y·std + mean
    tod = (np.arange(t) % 24 + 0.5) / 24.0
    raw = np.stack([rng.uniform(20.0, 70.0, size=(t, n)),
                    np.broadcast_to(tod[:, None], (t, n))],
                   axis=-1).astype(np.float32)
    means, stds = raw.mean(axis=(0, 1)), raw.std(axis=(0, 1))
    data = (raw - means) / stds
    ei = np.unique(rng.integers(0, n, size=(2, 120)), axis=1)
    ei = ei[:, ei[0] != ei[1]]
    w = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)

    jg = jops.Graph.from_edge_index(ei, w, num_nodes=n)
    jmodel = jmodels.DCRNNSeq(out_channels=f, K=2)
    jtr, jva, _ = jcommon.make_index_loaders(data, lags, bs, shuffle=True)
    params = jmodel.init(jax.random.PRNGKey(0), data[None, :lags], jg)
    jscaler = jtrain.ZScoreScaler(mean=means, std=stds)
    jtrainer = jtrain.BatchTrainer(lambda p, x: jmodel.apply(p, x, jg),
                                   optax.adam(1e-3), scaler=jscaler)
    jcurve = []
    jtrainer.fit(params, jtr, epochs, val_loader=jva,
                 callback=lambda e, tl, vl: jcurve.append((tl, vl)))

    g = Graph.from_edge_index(ei, w, num_nodes=n, device="cpu")
    model = DCRNNSeq(f, f, 2, device="cpu")
    model.params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    scaler = ZScoreScaler(mean=torch.as_tensor(means),
                          std=torch.as_tensor(stds))
    trainer = BatchTrainer(model, lambda x: model(x, g), lr=1e-3,
                           scaler=scaler, device="cpu")
    tr, va, _ = tcommon.make_index_loaders(data, lags, bs, shuffle=True,
                                           device="cpu")
    assert (len(tr), len(va)) == (len(jtr), len(jva)) == (17, 3)
    curve = []
    trainer.fit(tr, epochs, val_loader=va,
                callback=lambda e, tl, vl: curve.append((tl, vl)))

    assert len(curve) == len(jcurve) == epochs
    assert curve[-1][0] < curve[0][0]
    np.testing.assert_allclose(curve, jcurve, rtol=1e-5)
