"""Port parity: the six homogeneous signal classes, the split, the stacked
signal and the Chickenpox loader against the JAX package (``signal/``,
``data/chickenpox.py``).

Inputs are made with numpy from a seed and handed to both packages; every
array that comes out must be EQUAL (the layer only converts and stacks:
floats to f32 on both sides, integers to int64 here and int32 there).
"""

import gzip
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_geometric_temporal_tpu_torch as port
from pytorch_geometric_temporal_tpu import signal as jsig
from pytorch_geometric_temporal_tpu.data import (
    ChickenpoxDatasetLoader as JChickenpox)
from pytorch_geometric_temporal_tpu_torch import signal as tsig
from pytorch_geometric_temporal_tpu_torch.data import (
    ChickenpoxDatasetLoader, _common, _io)
from pytorch_geometric_temporal_tpu.data import _common as jcommon

T, N, F = 5, 12, 3


def raw(kind, seed=0):
    """Constructor arguments of one signal class, as numpy."""
    rng = np.random.default_rng(seed)
    dynamic = kind.startswith("DynamicGraph")
    static_signal = "StaticSignal" in kind
    has_batch = kind.endswith("Batch")

    def edges(e):
        return rng.integers(0, N, size=(2, e))

    if dynamic:
        counts = [int(rng.integers(8, 20)) for _ in range(T)]
        ei = [edges(e) for e in counts]
        ew = [rng.uniform(0.1, 1.0, e).astype(np.float64) for e in counts]
    else:
        ei, ew = edges(15), rng.uniform(0.1, 1.0, 15)
    feats = (rng.normal(size=(N, F)) if static_signal
             else [rng.normal(size=(N, F)) for _ in range(T)])
    targets = [rng.integers(0, 4, size=N) if t % 2 else rng.normal(size=N)
               for t in range(T)]
    targets = [np.asarray(y, np.float64) for y in targets]
    args = [ei, ew, feats, targets]
    if has_batch:
        b = rng.integers(0, 2, size=N)
        args.append([b] * T if dynamic else b)
    extra = {"extra": [rng.integers(0, 9, size=(N, 2)) for _ in range(T)]}
    return args, extra


KINDS = ["StaticGraphTemporalSignal", "DynamicGraphTemporalSignal",
         "DynamicGraphStaticSignal", "StaticGraphTemporalSignalBatch",
         "DynamicGraphTemporalSignalBatch", "DynamicGraphStaticSignalBatch"]


def both(kind, seed=0):
    args, extra = raw(kind, seed)
    return (getattr(jsig, kind)(*args, **extra),
            getattr(tsig, kind)(*args, device="cpu", **extra))


def same(t, j):
    if j is None:
        assert t is None
        return
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def assert_snapshot_equal(ts, js):
    same(ts.x, js.x)
    same(ts.y, js.y)
    same(ts.batch, js.batch)
    same(ts.edge_index, js.edge_index)
    same(ts.edge_attr, js.edge_attr)
    same(ts.extra, js.extra)
    assert ts.x.dtype == torch.float32 and ts.extra.dtype == torch.int64
    assert (ts.graph.num_nodes, ts.graph.num_edges) == (
        js.graph.num_nodes, js.graph.num_edges)


@pytest.mark.parametrize("kind", KINDS)
def test_signal_iterates_like_jax(kind):
    jsignal, tsignal = both(kind)
    assert len(tsignal) == len(jsignal) == tsignal.snapshot_count == T
    count = 0
    for ts, js in zip(tsignal, jsignal):
        assert_snapshot_equal(ts, js)
        count += 1
    assert count == T
    assert_snapshot_equal(tsignal[-1], jsignal[-1])
    # slices keep the class, the device and the additional features
    tsl, jsl = tsignal[1:4], jsignal[1:4]
    assert type(tsl) is type(tsignal) and tsl.device == tsignal.device
    assert tsl.snapshot_count == jsl.snapshot_count == 3
    assert_snapshot_equal(tsl[0], jsl[0])
    with pytest.raises(AttributeError):
        tsignal[0].missing


@pytest.mark.parametrize("kind", KINDS)
def test_split_and_stacked_signal_match_jax(kind):
    jsignal, tsignal = both(kind, seed=1)
    jtr, jte = jsig.temporal_signal_split(jsignal, 0.6)
    ttr, tte = tsig.temporal_signal_split(tsignal, 0.6)
    assert (ttr.snapshot_count, tte.snapshot_count) == (
        jtr.snapshot_count, jte.snapshot_count) == (3, 2)
    for tpart, jpart in ((ttr, jtr), (tte, jte)):
        tst = tsig.StackedSignal.from_signal(tpart)
        jst = jsig.StackedSignal.from_signal(jpart)
        for name in ("features", "targets", "senders", "receivers",
                     "weights", "batches"):
            same(getattr(tst, name), getattr(jst, name))
        same(tst.additional["extra"], jst.additional["extra"])
        assert (tst.num_nodes, tst.num_edges, tst.graph_dynamic,
                tst.snapshot_count) == (jst.num_nodes, jst.num_edges,
                                        jst.graph_dynamic,
                                        jst.snapshot_count)
        tg, jg = tst.graph(1), jst.graph(1)
        same(tg.senders, jg.senders)
        same(tg.masked_weights(), jg.masked_weights())


def test_signal_checks_temporal_consistency():
    args, _ = raw("StaticGraphTemporalSignal")
    args[3] = args[3][:-1]
    with pytest.raises(AssertionError, match="Temporal dimension"):
        tsig.StaticGraphTemporalSignal(*args, device="cpu")


@pytest.mark.parametrize("dynamic", [False, True])
def test_from_arrays_matches_jax(dynamic):
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(T, N, F))
    targs = rng.normal(size=(T, N))
    if dynamic:
        ei = [rng.integers(0, N, size=(2, 6 + 3 * t)) for t in range(T)]
        ew = [rng.uniform(0.1, 1.0, 6 + 3 * t) for t in range(T)]
    else:
        ei, ew = rng.integers(0, N, size=(2, 20)), None
    tst = tsig.StackedSignal.from_arrays(feats, targs, ei, ew, device="cpu")
    jst = jsig.StackedSignal.from_arrays(feats, targs, ei, ew)
    for name in ("features", "targets", "senders", "receivers", "weights"):
        same(getattr(tst, name), getattr(jst, name))
    assert (tst.num_nodes, tst.num_edges, tst.graph_dynamic) == (
        jst.num_nodes, jst.num_edges, dynamic)
    assert tst.batches is None and tst.additional == {}
    with pytest.raises(ValueError, match="steps but targets"):
        tsig.StackedSignal.from_arrays(feats, targs[:-1], ei, ew,
                                       device="cpu")
    if dynamic:
        with pytest.raises(ValueError, match="dynamic edge list"):
            tsig.StackedSignal.from_arrays(feats, targs, ei[:-1], ew,
                                           device="cpu")


@pytest.mark.parametrize("dynamic", [False, True])
def test_stacked_signal_keeps_its_graphs(dynamic):
    """``graph`` builds each graph once and keeps it on the signal: the
    static graph for any t, one graph a step when dynamic, each equal to
    the JAX package's; every scan hands its step those same instances."""
    rng = np.random.default_rng(4)
    feats, targs = rng.normal(size=(T, N, F)), rng.normal(size=(T, N))
    if dynamic:
        ei = [rng.integers(0, N, size=(2, 6 + 3 * t)) for t in range(T)]
        ew = [rng.uniform(0.1, 1.0, 6 + 3 * t) for t in range(T)]
    else:
        ei, ew = rng.integers(0, N, size=(2, 20)), None
    tst = tsig.StackedSignal.from_arrays(feats, targs, ei, ew, device="cpu")
    jst = jsig.StackedSignal.from_arrays(feats, targs, ei, ew)
    first = [tst.graph(t) for t in range(T)]
    assert all(tst.graph(t) is g for t, g in enumerate(first))
    assert len({id(g) for g in first}) == (T if dynamic else 1)
    for t, g in enumerate(first):
        jg = jst.graph(t)
        same(g.senders, jg.senders)
        same(g.masked_weights(), jg.masked_weights())
    for _ in range(2):
        seen = []
        tst.scan(lambda c, x, y, g: (seen.append(g) or c, ()), 0)
        assert all(a is b for a, b in zip(seen, first))


@pytest.mark.parametrize("kind", ["StaticGraphTemporalSignal",
                                  "DynamicGraphTemporalSignal",
                                  "DynamicGraphStaticSignalBatch"])
def test_scan_matches_jax_scan(kind):
    """The same step through ``StackedSignal.scan`` on both sides: a
    carry threaded over the snapshots, per-step outputs stacked."""
    jsignal, tsignal = both(kind, seed=3)
    jst = jsig.StackedSignal.from_signal(jsignal)
    tst = tsig.StackedSignal.from_signal(tsignal)

    def jstep(carry, x, y, g, b=None):
        deg = g.in_degree()
        if b is not None:
            deg = deg + b.astype(deg.dtype)
        carry = carry + (x.sum(-1) * deg).sum() + y.sum()
        return carry, (carry, x[:, 0] * deg)

    def tstep(carry, x, y, g, b=None):
        deg = g.in_degree()
        if b is not None:
            deg = deg + b.to(deg.dtype)
        carry = carry + (x.sum(-1) * deg).sum() + y.sum()
        return carry, (carry, x[:, 0] * deg)

    jc, (jcs, jouts) = jst.scan(jstep, jnp.float32(0.0))
    tc, (tcs, touts) = tst.scan(tstep, torch.zeros(()))
    # f32 sums of a few hundred terms in another order
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    np.testing.assert_allclose(tcs.numpy(), np.asarray(jcs), rtol=1e-5)
    np.testing.assert_allclose(touts.numpy(), np.asarray(jouts), rtol=1e-5,
                               atol=1e-6)
    assert touts.shape == (T, N)
    carry, outs = tst.scan(lambda c, *a: (c, ()), ())
    assert carry == () and outs == ()


def test_chickenpox_loader_matches_jax():
    jds = JChickenpox().get_dataset(lags=4)
    tds = ChickenpoxDatasetLoader().get_dataset(lags=4, device="cpu")
    assert tds.snapshot_count == jds.snapshot_count == 517
    np.testing.assert_array_equal(tds.edge_index, jds.edge_index)
    np.testing.assert_array_equal(tds.edge_weight, jds.edge_weight)
    for t in (0, 1, 258, 516):
        ts, js = tds[t], jds[t]
        same(ts.x, js.x)
        same(ts.y, js.y)
        same(ts.edge_index, js.edge_index)
    g = tds[0].graph
    assert (g.num_nodes, g.num_edges) == (20, 102)
    ttr, tte = tsig.temporal_signal_split(tds, 0.2)
    jtr, jte = jsig.temporal_signal_split(jds, 0.2)
    for tpart, jpart in ((ttr, jtr), (tte, jte)):
        tst = tsig.StackedSignal.from_signal(tpart)
        jst = jsig.StackedSignal.from_signal(jpart)
        same(tst.features, jst.features)
        same(tst.targets, jst.targets)
    tds8 = ChickenpoxDatasetLoader().get_dataset(lags=8, device="cpu")
    assert tds8[0].x.shape == (20, 8)


def test_bundled_file_is_the_ports_own():
    """The loader reads the copy inside the port's package, byte for byte
    the dataset the JAX package bundles."""
    pkg = Path(port.__file__).parent
    assert _io._BUNDLED == pkg / "data" / "bundled"
    own = _io._BUNDLED / "chickenpox.json.gz"
    assert own.is_file() and _io.available("chickenpox.json")
    data = json.loads(gzip.decompress(own.read_bytes()))
    assert data == JChickenpox()._dataset
    assert not _io.available("no_such_dataset.json")


def test_search_path_takes_priority(tmp_path, monkeypatch):
    monkeypatch.setattr(_io, "_EXTRA_PATHS", [])
    (tmp_path / "chickenpox.json").write_text(
        json.dumps({"edges": [[0, 1]], "FX": [[1.0, 2.0]] * 6}))
    _io.add_search_path(tmp_path)
    ds = ChickenpoxDatasetLoader().get_dataset(lags=2, device="cpu")
    assert ds.snapshot_count == 4 and ds[0].x.shape == (2, 2)


def test_dataset_helpers_match_jax():
    rng = np.random.default_rng(4)
    stacked = rng.normal(size=(9, 4))
    tf, tt = _common.lag_windows(stacked, 3)
    jf, jt = jcommon.lag_windows(stacked, 3)
    np.testing.assert_array_equal(np.stack(tf), np.stack(jf))
    np.testing.assert_array_equal(np.stack(tt), np.stack(jt))
    np.testing.assert_array_equal(_common.zscore(stacked, eps=1e-3),
                                  jcommon.zscore(stacked, eps=1e-3))
    ids = rng.integers(0, 5, size=7)
    np.testing.assert_array_equal(_common.binned_onehot(ids, 5),
                                  jcommon.binned_onehot(ids, 5))
    with pytest.raises(ValueError, match="out of range"):
        _common.binned_onehot(np.array([-1, 2]), 5)
