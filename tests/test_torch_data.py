"""Port parity of the four bundled-data loaders (PedalMe, EnglandCovid,
MontevideoBus, TwitterTennis) against the JAX package's.

Both loaders read their own package's copy of the same bytes; the raw
arrays they build (float64/int64 numpy) must agree — indices exactly,
floats within 1e-12 — and the snapshots they hand out (converted to f32
on both sides) must be equal, for every option the JAX package's tests
cover.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

import pytorch_geometric_temporal_tpu as jpkg
import pytorch_geometric_temporal_tpu_torch as port
from pytorch_geometric_temporal_tpu import data as jdata
from pytorch_geometric_temporal_tpu import signal as jsig
from pytorch_geometric_temporal_tpu_torch import data as tdata
from pytorch_geometric_temporal_tpu_torch import signal as tsig
from pytorch_geometric_temporal_tpu_torch.data import twitter_tennis
from pytorch_geometric_temporal_tpu.data import twitter_tennis as jtt

BUNDLED = ["pedalme_london", "england_covid", "montevideo_bus",
           "twitter_tennis_rg17", "twitter_tennis_uo17"]


def same_raw(tds, jds):
    """The loaders' raw arrays: indices equal, floats within 1e-12."""
    assert tds.snapshot_count == jds.snapshot_count
    if hasattr(tds, "edge_indices"):        # a graph per snapshot
        t_ei, j_ei = tds.edge_indices, jds.edge_indices
        t_ew, j_ew = tds.edge_weights, jds.edge_weights
    else:
        t_ei, j_ei = [tds.edge_index], [jds.edge_index]
        t_ew, j_ew = [tds.edge_weight], [jds.edge_weight]
    assert len(t_ei) == len(j_ei)
    for a, b in zip(t_ei, j_ei):
        np.testing.assert_array_equal(a, b)
    for name, ta, ja in (("weights", t_ew, j_ew),
                         ("features", tds.features, jds.features),
                         ("targets", tds.targets, jds.targets)):
        assert len(ta) == len(ja), name
        for a, b in zip(ta, ja):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12,
                                       err_msg=name)


def same_snapshots(tds, jds, steps):
    for t in steps:
        ts, js = tds[t], jds[t]
        np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
        np.testing.assert_array_equal(ts.y.numpy(), np.asarray(js.y))
        np.testing.assert_array_equal(ts.edge_index.numpy(),
                                      np.asarray(js.edge_index))
        np.testing.assert_array_equal(ts.edge_attr.numpy(),
                                      np.asarray(js.edge_attr))
        assert (ts.graph.num_nodes, ts.graph.num_edges, ts.graph.edge_pad
                ) == (js.graph.num_nodes, js.graph.num_edges,
                      js.graph.edge_pad)


def same_stacked(tds, jds):
    ttr, tte = tsig.temporal_signal_split(tds, 0.2)
    jtr, jte = jsig.temporal_signal_split(jds, 0.2)
    for tpart, jpart in ((ttr, jtr), (tte, jte)):
        tst = tsig.StackedSignal.from_signal(tpart)
        jst = jsig.StackedSignal.from_signal(jpart)
        for name in ("features", "targets", "senders", "receivers",
                     "weights"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)),
                                          err_msg=name)
        assert (tst.num_nodes, tst.num_edges, tst.graph_dynamic) == (
            jst.num_nodes, jst.num_edges, jst.graph_dynamic)


@pytest.mark.parametrize("name", BUNDLED)
def test_bundled_files_are_byte_for_byte_copies(name):
    own = Path(port.__file__).parent / "data" / "bundled" / f"{name}.json.gz"
    theirs = (Path(jpkg.__file__).parent / "data" / "bundled"
              / f"{name}.json.gz")
    assert own.is_file()
    assert (hashlib.sha256(own.read_bytes()).hexdigest()
            == hashlib.sha256(theirs.read_bytes()).hexdigest())


@pytest.mark.parametrize("lags", [4, 7])
def test_pedalme_matches_jax(lags):
    tds = tdata.PedalMeDatasetLoader().get_dataset(lags=lags, device="cpu")
    jds = jdata.PedalMeDatasetLoader().get_dataset(lags=lags)
    same_raw(tds, jds)
    same_snapshots(tds, jds, (0, tds.snapshot_count - 1))
    same_stacked(tds, jds)
    assert tds[0].x.shape == (15, lags) and tds[0].y.shape == (15,)


@pytest.mark.parametrize("lags", [8, 3])
def test_england_covid_matches_jax(lags):
    tds = tdata.EnglandCovidDatasetLoader().get_dataset(lags=lags,
                                                        device="cpu")
    jds = jdata.EnglandCovidDatasetLoader().get_dataset(lags=lags)
    assert tds.snapshot_count == 61 - lags
    same_raw(tds, jds)
    same_snapshots(tds, jds, (0, 17, tds.snapshot_count - 1))
    same_stacked(tds, jds)
    # every snapshot has its own edge list, padded to one common count
    assert len({tds[t].graph.edge_pad for t in range(tds.snapshot_count)}
               ) == 1
    assert len({tds[t].graph.num_edges for t in range(tds.snapshot_count)}
               ) > 1


@pytest.mark.parametrize("lags", [4, 2])
def test_montevideo_bus_matches_jax(lags):
    tds = tdata.MontevideoBusDatasetLoader().get_dataset(lags=lags,
                                                         device="cpu")
    jds = jdata.MontevideoBusDatasetLoader().get_dataset(lags=lags)
    same_raw(tds, jds)
    same_snapshots(tds, jds, (0, 300))
    if lags == 4:
        same_stacked(tds, jds)
    assert tds[0].x.shape == (675, lags) and tds[0].y.shape == (675,)


@pytest.mark.parametrize("event_id,mode,n,offset,fdim", [
    ("rg17", "encoded", None, 1, 16), ("rg17", "encoded", 100, 1, 16),
    ("rg17", None, 100, 1, 2), ("rg17", "diagonal", 50, 1, 50),
    ("uo17", "encoded", 200, 3, 16), ("uo17", None, None, 1, 2)])
def test_twitter_tennis_matches_jax(event_id, mode, n, offset, fdim):
    kw = dict(event_id=event_id, N=n, feature_mode=mode,
              target_offset=offset)
    tds = tdata.TwitterTennisDatasetLoader(**kw).get_dataset(device="cpu")
    jds = jdata.TwitterTennisDatasetLoader(**kw).get_dataset()
    same_raw(tds, jds)
    same_snapshots(tds, jds, (0, 5, tds.snapshot_count - 1))
    nodes = 1000 if n is None else n
    assert tds[0].x.shape == (nodes, fdim) and tds[0].y.shape == (nodes,)
    if n == 100 and mode == "encoded":
        same_stacked(tds, jds)


def test_twitter_tennis_validation():
    with pytest.raises(ValueError, match="Invalid 'event_id'"):
        tdata.TwitterTennisDatasetLoader(event_id="nope")
    with pytest.raises(ValueError, match="Choose feature_mode from values"):
        tdata.TwitterTennisDatasetLoader(feature_mode="bogus")


def test_encode_features_matches_jax():
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, 200, size=40).astype(float),
                  rng.uniform(0, 1, size=40)], axis=1)
    x[0] = (0.0, 1.0)           # the last transitivity bin, degree bin 0
    got = twitter_tennis.encode_features(x)
    np.testing.assert_array_equal(got, jtt.encode_features(x))
    assert got.shape == (40, 16) and (got.sum(axis=1) == 2).all()
    np.testing.assert_array_equal(
        twitter_tennis.encode_features(x, log_degree_cutoff=2),
        jtt.encode_features(x, log_degree_cutoff=2))
    with pytest.raises(ValueError, match="out of range"):
        twitter_tennis.encode_features(np.array([[1.0, 1.2]]))


def test_loaders_build_on_cuda_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tdata.PedalMeDatasetLoader().get_dataset,
                  tdata.EnglandCovidDatasetLoader().get_dataset,
                  tdata.MontevideoBusDatasetLoader().get_dataset,
                  tdata.TwitterTennisDatasetLoader(N=20).get_dataset):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
