"""Port parity of the twelve download-gated loaders against the JAX
package's, on fixture files each test writes into a temporary
``$PGT_TPU_DATA`` (the layouts of ``tests/test_loader_fixtures.py``).

Both packages read the same fixture: ``get_dataset`` snapshots must be equal
array for array (features and targets as the loaders build them, then each
snapshot as handed out); ``get_index_dataset`` must give the same first
batch of every split, edges, weights, means and stds.  Also here: the error
a missing file raises, Chickenpox's index path against its classic
iterator, and ``load_series``' branch over staged METR-LA bytes.

No test reaches the network: ``urllib.request.urlopen`` is replaced for
every test of this file, so a file that fails to resolve raises at once.
"""

import io
import json
import pickle
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from benchmarks import metrla_protocol as jproto
from pytorch_geometric_temporal_tpu import data as jdata
from pytorch_geometric_temporal_tpu.data import _io as jio
from pytorch_geometric_temporal_tpu_torch import data as tdata
from pytorch_geometric_temporal_tpu_torch.data import _io as tio
from pytorch_geometric_temporal_tpu_torch.protocols import (
    metrla_protocol as tproto)

N, T = 6, 40


def _no_network(*args, **kwargs):
    raise OSError("no network in these tests")


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setattr(urllib.request, "urlopen", _no_network)
    # loaders given raw_data_dir add to a module-level list: keep it per test
    monkeypatch.setattr(tio, "_EXTRA_PATHS", [])
    monkeypatch.setattr(jio, "_EXTRA_PATHS", [])


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PGT_TPU_DATA", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return tmp_path


def _adj(rng, n=N):
    a = (rng.uniform(size=(n, n)) < 0.4).astype(np.float32)
    a *= rng.uniform(0.1, 1.0, size=(n, n)).astype(np.float32)
    np.fill_diagonal(a, 0.0)
    return a


def _write_zip(path, members):
    with zipfile.ZipFile(path, "w") as zf:
        for name, arr in members.items():
            buf = io.BytesIO()
            np.save(buf, arr)
            zf.writestr(name, buf.getvalue())


def _write_fixed_h5(path, values, start="2017-01-01T00:00"):
    """pandas' fixed-format layout written with h5py: 5-minute steps from
    ``start``, so the time of day runs through whole days."""
    import h5py

    idx = (np.datetime64(start, "ns")
           + np.arange(values.shape[0]) * np.timedelta64(5, "m")
           ).astype(np.int64)
    with h5py.File(path, "w") as f:
        g = f.create_group("df")
        g.create_dataset("axis1", data=idx)
        g.create_dataset("block0_values", data=values)


def _edge_json(rng, n=N, e=14):
    ei = np.unique(rng.integers(0, n, size=(2, e)), axis=1)
    return ([[int(s), int(r)] for s, r in ei.T],
            [float(w) for w in rng.uniform(0.1, 1.0, ei.shape[1])])


def _write_pt_distances(path, rng, n=N, e=18):
    ei = np.unique(rng.integers(0, n, size=(2, e)), axis=1)
    d = np.concatenate([ei, rng.uniform(1.0, 5.0, (1, ei.shape[1]))], axis=0)
    torch.save(torch.as_tensor(d.T), str(path))  # saved layout (E, 3)


def same_array(got, want, tol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def same_signal(tds, jds):
    """The arrays the loaders built (equal values; each signal class keeps
    its own index dtype) and every snapshot (equal dtypes and bits)."""
    assert tds.snapshot_count == jds.snapshot_count
    for name in ("edge_index", "edge_weight", "features", "targets"):
        np.testing.assert_array_equal(getattr(tds, name),
                                      getattr(jds, name), err_msg=name)
    for t in range(tds.snapshot_count):
        ts, js = tds[t], jds[t]
        for name in ("x", "y", "edge_attr"):
            same_array(getattr(ts, name), getattr(js, name))
        np.testing.assert_array_equal(ts.edge_index.numpy(), js.edge_index)


def same_index(got, want, tol=0.0):
    """get_index_dataset tuples: loaders' first batches, then the arrays."""
    assert len(got) == len(want)
    for tl, jl in zip(got[:3], want[:3]):
        assert len(tl) == len(jl)
        for a, b in zip(next(iter(tl)), next(iter(jl))):
            same_array(a, b, tol)
    for a, b in zip(got[3:], want[3:]):
        same_array(a, b, tol)


def test_metr_la_matches(data_dir, rng):
    _write_zip(data_dir / "METR-LA.zip", {
        "adj_mat.npy": _adj(rng),
        "node_values.npy": rng.normal(size=(T, N, 2)).astype(np.float32),
    })
    got = tdata.METRLADatasetLoader(index=True)
    want = jdata.METRLADatasetLoader(index=True)
    tds = got.get_dataset(num_timesteps_in=4, num_timesteps_out=4,
                          device="cpu")
    same_signal(tds, want.get_dataset(num_timesteps_in=4,
                                      num_timesteps_out=4))
    assert tds[0].x.shape == (N, 2, 4) and tds[0].y.shape == (N, 4)
    out = got.get_index_dataset(lags=4, batch_size=3, device="cpu")
    same_index(out, want.get_index_dataset(lags=4, batch_size=3))
    assert out[0].windower.data.shape == (T, N, 2)
    with pytest.raises(ValueError, match="index=True"):
        tdata.METRLADatasetLoader().get_index_dataset(device="cpu")


def test_metr_la_raw_data_dir(tmp_path, rng):
    staged = tmp_path / "staged"
    staged.mkdir()
    _write_zip(staged / "METR-LA.zip", {
        "adj_mat.npy": _adj(rng),
        "node_values.npy": rng.normal(size=(T, N, 2)).astype(np.float32),
    })
    got = tdata.METRLADatasetLoader(raw_data_dir=staged)
    want = jdata.METRLADatasetLoader(raw_data_dir=staged)
    same_array(got.A, want.A)
    assert tio.data_search_paths()[0] == staged


def test_pems_bay_matches(data_dir, rng):
    _write_zip(data_dir / "PEMS-BAY.zip", {
        "pems_adj_mat.npy": _adj(rng),
        "pems_node_values.npy": rng.normal(size=(T, N, 2)).astype(
            np.float32),
    })
    got = tdata.PemsBayDatasetLoader(index=True)
    want = jdata.PemsBayDatasetLoader(index=True)
    tds = got.get_dataset(num_timesteps_in=4, num_timesteps_out=4,
                          device="cpu")
    same_signal(tds, want.get_dataset(num_timesteps_in=4,
                                      num_timesteps_out=4))
    assert tds[0].y.shape == (N, 2, 4)  # PEMS-BAY keeps all target features
    same_index(got.get_index_dataset(lags=4, batch_size=2, shuffle=True,
                                     device="cpu"),
               want.get_index_dataset(lags=4, batch_size=2, shuffle=True))


@pytest.mark.parametrize("start", ["2017-01-01T00:00", "2018-03-11T07:35"])
def test_pems_all_california_matches(data_dir, rng, start):
    (data_dir / "pems_cali_adj_mat.pkl").write_bytes(
        pickle.dumps((None, None, _adj(rng))))
    _write_fixed_h5(data_dir / "pems_cali_speed.h5",
                    rng.uniform(0.0, 70.0, size=(700, N)).astype(np.float32),
                    start)
    got = tdata.PemsDatasetLoader().get_index_dataset(lags=4, batch_size=2,
                                                      device="cpu")
    # the JAX package computes the time of day through pandas
    want = jdata.PemsDatasetLoader().get_index_dataset(lags=4, batch_size=2)
    same_index(got, want)
    tod = got[0].windower.data[:, 0, 1].numpy()
    assert len(np.unique(tod)) == 288        # every 5 minutes of a day
    with pytest.raises(NotImplementedError):
        tdata.PemsDatasetLoader(index=False)


def test_pems_all_la_matches(data_dir, rng):
    (data_dir / "pems_AllLA_adj_mat.pkl").write_bytes(
        pickle.dumps((None, None, _adj(rng))))
    _write_fixed_h5(data_dir / "pems_AllLA_speed.h5",
                    rng.normal(size=(T, N)).astype(np.float32))
    got = tdata.PemsAllLADatasetLoader().get_index_dataset(
        lags=4, batch_size=2, device="cpu")
    # pandas hands the table out column-major, so the JAX package's f32
    # means and stds sum in another order: equal within 2e-7 (absolute and
    # relative; read 7.5e-9 on z-scored values)
    same_index(got, jdata.PemsAllLADatasetLoader().get_index_dataset(
        lags=4, batch_size=2), tol=2e-7)
    assert next(iter(got[0]))[0].shape == (2, 4, N, 1)  # speed only


def test_pems_names_h5py_when_missing(data_dir, rng, monkeypatch):
    import builtins

    from pytorch_geometric_temporal_tpu_torch.data import pems

    real = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *args, **kwargs)

    (data_dir / "x.h5").write_bytes(b"")
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="needs h5py"):
        pems._read_fixed_h5(data_dir / "x.h5")


def test_wikimaths_matches(data_dir, rng):
    edges, weights = _edge_json(rng)
    payload = {"edges": edges, "weights": weights, "time_periods": T}
    for t in range(T):
        payload[str(t)] = {"y": [float(v) for v in rng.integers(0, 100, N)]}
    (data_dir / "wikivital_mathematics.json").write_text(json.dumps(payload))
    tds = tdata.WikiMathsDatasetLoader().get_dataset(lags=8, device="cpu")
    same_signal(tds, jdata.WikiMathsDatasetLoader().get_dataset(lags=8))
    assert tds[0].x.shape == (N, 8) and tds.snapshot_count == T - 8


@pytest.mark.parametrize("cls_name,fname", [
    ("WindmillOutputLargeDatasetLoader", "windmill_output.json"),
    ("WindmillOutputMediumDatasetLoader", "windmill_output_medium.json"),
    ("WindmillOutputSmallDatasetLoader", "windmill_output_small.json"),
])
def test_windmill_matches(data_dir, rng, cls_name, fname):
    edges, weights = _edge_json(rng)
    payload = {"edges": edges, "weights": weights,
               "block": [[float(v) for v in row]
                         for row in rng.uniform(size=(T, N))]}
    (data_dir / fname).write_text(json.dumps(payload))
    got = getattr(tdata, cls_name)(index=True)
    want = getattr(jdata, cls_name)(index=True)
    same_signal(got.get_dataset(lags=8, device="cpu"),
                want.get_dataset(lags=8))
    same_index(got.get_index_dataset(lags=4, batch_size=2, shuffle=True,
                                     device="cpu"),
               want.get_index_dataset(lags=4, batch_size=2, shuffle=True))
    with pytest.raises(ValueError, match="index=True"):
        getattr(tdata, cls_name)().get_index_dataset(device="cpu")


def test_mtm_matches(data_dir, rng):
    frames_total = 24
    payload = {"edges": [[int(s), int(r)] for s, r in
                         np.stack([np.arange(20), np.arange(1, 21)]).T]}
    for j in range(21):
        payload[str(j)] = {
            str(t): f"({rng.uniform():.3f},{rng.uniform():.3f},"
                    f"{rng.uniform():.3f})"
            for t in range(frames_total)}
    payload["LABEL"] = {str(t): int(rng.integers(0, 6))
                        for t in range(frames_total)}
    for t in range(6):
        payload["LABEL"][str(t)] = t
    (data_dir / "mtm_1.json").write_text(json.dumps(payload))
    tds = tdata.MTMDatasetLoader().get_dataset(frames=16, device="cpu")
    same_signal(tds, jdata.MTMDatasetLoader().get_dataset(frames=16))
    assert tds[0].x.shape == (3, 21, 16) and tds[0].y.shape == (16, 6)


@pytest.mark.parametrize("cls_name,signal,adj,f", [
    ("SIDiffusionDatasetLoader", "SI_equation_dataset.npy",
     "nuts3_adjacent_distances.pt", 2),
    ("AdvectionDiffusionDatasetLoader", "advection_diffusion_dataset.npy",
     "nuts3_adjacent_distances.pt", 1),
    ("WaveEquationDatasetLoader", "wave_equation_dataset.npy",
     "germany_coastline_adjacency.pt", 1),
])
def test_synthetic_pde_matches(data_dir, rng, cls_name, signal, adj, f):
    np.save(data_dir / signal, rng.uniform(size=(T, N, f)).astype(
        np.float32))
    _write_pt_distances(data_dir / adj, rng)
    tds = getattr(tdata, cls_name)().get_dataset(lags=4, device="cpu")
    same_signal(tds, getattr(jdata, cls_name)().get_dataset(lags=4))
    assert tds.snapshot_count == T - 4


def test_missing_file_names_the_search_path(data_dir):
    with pytest.raises(RuntimeError) as err:
        tdata.WikiMathsDatasetLoader()
    assert "wikivital_mathematics.json" in str(err.value)
    assert str(data_dir) in str(err.value)
    with pytest.raises(RuntimeError, match=str(data_dir)):
        tdata.METRLADatasetLoader()
    with pytest.raises(RuntimeError, match="pems_cali_adj_mat.pkl"):
        tdata.PemsDatasetLoader().get_index_dataset(device="cpu")


def test_data_package_exports_the_jax_names():
    assert sorted(tdata.__all__) == sorted(jdata.__all__)
    assert len(tdata.__all__) == 17


def test_chickenpox_index_matches_classic_and_jax():
    lags = 4
    classic = tdata.ChickenpoxDatasetLoader().get_dataset(lags=lags,
                                                          device="cpu")
    kw = dict(lags=lags, batch_size=1, shuffle=False, ratio=(1.0, 0.0, 0.0))
    got = tdata.ChickenpoxDatasetLoader(index=True).get_index_dataset(
        **kw, device="cpu")
    want = jdata.ChickenpoxDatasetLoader(index=True).get_index_dataset(**kw)
    train, _, _, edges, ew = got
    same_array(edges, want[3])
    same_array(ew, want[4])
    np.testing.assert_array_equal(edges, classic[0].edge_index.numpy())
    count = 0
    for i, ((x, y), (jx, jy)) in enumerate(zip(train, want[0])):
        same_array(x, jx)
        same_array(y, jy)
        snap = classic[i]
        # x: (1, lags, N, 1) against the classic (N, lags); y's first step
        # is the classic target
        np.testing.assert_allclose(x[0, :, :, 0].T.numpy(), snap.x.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(y[0, 0, :, 0].numpy(), snap.y.numpy(),
                                   atol=1e-6)
        count += 1
    assert count == len(train) == classic.snapshot_count - (lags - 1)
    with pytest.raises(ValueError, match="index=True"):
        tdata.ChickenpoxDatasetLoader().get_index_dataset(device="cpu")
    same_index(tdata.ChickenpoxDatasetLoader(index=True).get_index_dataset(
        batch_size=16, shuffle=True, device="cpu"),
        jdata.ChickenpoxDatasetLoader(index=True).get_index_dataset(
            batch_size=16, shuffle=True))


def test_load_series_reads_staged_metr_la(data_dir, rng):
    adj = _adj(rng, 207)
    values = np.concatenate([rng.uniform(0.0, 70.0, size=(60, 207, 1)),
                             np.broadcast_to((np.arange(60) % 288 / 288.0)
                                             [:, None, None], (60, 207, 1))],
                            axis=-1).astype(np.float32)
    _write_zip(data_dir / "METR-LA.zip", {"adj_mat.npy": adj,
                                          "node_values.npy": values})
    got = tproto.load_series(t=30)
    want = jproto.load_series(t=30)
    assert got[5] == want[5] == "metr-la"
    for a, b in zip(got[:5], want[:5]):
        same_array(a, b)
    assert got[0].shape == (60, 207, 2)      # the whole series
    # another size takes the stand-in
    assert tproto.load_series(t=30, n=12)[5] == "synthetic-seeded"


def test_load_series_raises_on_a_broken_staged_file(data_dir):
    (data_dir / "METR-LA.zip").write_bytes(b"not a zip")
    with pytest.raises(zipfile.BadZipFile):
        tproto.load_series()
    # where the JAX package falls back to the stand-in
    assert jproto.load_series(t=40)[5] == "synthetic-seeded"
