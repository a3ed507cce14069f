"""Port parity of the METR-LA accuracy protocol against the JAX package's
``benchmarks/metrla_protocol.py``.

The synthetic series must be the same arrays; the port's ``train``, started
from the JAX run's own initial parameters on the same batch schedule, must
reach the same de-normalized masked test MAE (within 0.5%) along the same
training curve (each epoch's last batch loss within 1e-3 relative), at the
size of ``tests/test_metrla_parity.py``: 48 sensors, 288 steps, 2 epochs of
batches of 32.

Run as a script, ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_metrla.py init.npz`` saves the initial parameters of the
JAX package's full-size run (``PRNGKey(0)``) under ``a/b/c`` keys, for the
port's ``python -m ...protocols.metrla_protocol --params init.npz``.
"""

import jax
import numpy as np
import pytest
import torch

from benchmarks import metrla_protocol as jproto
from pytorch_geometric_temporal_tpu_torch.protocols import (
    metrla_protocol as tproto)
from pytorch_geometric_temporal_tpu_torch.signal import DeviceWindower

torch.set_num_threads(1)    # thousands of tiny ops: a thread pool only spins


@pytest.mark.parametrize("seed,n,t", [(0, 48, 288), (3, 20, 100)])
def test_make_traffic_series_is_the_same_arrays(seed, n, t):
    want = jproto.make_traffic_series(seed=seed, n=n, t=t)
    got = tproto.make_traffic_series(seed=seed, n=n, t=t)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_load_series_and_windows_match():
    want = jproto.load_series(seed=1, t=120, n=16)
    got = tproto.load_series(seed=1, t=120, n=16)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a, b)
    assert got[5] == want[5] == "synthetic-seeded"
    np.testing.assert_array_equal(tproto._windows(got[0]),
                                  jproto._windows(want[0]))
    idx = np.array([5, 0, 40])
    x, y = DeviceWindower(got[0], tproto.IN_T, device="cpu")(idx)
    jx, jy = jproto._batch(want[0], idx)
    np.testing.assert_array_equal(x.numpy(), jx)
    np.testing.assert_array_equal(y.numpy(), jy)
    assert (tproto.IN_T, tproto.OUT_T) == (jproto.IN_T, jproto.OUT_T)


def test_train_matches_the_jax_run_from_its_initial_parameters():
    epochs, batch_size, t_len, n, K, seed = 2, 32, 288, 48, 3, 0
    data, ei, w, means, stds, _ = jproto.load_series(seed=seed, t=t_len, n=n)
    idx = jproto._windows(data)
    n_train, n_val = int(0.7 * len(idx)), int(0.1 * len(idx))
    train_idx, test_idx = idx[:n_train], idx[n_train + n_val:]
    rng = np.random.default_rng(seed + 1)
    schedule = [rng.permutation(train_idx) for _ in range(epochs)]

    mae_j, curve_j, _ = jproto._train_jax(
        data, ei, w, means, stds, schedule, test_idx, batch_size, K)
    init = jax.tree_util.tree_map(
        np.asarray, jproto._reinit(data, ei, w, schedule, batch_size, K))
    mae_t, curve_t, model = tproto.train(
        data, ei, w, means, stds, schedule, test_idx, batch_size, K,
        device="cpu", params=init)

    assert curve_t[-1] < curve_t[0]
    np.testing.assert_allclose(curve_t, curve_j, rtol=1e-3)
    assert abs(mae_t - mae_j) / mae_j < 5e-3, (mae_t, mae_j)
    assert model.cell.w_zr.shape == (2 * K * 4, 4)


def test_params_file_round_trip(tmp_path):
    tree = {"params": {"cell": {"w_h": np.arange(6.0).reshape(2, 3),
                                "b_h": np.ones(3)}}}
    flat = {"params/cell/w_h": tree["params"]["cell"]["w_h"],
            "params/cell/b_h": tree["params"]["cell"]["b_h"]}
    np.savez(tmp_path / "init.npz", **flat)
    got = tproto._tree_from_npz(tmp_path / "init.npz")
    assert set(got["params"]["cell"]) == {"w_h", "b_h"}
    np.testing.assert_array_equal(got["params"]["cell"]["w_h"],
                                  tree["params"]["cell"]["w_h"])


def test_run_reports_the_protocol():
    rec = tproto.run(epochs=2, batch_size=16, t_len=120, n=12, device="cpu")
    assert rec["source"] == "synthetic-seeded" and rec["epochs"] == 2
    assert len(rec["train_curve"]) == 2
    assert np.isfinite(rec["test_masked_mae_denorm"])
    assert rec["test_masked_mae_denorm"] > 0.0
    again = tproto.run(epochs=2, batch_size=16, t_len=120, n=12,
                       device="cpu")
    assert again["train_curve"] == rec["train_curve"]
    other = tproto.run(epochs=2, batch_size=16, t_len=120, n=12,
                       init_seed=1, device="cpu")
    assert other["train_curve"] != rec["train_curve"]


if __name__ == "__main__":
    import sys

    data, ei, w, *_ = jproto.load_series()
    first = jproto._windows(data)[:2]
    init = jproto._reinit(data, ei, w, [first], 64, 3)
    flat = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(init)[0]}
    np.savez(sys.argv[1], **flat)
    print({k: v.shape for k, v in flat.items()})
