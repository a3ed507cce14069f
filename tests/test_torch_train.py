"""Port parity: losses, dtype policy, scaler and BatchTrainer against the JAX
package (``train/``).

Inputs are made with numpy from a seed.  Losses and scaler are the same
f32 formulas (1e-6).  Three Adam steps of BatchTrainer on optax.adam(1e-3)
and on torch.optim.Adam(lr=1e-3, eps=1e-8) from the same transplanted
parameters agree to 2e-6 per parameter: each update moves a parameter by
~1e-3 and the gradients agree to f32 summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_temporal_tpu.models import DCRNNSeq as JDCRNNSeq
from pytorch_geometric_temporal_tpu.ops import Graph as JGraph
from pytorch_geometric_temporal_tpu.train import BatchTrainer as JTrainer
from pytorch_geometric_temporal_tpu.train import ZScoreScaler as JScaler
from pytorch_geometric_temporal_tpu.train import losses as jl
from pytorch_geometric_temporal_tpu.train.precision import (
    bf16_policy as j_bf16)
from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
from pytorch_geometric_temporal_tpu_torch.ops import Graph as TGraph
from pytorch_geometric_temporal_tpu_torch.train import (
    BatchTrainer, ZScoreScaler, bf16_policy, f32_policy)
from pytorch_geometric_temporal_tpu_torch.train import losses as tl


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(4, 6, 5)).astype(np.float32)
    true = rng.normal(size=(4, 6, 5)).astype(np.float32)
    true[0, :2] = 0.0           # masked entries
    for name in ("mse", "mae", "masked_mae_loss", "masked_mse_loss"):
        want = getattr(jl, name)(jnp.asarray(pred), jnp.asarray(true))
        got = getattr(tl, name)(torch.from_numpy(pred),
                                torch.from_numpy(true))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)
    zeros = np.zeros_like(true)  # all masked: 0, not NaN
    assert float(tl.masked_mae_loss(torch.from_numpy(pred),
                                    torch.from_numpy(zeros))) == 0.0


@pytest.mark.parametrize("axis", [None, 0])
def test_scaler_matches_jax(axis):
    data = np.random.default_rng(1).normal(3.0, 2.0, size=(50, 4))
    data[:, 2] = 1.5  # zero std column
    js = JScaler.fit(data, axis=axis)
    ts = ZScoreScaler.fit(data, axis=axis, device="cpu")
    np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean))
    np.testing.assert_allclose(ts.std.numpy(), np.asarray(js.std))
    x = data[:5].astype(np.float32)
    np.testing.assert_allclose(ts.transform(torch.from_numpy(x)).numpy(),
                               np.asarray(js.transform(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.inverse(torch.from_numpy(x)).numpy(),
                               np.asarray(js.inverse(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_policy_casts_floats_only():
    ei = np.array([[0, 1], [1, 2]])
    g = TGraph.from_edge_index(ei, np.array([0.5, 2.0], np.float32),
                               num_nodes=3, device="cpu")
    tree = {"w": torch.ones(2), "idx": torch.arange(3), "g": g,
            "seq": [torch.zeros(1, dtype=torch.float64)]}
    out = bf16_policy.cast_to_compute(tree)
    assert out["w"].dtype == torch.bfloat16
    assert out["idx"].dtype == torch.int64
    assert out["g"].weights.dtype == torch.bfloat16
    assert out["g"].senders.dtype == torch.int64
    assert out["seq"][0].dtype == torch.bfloat16
    back = bf16_policy.cast_output(out)
    assert back["w"].dtype == torch.float32
    assert f32_policy.cast_to_compute(tree)["seq"][0].dtype == torch.float32
    # the JAX policy casts the same leaves
    jt = j_bf16.cast_to_compute({"w": jnp.ones(2), "idx": jnp.arange(3)})
    assert jt["w"].dtype == jnp.bfloat16 and jt["idx"].dtype == jnp.int32


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("with_scaler", [False, True])
def test_batch_trainer_three_adam_steps_match_jax(with_scaler):
    n, f, c, t, b = 20, 2, 4, 3, 2
    rng = np.random.default_rng(2)
    ei = np.unique(rng.integers(0, n, size=(2, 80)), axis=1)
    w = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    jg = JGraph.from_edge_index(ei, w, num_nodes=n)
    tg = TGraph.from_edge_index(ei, w, num_nodes=n, device="cpu")
    batches = [(rng.normal(size=(b, t, n, f)).astype(np.float32),
                rng.normal(50.0, 10.0, size=(b, t, n, c)).astype(np.float32)
                if with_scaler else
                rng.normal(size=(b, t, n, c)).astype(np.float32))
               for _ in range(3)]

    jmodel = JDCRNNSeq(out_channels=c, K=2)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batches[0][0]),
                         jg)
    tmodel = DCRNNSeq(f, c, 2, device="cpu")
    tmodel.params_from_flax(jax.tree_util.tree_map(np.asarray, params))

    jscaler = tscaler = None
    if with_scaler:
        jscaler = JScaler(mean=jnp.float32(50.0), std=jnp.float32(10.0))
        tscaler = ZScoreScaler(mean=torch.tensor(50.0),
                               std=torch.tensor(10.0))
    jtr = JTrainer(lambda p, x: jmodel.apply(p, x, jg), optax.adam(1e-3),
                   scaler=jscaler)
    ttr = BatchTrainer(tmodel, lambda x: tmodel(x, tg), lr=1e-3,
                       scaler=tscaler, device="cpu")
    state = jtr.init(params)
    for x, y in batches:
        params, state, jloss = jtr.train_step(params, state, jnp.asarray(x),
                                              jnp.asarray(y))
        tloss = ttr.train_step(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = _flatten(jax.tree_util.tree_map(np.asarray, params)["params"])
    got = {k: v.detach().numpy() for k, v in tmodel.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-6, err_msg=k)


def test_fit_runs_epochs_and_reports():
    n = 12
    ei = np.array([[0, 1, 2, 3], [1, 2, 3, 0]])
    g = TGraph.from_edge_index(ei, num_nodes=n, device="cpu")
    model = DCRNNSeq(1, 2, 2, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    tr = BatchTrainer(model, lambda x: model(x, g), device="cpu")
    data = [(torch.randn(1, 2, n, 1), torch.randn(1, 2, n, 2))] * 2
    seen = []
    tr.fit(data, epochs=2, val_loader=data,
           callback=lambda e, loss, val: seen.append((e, loss, val)))
    assert [s[0] for s in seen] == [0, 1]
    assert all(np.isfinite(s[1]) and np.isfinite(s[2]) for s in seen)
