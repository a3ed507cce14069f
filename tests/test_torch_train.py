"""Port parity: losses, dtype policy, scaler and BatchTrainer against the JAX
package (``train/``).

Inputs are made with numpy from a seed.  Losses and scaler are the same
f32 formulas (1e-6).  Three Adam steps of BatchTrainer on optax.adam(1e-3)
and on torch.optim.Adam(lr=1e-3, eps=1e-8) from the same transplanted
parameters agree to 2e-6 per parameter: each update moves a parameter by
~1e-3 and the gradients agree to f32 summation order.
"""

import collections
import copy
import traceback

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
from pytorch_geometric_temporal_tpu_torch.ops import bcsr as tb
from pytorch_geometric_temporal_tpu_torch.signal import StackedSignal
from pytorch_geometric_temporal_tpu_torch.train import (
    BatchTrainer, SnapshotTrainer, ZScoreScaler, bf16_policy, f32_policy)
from pytorch_geometric_temporal_tpu_torch.train import losses as tl
from pytorch_geometric_temporal_tpu_torch.train import trainer as ttrainer


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


# --- the trainers' capture switch (CUDA graphs run on the card only:
# tests/test_torch_cuda.py; here, what the CPU trainers do and the pieces
# of the signature and the error that need no card) ----------------------


def _snapshot_setup():
    """A StackedSignal of 4 snapshots on the CPU and a linear model over
    the threaded state."""
    rng = np.random.default_rng(5)
    signal = StackedSignal.from_arrays(
        rng.normal(size=(4, 6, 3)).astype(np.float32),
        rng.normal(size=(4, 6)).astype(np.float32),
        np.array([[0, 1, 2], [1, 2, 0]]), device="cpu")
    model = torch.nn.Linear(3, 1)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(
            rng.normal(size=(1, 3)).astype(np.float32)))
        model.bias.zero_()

    def loss_and_state(carry, x, y, graph):
        out = model(x)[:, 0] + (0.0 if carry is None else 0.5 * carry)
        return tl.mse(out, y), out

    return model, loss_and_state, signal


def _batch_setup():
    rng = np.random.default_rng(6)
    model = torch.nn.Linear(4, 2)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(
            rng.normal(size=(2, 4)).astype(np.float32)))
        model.bias.zero_()
    batches = [(torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32)),
                torch.from_numpy(rng.normal(size=(5, 2)).astype(np.float32)))
               for _ in range(3)]
    return model, batches


@pytest.mark.parametrize("kind", ["batch", "snapshot"])
def test_cpu_trainer_defaults_to_eager_with_the_same_numbers(kind):
    """A CPU trainer does not capture, builds the optimizer it always built
    (Adam, not capturable) and gives, bit for bit, the losses and
    parameters of the plain eager loop it runs."""
    if kind == "batch":
        model, batches = _batch_setup()
        ref = copy.deepcopy(model)
        tr = BatchTrainer(model, lr=1e-2, device="cpu")
        got = [tr.train_step(x, y) for x, y in batches]
        opt = torch.optim.Adam(ref.parameters(), lr=1e-2,
                               betas=(0.9, 0.999), eps=1e-8)
        want = []
        for x, y in batches:
            opt.zero_grad(set_to_none=True)
            loss = tl.mse(ref(x), y)
            loss.backward()
            opt.step()
            want.append(loss.detach())
        evals = (tr.eval_step(*batches[0]), tl.mse(ref(batches[0][0]),
                                                   batches[0][1]))
    else:
        model, loss_and_state, signal = _snapshot_setup()
        ref = copy.deepcopy(model)
        tr = SnapshotTrainer(model, loss_and_state, lr=1e-2, device="cpu")
        got = [tr.train_epoch(signal, None) for _ in range(3)]
        opt = torch.optim.Adam(ref.parameters(), lr=1e-2,
                               betas=(0.9, 0.999), eps=1e-8)

        def epoch_loss():
            total, carry = torch.zeros(()), None
            for t in range(signal.snapshot_count):
                out = ref(signal.features[t])[:, 0] + (
                    0.0 if carry is None else 0.5 * carry)
                total, carry = total + tl.mse(out, signal.targets[t]), out
            return total / signal.snapshot_count

        want = []
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            loss = epoch_loss()
            loss.backward()
            opt.step()
            want.append(loss.detach())
        with torch.no_grad():
            evals = (tr.evaluate(signal, None), epoch_loss())
    assert tr.capture is False and tr.captures == 0 and tr.replays == 0
    assert tr.optimizer.param_groups[0]["capturable"] is False
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(*evals)
    for p, q in zip(model.parameters(), ref.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("kind", ["batch", "snapshot"])
def test_capture_true_on_cpu_raises(kind):
    model, *rest = _batch_setup() if kind == "batch" else _snapshot_setup()
    with pytest.raises(ValueError, match="capture=True needs a CUDA"):
        if kind == "batch":
            BatchTrainer(model, device="cpu", capture=True)
        else:
            SnapshotTrainer(model, rest[0], device="cpu", capture=True)
    tr = (BatchTrainer(model, device="cpu", capture=False) if kind == "batch"
          else SnapshotTrainer(model, rest[0], device="cpu", capture=False))
    assert tr.capture is False and tr.captures == 0


Point = collections.namedtuple("Point", "a b")


@pytest.mark.parametrize("tree", [
    (torch.ones(2), torch.zeros(3, 1)),
    (None,),
    ((),),
    ({"h": torch.ones(2), "c": [torch.zeros(1), 3]}, 2.5),
    (Point(torch.ones(1), "x"),),
])
def test_step_signature_flattens_and_rebuilds(tree):
    """The capture's signature: tensors become static-input slots keyed by
    shape, strides and dtype, the rest is keyed by value (by identity when
    unhashable) and held objects by identity; rebuilding from the slots
    gives the same structure."""
    key, leaves, spec = ttrainer._signature(tree, ())
    hash(key)
    again, same_leaves, _ = ttrainer._signature(tree, ())
    assert again == key
    assert all(a is b for a, b in zip(leaves, same_leaves))
    rebuilt = torch.utils._pytree.tree_unflatten(leaves, spec)
    assert ttrainer._signature(rebuilt, ())[0] == key
    wider = torch.utils._pytree.tree_map(
        lambda v: torch.cat([v, v]) if isinstance(v, torch.Tensor) else v,
        tree)
    halved = torch.utils._pytree.tree_map(
        lambda v: v.half() if isinstance(v, torch.Tensor) else v, tree)
    tensors = any(isinstance(v, torch.Tensor) for v in leaves)
    assert (ttrainer._signature(wider, ())[0] != key) is tensors
    assert (ttrainer._signature(halved, ())[0] != key) is tensors
    o1, o2 = object(), object()
    assert ttrainer._signature(tree, (o1,))[0] == ttrainer._signature(
        tree, (o1,))[0]
    assert ttrainer._signature(tree, (o1,))[0] != ttrainer._signature(
        tree, (o2,))[0]


def test_static_inputs_keep_a_views_layout():
    """A window view keeps its strides in its static buffer (the step sees
    the layout it sees eagerly); a broadcast view, which cannot be written,
    gets a dense buffer; a tensor from another device takes ``.to``'s
    layout."""
    win = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    view = win[:, :3]
    static = ttrainer._static_like(view, torch.device("cpu"))
    assert static.stride() == view.stride() and static.shape == view.shape
    static.copy_(view)
    assert torch.equal(static, view)
    wide = torch.ones(3, 1).expand(3, 4)
    dense = ttrainer._static_like(wide, torch.device("cpu"))
    assert dense.is_contiguous()
    dense.copy_(wide)
    meta = ttrainer._static_like(win.transpose(0, 1), torch.device("meta"))
    assert meta.stride() == win.transpose(0, 1).stride()


def _blocked_op():
    raise RuntimeError("CUDA error: operation not permitted when stream is "
                       "capturing\nmore detail")


def test_uncapturable_step_error_names_the_step_and_the_opt_out():
    """The error names the step, the first line of what blocked it and
    ``capture=False``; raised from the original, its chained traceback
    reaches the blocking frame."""
    with pytest.raises(RuntimeError) as info:
        try:
            _blocked_op()
        except RuntimeError as exc:
            raise ttrainer._not_capturable("BatchTrainer.train_step",
                                           exc) from exc
    text = str(info.value)
    assert text.startswith("BatchTrainer.train_step: the step cannot be "
                           "captured")
    assert "operation not permitted when stream is capturing" in text
    assert "more detail" not in text and "capture=False" in text
    frames = traceback.extract_tb(info.value.__cause__.__traceback__)
    assert frames[-1].name == "_blocked_op"


def test_launch_counts_are_taken_back_and_added():
    """What a capture counted (nothing ran) is taken back out, and a replay
    adds it again: the counters stay kernels executed."""
    tb.reset_launch_counts()
    assert tb.launch_counts() == (0, 0, 0)
    tb.add_launch_counts((30, 0, 0))
    assert tb.hybrid_spmm.launches == 30 and tb.launch_counts() == (30, 0, 0)
    tb.add_launch_counts((-30, 0, 0))
    assert tb.launch_counts() == (0, 0, 0)


def test_signature_keys_hold_their_objects_by_identity():
    """A held signal (a frozen dataclass: unhashable, equal by its fields)
    and an unhashable leaf are keyed by identity; the key holds its object,
    so its id is not taken by another while the key lives."""
    _, _, signal = _snapshot_setup()
    twin = copy.copy(signal)
    key = ttrainer._signature((None,), (signal,))[0]
    assert key == ttrainer._signature((None,), (signal,))[0]
    assert key != ttrainer._signature((None,), (twin,))[0]
    box = {1}
    assert ttrainer._signature(({"k": box},), ())[0] == ttrainer._signature(
        ({"k": box},), ())[0]
    assert ttrainer._signature(({"k": box},), ())[0] != ttrainer._signature(
        ({"k": {1}},), ())[0]
    ref = ttrainer._Id(object())
    assert ref == ttrainer._Id(ref.obj) and hash(ref) == id(ref.obj)


def test_snapshot_epochs_reuse_the_operators_of_the_signals_graph():
    """A SnapshotTrainer epoch aggregates over the graph the signal hands
    its step: the signal keeps that graph, so an operator derived from it
    in the first epoch (memoized on the instance) is the one every later
    epoch and evaluation uses, as a captured epoch needs."""
    from pytorch_geometric_temporal_tpu_torch.ops.graph import cheb_norm

    model, _, signal = _snapshot_setup()
    seen = []

    def loss_and_state(carry, x, y, graph):
        op = cheb_norm(graph)
        seen.append(op)
        out = model(x)[:, 0] + op.weights.sum()
        return tl.mse(out, y), carry

    tr = SnapshotTrainer(model, loss_and_state, lr=1e-2, device="cpu")
    for _ in range(2):
        assert torch.isfinite(tr.train_epoch(signal, None))
    assert torch.isfinite(tr.evaluate(signal, None))
    assert len(seen) == 3 * signal.snapshot_count
    assert all(op is seen[0] for op in seen)


def test_counters_are_taken_back_at_capture_and_added_at_replay():
    """One mechanism for every counter a capture bumps without running
    anything: what the launches and the collectives' bytes gained over a
    capture is read as one delta, taken back out, and added at each
    replay."""
    from pytorch_geometric_temporal_tpu_torch import _counters
    from pytorch_geometric_temporal_tpu_torch.parallel import collectives

    tb.reset_launch_counts()
    collectives.reset_collective_bytes()
    before = _counters.read()
    assert {"bcsr_launches", "collective_bytes"} <= set(before)
    tb.add_launch_counts((94, 0, 0))                   # as a capture would
    collectives.collective_bytes["all_reduce"] += 512
    counted = _counters.counted_since(before)
    assert counted["bcsr_launches"] == (94, 0, 0)
    assert counted["collective_bytes"] == (0, 0, 0, 512)
    _counters.add(counted, -1)
    assert _counters.read() == before
    for replay in range(1, 3):
        _counters.add(counted)
        assert tb.launch_counts() == (94 * replay, 0, 0)
        assert collectives.collective_bytes["all_reduce"] == 512 * replay
    tb.reset_launch_counts()
    collectives.reset_collective_bytes()


def test_step_outputs_come_back_as_fresh_tensors_of_the_same_tree():
    """A replay returns clones of the graph's outputs in their tree: the
    loss, or the loss scale (a pytree node) and the loss."""
    from pytorch_geometric_temporal_tpu_torch.train import DynamicLossScale

    out = (DynamicLossScale(scale=torch.tensor(4.0), growth_interval=5),
           torch.tensor(0.5), None)
    got = ttrainer._clone(out)
    assert isinstance(got[0], DynamicLossScale) and got[2] is None
    assert got[0].growth_interval == 5
    for a, b in ((got[0].scale, out[0].scale), (got[1], out[1]),
                 (got[0].steps_since_growth, out[0].steps_since_growth)):
        assert torch.equal(a, b) and a is not b
        assert a.data_ptr() != b.data_ptr()
    assert ttrainer._clone(out[1]) is not out[1]


def test_builder_graphs_run_eagerly_on_the_cpu_and_refuse_capture_true():
    """A builder's graphs learn the device at each call: on the CPU
    ``capture=None`` and False call the step as it is, True raises."""
    calls = []

    def fn(a, b):
        calls.append((a, b))
        return a + b

    cpu = torch.device("cpu")
    for capture in (None, False):
        graphs = ttrainer._DeviceGraphs("step", capture)
        assert not graphs.captures_on(cpu)
        assert graphs(cpu, fn, (torch.ones(1), torch.ones(1)), held=(fn,)) \
            == 2
        assert (graphs.captures, graphs.replays) == (0, 0)
    assert len(calls) == 2
    with pytest.raises(ValueError, match="capture=True needs a CUDA"):
        ttrainer._DeviceGraphs("step", True)(cpu, fn, (1, 2))
    assert len(calls) == 2
