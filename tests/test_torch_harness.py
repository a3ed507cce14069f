"""Port parity of the training harness against the JAX package: TrainState
and apply_gradients, CheckpointManager, save/restore_checkpoint,
DivergenceGuard, DynamicLossScale, make_mixed_precision_step, the
profiling utilities and the harness protocol twin (``protocols/harness.py``
against ``examples/recurrent/harness_example.py``).

Inputs are made with numpy from a seed.  Tolerances: Adam (``torch.optim``
against optax, same formula, f32 rounding in another order) losses and
moments 1e-6 relative, parameters 2e-6 absolute (as ``test_torch_train.py``
holds ``BatchTrainer``); checkpoint round trips and resumes bit for bit;
the loss-scale schedule, the step counts and a skipped f16 update exactly
(the f16 step's parameters and moments 5e-3 of their largest value: f16
gradients); the bf16 mixed-precision step (DCRNNSeq
over bf16 BCSR tiles, both sides through their BCSR kernels' CPU forms:
Pallas in interpret mode, the fused kernel's plain version) 4e-3 relative
on each loss, one bf16 rounding (they agree to the bit on this input); the
harness protocol's losses
1e-5 relative after 3 epochs of one Adam step per snapshot.
"""

import contextlib
import functools
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_temporal_tpu import config_override as j_override
from pytorch_geometric_temporal_tpu import train as jtrain
from pytorch_geometric_temporal_tpu.models import DCRNNSeq as JDCRNNSeq
from pytorch_geometric_temporal_tpu.ops import Graph as JGraph
from pytorch_geometric_temporal_tpu.ops import bcsr as jbcsr
from pytorch_geometric_temporal_tpu_torch import config_override
from pytorch_geometric_temporal_tpu_torch import train as ttrain
from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
from pytorch_geometric_temporal_tpu_torch.ops import Graph as TGraph
from pytorch_geometric_temporal_tpu_torch.ops import bcsr as tbcsr
from pytorch_geometric_temporal_tpu_torch.protocols import harness as tharness
from pytorch_geometric_temporal_tpu_torch.utils import profiling

EXAMPLES = Path(__file__).parent.parent / "examples" / "recurrent"

torch.set_num_threads(1)


def linear_problem(seed=0):
    x = np.random.default_rng(seed).normal(size=(5, 3)).astype(np.float32)
    params = {"w": np.ones((3, 2), np.float32),
              "b": np.zeros((2,), np.float32)}
    return x, params


def torch_state(params, lr=1e-2):
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    return ttrain.TrainState.create(
        module, lambda p: torch.optim.Adam(p, lr=lr, eps=1e-8))


def torch_loss(state, x):
    p = state.params
    return ((torch.from_numpy(x) @ p["w"] + p["b"]) ** 2).mean()


def torch_step(state, x, as_dict=True):
    loss = torch_loss(state, x)
    names = list(dict(state.params.named_parameters()))
    grads = torch.autograd.grad(loss, list(state.params.parameters()))
    ttrain.apply_gradients(state, dict(zip(names, grads)) if as_dict
                           else grads)
    return float(loss.detach())


def jax_run(params, x, steps, opt=None):
    opt = opt or optax.adam(1e-2)
    state = jtrain.TrainState.create(
        {k: jnp.asarray(v) for k, v in params.items()}, opt)

    @jax.jit
    def step(st):
        def loss(p):
            return jnp.mean((jnp.asarray(x) @ p["w"] + p["b"]) ** 2)

        l, grads = jax.value_and_grad(loss)(st.params)
        return jtrain.apply_gradients(st, grads, opt), l

    losses = []
    for _ in range(steps):
        state, l = step(state)
        losses.append(float(l))
    return state, losses


@pytest.mark.parametrize("as_dict", [True, False])
def test_train_state_adam_matches_optax(as_dict):
    x, params = linear_problem()
    jstate, want = jax_run(params, x, 4)
    state = torch_state(params)
    got = [torch_step(state, x, as_dict) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert int(state.step) == int(jstate.step) == 4
    adam = jstate.opt_state[0]
    for name, p in state.params.named_parameters():
        moments = state.opt_state.state[p]
        assert int(moments["step"]) == int(adam.count) == 4
        for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            np.testing.assert_allclose(moments[ours].numpy(),
                                       np.asarray(theirs[name]), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{name} {ours}")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstate.params[name]),
                                   rtol=0, atol=2e-6)


@pytest.mark.parametrize("interval", [1, 2])
def test_checkpoint_manager_matches_orbax(tmp_path, interval):
    x, params = linear_problem()
    jstate = jtrain.TrainState.create(
        {k: jnp.asarray(v) for k, v in params.items()}, optax.adam(1e-2))
    state = torch_state(params)
    saved_j, saved_t = [], []
    with jtrain.CheckpointManager(str(tmp_path / "jax"), max_to_keep=2,
                                  save_interval_steps=interval) as jmgr, \
            ttrain.CheckpointManager(str(tmp_path / "port"), max_to_keep=2,
                                     save_interval_steps=interval) as mgr:
        for step in (1, 2, 3, 4, 4, 5):
            saved_j.append(jmgr.save(step, jstate))
            torch_step(state, x)
            saved_t.append(mgr.save(step, state))
        jmgr.wait()
        mgr.wait()
        assert saved_t == saved_j
        assert mgr.latest_step() == jmgr.latest_step()
        assert list(mgr.all_steps()) == list(jmgr.all_steps())
        assert sorted(os.listdir(tmp_path / "port")) == [
            str(s) for s in mgr.all_steps()]
    with ttrain.CheckpointManager(str(tmp_path / "empty")) as empty:
        assert empty.restore(template=state) is None
        assert empty.latest_step() is None


def test_checkpoint_manager_resume_equals_uninterrupted(tmp_path):
    x, params = linear_problem(1)
    whole = torch_state(params)
    want = [torch_step(whole, x) for _ in range(6)]

    first = torch_state(params)
    with ttrain.CheckpointManager(str(tmp_path), max_to_keep=2) as mgr:
        for _ in range(4):
            torch_step(first, x)
            mgr.save(first.step, first)
        # host copies were taken inside save: stepping on does not leak in
        torch_step(first, x)
    with ttrain.CheckpointManager(str(tmp_path), max_to_keep=2) as mgr:
        assert mgr.all_steps() == [3, 4]
        raw = mgr.restore(step=3)
        assert int(raw["step"]) == 3 and set(raw) == {"step", "params",
                                                 "opt_state"}
        fresh = torch_state(params)
        assert mgr.restore(template=fresh) is fresh and int(fresh.step) == 4
    got = [torch_step(fresh, x) for _ in range(2)]
    assert got == want[4:]
    for a, b in zip(fresh.params.parameters(), whole.params.parameters()):
        assert torch.equal(a, b)


def test_save_restore_checkpoint_matches_jax(tmp_path):
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    jtrain.save_checkpoint(str(tmp_path / "jax"),
                           {"w": jnp.asarray(w), "n": jnp.int32(7)}, step=3)
    state = {"w": torch.from_numpy(w), "n": torch.tensor(7, dtype=torch.int32)}
    ttrain.save_checkpoint(str(tmp_path / "port"), state, step=3)
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == [
        "step_3"]
    assert ttrain.latest_step(str(tmp_path / "port")) == 3 == \
        jtrain.latest_step(str(tmp_path / "jax"))
    assert ttrain.latest_step(str(tmp_path / "none")) is None
    template = {"w": torch.zeros(2, 3, dtype=torch.float64),
                "n": torch.tensor(0, dtype=torch.int32)}
    back = ttrain.restore_checkpoint(str(tmp_path / "port"), step=3,
                                     template=template)
    assert back["w"].dtype == torch.float64 and int(back["n"]) == 7
    np.testing.assert_array_equal(back["w"].numpy(), w)
    raw = ttrain.restore_checkpoint(str(tmp_path / "port"), step=3)
    assert torch.equal(raw["w"], state["w"])
    with pytest.raises(FileExistsError):
        ttrain.save_checkpoint(str(tmp_path / "port"), state, step=3,
                               force=False)


def test_divergence_guard_rolls_back_in_place_updates():
    x, params = linear_problem(2)
    state = torch_state(params)
    torch_step(state, x)
    guard = ttrain.DivergenceGuard(explode_factor=2.0)
    _, _, ok = guard.check(state.params, state.opt_state, 1.0)
    assert ok
    good = {k: v.detach().clone() for k, v in
            state.params.named_parameters()}
    good_moments = {k: {m: t.clone() for m, t in state.opt_state.state[p]
                        .items()} for k, p in state.params.named_parameters()}
    for _ in range(3):  # the optimizer changes the tensors in place
        torch_step(state, x)
    assert not torch.equal(state.params["w"], good["w"])
    # within the factor: healthy, the new state becomes the good one; the
    # JAX guard agrees on each verdict
    jguard = jtrain.DivergenceGuard(explode_factor=2.0)
    jguard.check({}, {}, jnp.float32(1.0))
    for loss, verdict in ((50.0, False), (float("nan"), False)):
        _, _, ok = guard.check(state.params, state.opt_state, loss)
        assert ok == verdict == jguard.check({}, {}, jnp.float32(loss))[2]
        for k, p in state.params.named_parameters():
            assert torch.equal(p, good[k]), k
            for m, t in state.opt_state.state[p].items():
                assert torch.equal(t, good_moments[k][m]), (k, m)
        torch_step(state, x)  # the rolled-back optimizer trains on
    assert not torch.equal(state.params["w"], good["w"])
    assert bool(ttrain.loss_is_finite(torch.tensor(1.0)))
    assert not bool(ttrain.loss_is_finite(torch.tensor(float("inf"))))


def test_dynamic_loss_scale_schedule_matches_jax():
    flags = [True, True, False, True, True, True, True, False, False, True,
             True, True]
    js = jtrain.DynamicLossScale(scale=jnp.float32(2.0 ** 10),
                                 growth_interval=3)
    ts = ttrain.DynamicLossScale(scale=torch.tensor(2.0 ** 10),
                                 growth_interval=3)
    for flag in flags:
        grads = {"a": np.ones(3, np.float32),
                 "b": np.array([1.0, np.inf if not flag else 2.0],
                               np.float32)}
        jf = jtrain.all_finite({k: jnp.asarray(v) for k, v in grads.items()})
        tf = ttrain.all_finite({k: torch.from_numpy(v)
                                for k, v in grads.items()})
        assert bool(tf) == bool(jf) == flag
        np.testing.assert_array_equal(
            ts.unscale({"a": torch.from_numpy(grads["a"])})["a"].numpy(),
            np.asarray(js.unscale({"a": jnp.asarray(grads["a"])})["a"]))
        js, ts = js.adjust(jf), ts.adjust(tf)
        assert float(ts.scale) == float(js.scale)
        assert int(ts.steps_since_growth) == int(js.steps_since_growth)
    assert float(ts.scale_loss(torch.tensor(3.0))) == float(
        js.scale_loss(jnp.float32(3.0)))
    assert bool(ttrain.all_finite({"i": torch.arange(3)}))


def same_tree(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_tree, a, b))
    return a == b


def test_f16_dynamic_scale_skips_overflow_like_jax():
    opt_j = optax.sgd(0.1)
    jstate = jtrain.TrainState.create({"w": jnp.float32(1.0)}, opt_j)
    jscale = jtrain.DynamicLossScale(scale=jnp.float32(2.0 ** 15),
                                     growth_interval=2)
    jstep = jax.jit(jtrain.make_mixed_precision_step(
        lambda p, k: p["w"] * k, opt_j, jtrain.f16_policy,
        dynamic_scale=True))
    module = torch.nn.ParameterDict({"w": torch.nn.Parameter(
        torch.tensor(1.0))})
    state = ttrain.TrainState.create(
        module, lambda p: torch.optim.Adam(p, lr=0.1))
    scale = ttrain.DynamicLossScale(scale=torch.tensor(2.0 ** 15),
                                    growth_interval=2)
    step = ttrain.make_mixed_precision_step(
        lambda p, k: p["w"] * k, None, ttrain.f16_policy, dynamic_scale=True)
    for k in (1e9, 1.0, 1.0, 1e9, 1.0):
        jstate, jscale, _ = jstep(jstate, jscale, jnp.float32(k))
        before = state.snapshot()
        state, scale, loss = step(state, scale, torch.tensor(k))
        assert float(scale.scale) == float(jscale.scale)
        assert int(scale.steps_since_growth) == int(jscale.steps_since_growth)
        assert int(state.step) == int(jstate.step)
        # the overflow steps leave parameters, moments and steps as they were
        assert same_tree(state.snapshot(), before) == (k > 1.0)
    assert float(scale.scale) == 2.0 ** 14  # halved, doubled, halved


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _cotangent_in_x_dtype(mat, x_pad, use_pallas):
    """The JAX package's ``_bcsr_spmm_padded`` with its backward's
    cotangent cast to the input's dtype.  The package's own VJP returns the
    f32 kernel output as the cotangent of a bf16 input, which ``jax.grad``
    refuses, so its bf16 step cannot differentiate through the BCSR route;
    PyTorch's autograd casts such a gradient to the input's dtype, and this
    does the same."""
    return jbcsr._matmul_half(mat.fwd, x_pad, use_pallas)


def _cot_fwd(mat, x_pad, use_pallas):
    return (_cotangent_in_x_dtype(mat, x_pad, use_pallas),
            (mat, jnp.zeros((0,), x_pad.dtype)))


def _cot_bwd(use_pallas, res, g):
    mat, like = res
    gx = jbcsr._matmul_half(mat.bwd, g, use_pallas).astype(like.dtype)
    return jbcsr._zero_cotangent(mat), gx


_cotangent_in_x_dtype.defvjp(_cot_fwd, _cot_bwd)


def test_bf16_step_on_dcrnnseq_matches_jax_through_bcsr(monkeypatch):
    """``bf16_policy`` on DCRNNSeq over a graph above the dense threshold,
    both packages on their BCSR route with bf16 tiles: the JAX side's
    Pallas kernels in interpret mode (its backward's cotangent cast to the
    input's dtype, see :func:`_cotangent_in_x_dtype`), the port's fused
    kernel's plain version.  Five Adam(1e-2) steps."""
    monkeypatch.setattr(jbcsr, "_bcsr_matmul_xla",
                        lambda half, x: jbcsr._bcsr_matmul_pallas(
                            half, x, interpret=True))
    monkeypatch.setattr(jbcsr, "_bcsr_spmm_padded", _cotangent_in_x_dtype)
    rng = np.random.default_rng(0)
    B, T, N, F = 2, 3, 300, 2
    s = rng.integers(0, N, 1500)   # a band (tiles) and random edges (the
    r = np.clip(s + rng.integers(-20, 21, 1500), 0, N - 1)   # remainder)
    ei = np.unique(np.stack([np.r_[s, rng.integers(0, N, 60)],
                             np.r_[r, rng.integers(0, N, 60)]]), axis=1)
    w = rng.uniform(0.5, 1.0, ei.shape[1]).astype(np.float32)
    tiles = []
    inner = tbcsr.bcsr_spmm
    monkeypatch.setattr(tbcsr, "bcsr_spmm", lambda mat, x: tiles.append(
        (mat.fwd.blocks.dtype, mat.fwd.nnzb, mat.fwd.num_rem))
        or inner(mat, x))
    x = rng.normal(size=(B, T, N, F)).astype(np.float32)
    y = rng.normal(size=(B, T, N, F)).astype(np.float32)
    jg = JGraph.from_edge_index(ei, w, N)
    tg = TGraph.from_edge_index(ei, w, N, device="cpu")
    jmodel = JDCRNNSeq(out_channels=F, K=2)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    opt = optax.adam(1e-2)
    jdtypes, tdtypes = [], []

    def jloss(p, xb, yb):
        pred = jmodel.apply(p, xb, jg)     # the graph closed over
        jdtypes.append(pred.dtype)
        return jnp.mean((pred - yb.astype(pred.dtype)) ** 2)

    model = DCRNNSeq(F, F, K=2, device="cpu").params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams))

    def tloss(p, xb, yb):
        pred = torch.func.functional_call(model, p, (xb, tg))
        tdtypes.append(pred.dtype)
        return ((pred - yb.to(pred.dtype)) ** 2).mean()

    with j_override(dense_threshold=16, spmm_backend="pallas"), \
            config_override(dense_threshold=16, spmm_backend="bcsr"):
        jstate = jtrain.TrainState.create(jparams, opt)
        jstep = jax.jit(jtrain.make_mixed_precision_step(
            jloss, opt, jtrain.bf16_policy))
        state = ttrain.TrainState.create(
            model, lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8))
        step = ttrain.make_mixed_precision_step(tloss,
                                                policy=ttrain.bf16_policy)
        want, got = [], []
        for _ in range(5):
            jstate, jl = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
            state, tl = step(state, torch.from_numpy(x), torch.from_numpy(y))
            want.append(float(jl))
            got.append(float(tl))
    # every aggregation went through bf16 tiles and a remainder
    assert len(tiles) == 5 * T * 2 * 2
    assert all(d == torch.bfloat16 and nnzb and rem for d, nnzb, rem in tiles)
    assert tdtypes[0] == torch.bfloat16 and str(jdtypes[0]) == "bfloat16"
    np.testing.assert_allclose(got, want, rtol=4e-3)
    assert got[-1] < got[0]
    for p in state.params.parameters():
        assert p.dtype == torch.float32


@pytest.mark.parametrize("route", ["dense", "bcsr"])
def test_bf16_stage_dtypes_match_jax(route):
    """Under ``bf16_policy`` each stage of DCRNN has the JAX package's
    dtype: an aggregation through the BCSR kernel comes back f32 (the
    dense one in the input's dtype), the basis takes the promoted dtype,
    and the cell's output is bf16 on both routes."""
    from pytorch_geometric_temporal_tpu.models import DCRNN as JDCRNN
    from pytorch_geometric_temporal_tpu.models.recurrent.dcrnn import (
        diffusion_basis as j_basis)
    from pytorch_geometric_temporal_tpu.ops import spmm as j_spmm
    from pytorch_geometric_temporal_tpu_torch.models import DCRNN
    from pytorch_geometric_temporal_tpu_torch.models.recurrent.dcrnn import (
        diffusion_basis as t_basis)
    from pytorch_geometric_temporal_tpu_torch.ops import spmm as t_spmm

    rng = np.random.default_rng(3)
    N, F, C = 200, 3, 4
    ei = np.unique(rng.integers(0, N, size=(2, 1200)), axis=1)
    w = rng.uniform(0.5, 1.0, ei.shape[1]).astype(np.float32)
    x = rng.normal(size=(2, N, F)).astype(np.float32)
    jg = JGraph.from_edge_index(ei, w, N)
    tg = TGraph.from_edge_index(ei, w, N, device="cpu")
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jcell = JDCRNN(C, K=2)
    jp = jtrain.bf16_policy.cast_to_compute(
        jcell.init(jax.random.PRNGKey(0), jnp.asarray(x), jg))
    cell = DCRNN(F, C, K=2, device="cpu")
    tp = ttrain.bf16_policy.cast_to_compute(dict(cell.named_parameters()))
    backends = {"dense": ("dense", "dense"), "bcsr": ("pallas", "bcsr")}
    jb, tb = backends[route]
    with j_override(spmm_backend=jb), config_override(spmm_backend=tb):
        stages = {
            "spmm": (j_spmm(jg, jx), t_spmm(tg, tx)),
            "basis": (j_basis(jg, jx, 2), t_basis(tg, tx, 2)),
            "cell": (jcell.apply(jp, jx, jg),
                     torch.func.functional_call(cell, tp, (tx, tg))),
        }
    for name, (j, t) in stages.items():
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), name
    assert stages["cell"][1].dtype == torch.bfloat16


def test_profiling_utilities(tmp_path):
    timer = profiling.StepTimer(items_per_step=10, warmup=1)
    for _ in range(4):
        with timer:
            torch.ones(1000).sum()
    assert timer.steps == 4 and timer.throughput() > 0
    assert timer.summary().startswith("4 steps, ")
    timer.write_csv(str(tmp_path / "t.csv"))
    lines = (tmp_path / "t.csv").read_text().splitlines()
    assert lines[0] == "step,seconds" and len(lines) == 5
    assert profiling.device_memory_stats() == {}
    assert profiling.device_memory_stats("cpu") == {}
    host = profiling.host_memory_stats()
    assert host["peak_rss"] >= host["rss"] > 0
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(100).cumsum(0)
    assert prof.key_averages()
    assert [p.suffix for p in (tmp_path / "trace").iterdir()] == [".json"]
    per = profiling.device_time_per_iter(lambda a: a * 0.5 + 1.0,
                                         torch.ones(64), iters=40, reps=2)
    assert 0 < per < 0.1


def _load_example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_harness_protocol_matches_jax_example(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(str(EXAMPLES))
    ex = _load_example("harness_example")
    monkeypatch.setattr(ex, "round", lambda v, n: v, raising=False)
    train, _ = ex.chickenpox(lags=32)
    params = jax.jit(ex.RecurrentGCN().init)(jax.random.PRNGKey(0),
                                             train.features[0],
                                             train.graph())
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "jax"))
    _, jhist = ex.main(epochs=3, patience=10)
    tparams = jax.tree_util.tree_map(np.asarray, params)
    quiet = dict(params=tparams, log=lambda *a: None, device="cpu")
    _, hist = tharness.main(3, ckpt_dir=str(tmp_path / "a"), **quiet)
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in jhist]
    for key in ("train_mse", "val_mse"):
        np.testing.assert_allclose([h[key] for h in hist],
                                   [h[key] for h in jhist], rtol=1e-5,
                                   err_msg=key)
    # resume: two epochs, then the third from the checkpoint, bit for bit
    _, first = tharness.main(2, ckpt_dir=str(tmp_path / "b"), **quiet)
    lines = []
    _, second = tharness.main(3, ckpt_dir=str(tmp_path / "b"),
                              **dict(quiet, log=lines.append))
    assert any(line.startswith("resumed from step") for line in lines)
    assert first + second == hist
    assert sorted(os.listdir(tmp_path / "b")) == sorted(
        str(s * train.features.shape[0]) for s in (2, 3))
    # a poisoned epoch is rolled back; the next trains from its start
    _, guarded = tharness.main(3, ckpt_dir=str(tmp_path / "c"),
                               nan_epochs={1}, **quiet)
    assert [h["epoch"] for h in guarded] == [0, 2]
    assert guarded[1]["train_mse"] == hist[1]["train_mse"]


# ---------------------------------------------------------------------------
# The step counter on the device and the f16 step without host reads
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def no_host_reads():
    """``Tensor.__bool__``, ``.item`` and ``.tolist`` raise: a step that
    decides anything on the host from a tensor's value fails here, as it
    would sync with a card."""
    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"Tensor.{name} read a value on the host")
        return read

    saved = {n: getattr(torch.Tensor, n) for n in ("__bool__", "item",
                                                     "tolist")}
    try:
        for name in saved:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def test_host_reads_are_refused_inside_the_guard():
    t = torch.tensor(1.0)
    with no_host_reads():
        for read in (lambda: bool(t), t.item, t.tolist,
                     lambda: float(t > 0) if t > 0 else 0.0):
            with pytest.raises(AssertionError, match="read a value"):
                read()
    assert bool(t) and t.item() == 1.0


@pytest.mark.parametrize("updates", [0, 1, 3])
def test_train_state_step_is_a_device_scalar_like_jax(updates):
    """``create`` gives a 0-d int32 step on the parameters' device, as the
    JAX state's ``jnp.zeros((), jnp.int32)``; each update increments that
    same tensor in place, and it counts as the JAX step does."""
    x, params = linear_problem(3)
    jstate, _ = jax_run(params, x, updates)
    state = torch_state(params)
    step = state.step
    assert step.dtype == torch.int32 and step.dim() == 0
    assert step.device == state.params["w"].device
    for _ in range(updates):
        torch_step(state, x)
    assert state.step is step
    assert int(state.step) == int(jstate.step) == updates
    assert state.snapshot()["step"] is not step


def test_checkpoint_with_an_int_step_still_loads(tmp_path):
    """A checkpoint written while the step was a Python int restores: the
    state's step tensor takes its value in place."""
    x, params = linear_problem(4)
    old = torch_state(params)
    for _ in range(2):
        torch_step(old, x)
    saved = ttrain.state.to_host(old)
    saved["step"] = 7
    os.makedirs(tmp_path / "7")
    torch.save(saved, tmp_path / "7" / ttrain.state.STATE_FILE)
    fresh = torch_state(params)
    step = fresh.step
    with ttrain.CheckpointManager(str(tmp_path)) as mgr:
        assert mgr.latest_step() == 7
        assert mgr.restore(template=fresh) is fresh
    assert fresh.step is step and int(fresh.step) == 7
    assert step.dtype == torch.int32
    for a, b in zip(fresh.params.parameters(), old.params.parameters()):
        assert torch.equal(a, b)
    assert torch_step(fresh, x) == torch_step(old, x)


def test_loading_and_rolling_back_keep_every_tensor_in_place():
    """``load_state_dict`` and ``DivergenceGuard``'s rollback copy into the
    tensors the state already holds (a captured step reads them in place):
    the step, the parameters and every tensor of Adam's state keep their
    identity and take the loaded values."""
    x, params = linear_problem(5)
    state = torch_state(params)
    torch_step(state, x)
    snap = state.snapshot()
    held = state_tensors(state)
    for _ in range(2):
        torch_step(state, x)
    state.load_state_dict(snap)
    assert all(a is b for a, b in zip(state_tensors(state), held))
    assert same_tree(state.snapshot(), snap)
    guard = ttrain.DivergenceGuard()
    guard.check(state.params, state.opt_state, 1.0)
    torch_step(state, x)
    guard.check(state.params, state.opt_state, float("nan"))
    assert all(a is b for a, b in zip(state_tensors(state), held))
    assert same_tree({k: v for k, v in state.snapshot().items()
                      if k != "step"},
                     {k: v for k, v in snap.items() if k != "step"})


def state_tensors(state):
    return ([state.step] + list(state.params.parameters())
            + [t for s in state.opt_state.state.values()
               for t in s.values()])


def test_create_makes_the_optimizer_state_as_optax_init_does():
    """``TrainState.create`` gives Adam its state at once, as optax's
    ``init`` does: zero moments and step count, the parameters untouched;
    the first update then equals that of an Adam whose state is made
    lazily, bit for bit."""
    x, params = linear_problem(6)
    state = torch_state(params)
    jinit = optax.adam(1e-2).init({k: jnp.asarray(v)
                                   for k, v in params.items()})[0]
    for name, p in state.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[name])
        moments = state.opt_state.state[p]
        assert p.grad is None
        assert float(moments["step"]) == int(jinit.count) == 0
        np.testing.assert_array_equal(moments["exp_avg"].numpy(),
                                      np.asarray(jinit.mu[name]))
        np.testing.assert_array_equal(moments["exp_avg_sq"].numpy(),
                                      np.asarray(jinit.nu[name]))
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    lazy = ttrain.TrainState(step=torch.zeros((), dtype=torch.int32),
                             params=module,
                             opt_state=torch.optim.Adam(
                                 module.parameters(), lr=1e-2, eps=1e-8))
    assert not lazy.opt_state.state
    for _ in range(2):
        assert torch_step(state, x) == torch_step(lazy, x)
    assert same_tree(state.snapshot(), lazy.snapshot())


def test_dynamic_loss_scale_is_a_pytree_node():
    """Its two tensors are leaves and its three numbers the node's context,
    so a captured step takes the scale as inputs and returns it as
    outputs, and a new scale of the same shapes keeps the signature."""
    pytree = torch.utils._pytree
    scale = ttrain.DynamicLossScale(scale=torch.tensor(8.0),
                                    growth_interval=3, shrink_factor=0.25)
    leaves, spec = pytree.tree_flatten(scale)
    assert len(leaves) == 2 and leaves[0] is scale.scale
    assert leaves[1] is scale.steps_since_growth
    back = pytree.tree_unflatten([torch.tensor(4.0), torch.tensor(
        2, dtype=torch.int32)], spec)
    assert isinstance(back, ttrain.DynamicLossScale)
    assert (back.growth_factor, back.shrink_factor, back.growth_interval) == (
        2.0, 0.25, 3)
    assert float(back.scale) == 4.0 and int(back.steps_since_growth) == 2
    doubled = pytree.tree_map(lambda t: t * 2, scale)
    assert float(doubled.scale) == 16.0 and doubled.growth_interval == 3
    assert pytree.tree_flatten(scale.adjust(torch.tensor(False)))[1] == spec


@pytest.mark.parametrize("dynamic_scale", [False, True])
def test_mixed_precision_step_capture_switch_on_the_cpu(dynamic_scale):
    """On a CPU state ``capture=None`` runs eagerly (no graph) and
    ``capture=True`` raises."""
    x, params = linear_problem(7)
    xt = torch.from_numpy(x)

    def loss_fn(p, xb):
        return ((xb @ p["w"] + p["b"]) ** 2).mean()

    args = ((ttrain.DynamicLossScale(),) if dynamic_scale else ()) + (xt,)
    for capture in (None, False):
        state = torch_state(params)
        step = ttrain.make_mixed_precision_step(
            loss_fn, policy=ttrain.f32_policy, dynamic_scale=dynamic_scale,
            capture=capture)
        for _ in range(2):
            out = step(state, *args)
        assert out[0] is state and torch.isfinite(out[-1])
        assert int(state.step) == 2
        assert (step.graphs.captures, step.graphs.replays) == (0, 0)
    step = ttrain.make_mixed_precision_step(
        loss_fn, dynamic_scale=dynamic_scale, capture=True)
    with pytest.raises(ValueError, match="capture=True needs a CUDA"):
        step(torch_state(params), *args)


def test_a_non_capturable_optimizer_is_refused_by_a_capture():
    """A captured step needs a capturable optimizer: the check names the
    groups and the option; ``make_capturable`` leaves CPU parameters and
    an optimizer that already has state as they are."""
    check = ttrain.state.check_capturable
    x, params = linear_problem(8)
    state = torch_state(params)
    with pytest.raises(ValueError, match=r"groups \[0\] have capturable="
                                         r"False.*capture=False"):
        check(state, "step")
    ttrain.state.make_capturable(state.opt_state)
    assert state.opt_state.param_groups[0]["capturable"] is False
    capturable = torch.optim.Adam(state.params.parameters(),
                                  capturable=True)
    check(ttrain.TrainState(
        step=state.step, params=state.params, opt_state=capturable), "step")
    check(ttrain.TrainState(
        step=state.step, params=state.params,
        opt_state=torch.optim.SGD(state.params.parameters(), lr=0.1)),
        "step")


def test_all_finite_lies_on_the_trees_device():
    """The flag is a 0-d bool on the device of the tree's tensors, also
    when no tensor is a float one (then True), as on the card it must not
    come from the host."""
    meta = {"i": torch.arange(3, device="meta")}
    flag = ttrain.all_finite(meta)
    assert flag.device.type == "meta" and flag.dtype == torch.bool
    assert flag.dim() == 0
    assert bool(ttrain.all_finite({"i": torch.arange(3)}))
    assert bool(ttrain.all_finite({}))
    assert ttrain.all_finite({"f": torch.ones(2, device="meta")}).is_meta


def test_f16_scaled_step_reads_nothing_on_the_host_and_matches_jax():
    """The f16 step with a dynamic scale decides its skip on the device:
    it runs with host reads refused.  Against the JAX package's jitted
    ``step_scaled`` (optax.adam(1e-2); the port's Adam fused, whose CPU
    form keeps its step count in a tensor), planted overflows leave the
    parameters, Adam's moments and step count and ``state.step`` unchanged
    bit for bit; the scale, its counter and every step count equal the
    JAX ones exactly; the parameters and moments agree within 5e-3 of
    each one's largest value (gradients in f16, 2^-11 a rounding, from
    parameters that differ in f32's last bits: 2.3e-3 read)."""
    rng = np.random.default_rng(9)
    w = rng.normal(size=(3, 2)).astype(np.float32)
    b = np.zeros(2, np.float32)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    opt = optax.adam(1e-2)
    jstate = jtrain.TrainState.create({"w": jnp.asarray(w),
                                       "b": jnp.asarray(b)}, opt)
    jscale = jtrain.DynamicLossScale(scale=jnp.float32(2.0 ** 10),
                                     growth_interval=2)
    jstep = jax.jit(jtrain.make_mixed_precision_step(
        lambda p, xb: jnp.mean((xb @ p["w"] + p["b"]) ** 2), opt,
        jtrain.f16_policy, dynamic_scale=True))
    module = torch.nn.ParameterDict(
        {"w": torch.nn.Parameter(torch.from_numpy(w.copy())),
         "b": torch.nn.Parameter(torch.from_numpy(b.copy()))})
    state = ttrain.TrainState.create(
        module, lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8, fused=True))
    scale = ttrain.DynamicLossScale(scale=torch.tensor(2.0 ** 10),
                                    growth_interval=2)
    step = ttrain.make_mixed_precision_step(
        lambda p, xb: ((xb @ p["w"] + p["b"]) ** 2).mean(), None,
        ttrain.f16_policy, dynamic_scale=True)
    for k in (1e9, 1.0, 1.0, 1e9, 1.0):
        jstate, jscale, jloss = jstep(jstate, jscale, jnp.asarray(x * k))
        before = state.snapshot()
        with no_host_reads():
            state, scale, loss = step(state, scale,
                                      torch.from_numpy(x * np.float32(k)))
        assert same_tree(state.snapshot(), before) == (k > 1.0)
        assert np.isfinite(float(loss)) == (k == 1.0)
        assert float(scale.scale) == float(jscale.scale)
        assert int(scale.steps_since_growth) == int(jscale.steps_since_growth)
        assert int(state.step) == int(jstate.step)
        adam = jstate.opt_state[0]
        for name, p in module.items():
            moments = state.opt_state.state[p]
            assert int(moments["step"]) == int(adam.count)
            for ours, theirs in ((p.detach(), jstate.params[name]),
                                 (moments["exp_avg"], adam.mu[name]),
                                 (moments["exp_avg_sq"], adam.nu[name])):
                want = np.asarray(theirs)
                np.testing.assert_allclose(
                    ours.numpy(), want, rtol=0,
                    atol=5e-3 * float(np.abs(want).max()), err_msg=name)
    assert int(state.step) == 3 and float(scale.scale) == 2.0 ** 9
