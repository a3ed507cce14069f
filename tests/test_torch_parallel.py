"""Port parity of the parallel package against the JAX package: meshes over
process groups, the three partitioned exchanges, the partitioned DCRNN, the
data-parallel step, the 2-D (dp × graph) mesh, the consistency check, and
the native edge grouping.

Four gloo ranks on the CPU are spawned once for the file
(``tests/_torch_parallel_ranks.py``, a ``file://`` store under a temporary
directory); they run every case and write their arrays, while this process
computes the JAX package's results on the same seeded inputs (shard_map
over ``make_mesh({"graph": P})`` of the 8 virtual CPU devices, as its own
tests run).  P=2 cases run on the 'graph' axis of a dp=2 × graph=2 mesh,
P=4 on a 4-rank one.  Tolerances are the JAX package's own
(``tests/test_parallel.py``, ``tests/test_partitioned_dcrnn.py``):
aggregations 1e-5 absolute, their gradients 1e-4, the partitioned cell
1e-4 against the single-device cell and 1e-5 against the partitioned one,
the sequence's loss 1e-4 relative and its gradients 1e-3 relative + 1e-4
absolute, the data-parallel step 1e-5 (loss relative, parameters
absolute), the 2-D mesh 2e-4; counted bytes and partition arrays exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_temporal_tpu import native as jnative
from pytorch_geometric_temporal_tpu import parallel as jpar
from pytorch_geometric_temporal_tpu.config import config_override as jover
from pytorch_geometric_temporal_tpu.models import DCRNN as JDCRNN
from pytorch_geometric_temporal_tpu.models import DCRNNSeq as JDCRNNSeq
from pytorch_geometric_temporal_tpu.ops import Graph as JGraph
from pytorch_geometric_temporal_tpu.ops import spmm_segment as jsegment
from pytorch_geometric_temporal_tpu.train.losses import (
    masked_mae_loss as jmasked_mae)
from pytorch_geometric_temporal_tpu_torch import native as tnative
from pytorch_geometric_temporal_tpu_torch import parallel as tpar
from pytorch_geometric_temporal_tpu_torch.models import DCRNN
from pytorch_geometric_temporal_tpu_torch.ops import Graph as TGraph
from _torch_jax_native import jax_native  # noqa: F401

# the JAX package's native library, loaded race-free: its RCM order is
# what the port's native layer is compared with (see the module)
pytestmark = pytest.mark.usefixtures("jax_native")


REPO = Path(__file__).parent.parent
RANKS = Path(__file__).parent / "_torch_parallel_ranks.py"
WORLD = 4
EXCHANGES = (("gather", "receiver"), ("scatter", "sender"), ("halo", "halo"))
CASES = [(ex, p) for ex, _ in EXCHANGES for p in (2, 4)]

torch.set_num_threads(1)


def random_graph(rng, n, e):
    ei = np.unique(rng.integers(0, n, size=(2, e)), axis=1)
    return ei, rng.uniform(0.5, 2.0, size=ei.shape[1]).astype(np.float32), n


def ring_graph(rng, n, e):
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n])
    ei = np.unique(np.concatenate([ring, ring[::-1],
                                   rng.integers(0, n, (2, e))], axis=1),
                   axis=1)
    return ei, rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32), n


def jgraph(spec):
    ei, w, n = spec
    return JGraph.from_edge_index(ei, w, num_nodes=n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = "/".join(k.key for k in path)
        out[f"{prefix}/{keys}"] = np.asarray(leaf)
    return out


def by_name(tree):
    """A flax parameter tree by the port's names (``cell.w_zr``)."""
    return {k.split("/", 2)[2].replace("/", "."): v
            for k, v in flat(tree, "t").items()}


def shifted(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05, tree)


def make_inputs():
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    graphs = {"g": random_graph(rng, 43, 170), "gd": ring_graph(rng, 37, 180),
              "gdp": random_graph(rng, 12, 40),
              "g2d": random_graph(rng, 16, 50)}
    arr = {"x": rng.normal(size=(43, 5)),
           "x3": rng.normal(size=(37, 3, 4)),
           "cell/x": rng.normal(size=(3, 37, 2)),
           "cell/h": rng.normal(size=(3, 37, 5)),
           "seq/x": rng.normal(size=(2, 4, 37, 2)),
           "seq/y": rng.normal(size=(2, 4, 37, 4)),
           "dp/x": rng.normal(size=(8, 4, 12, 3)),
           "dp/y": rng.normal(size=(8, 4, 12, 8)),
           "2d/x": rng.normal(size=(4, 3, 16, 3)),
           "2d/y": rng.normal(size=(4, 3, 16, 8))}
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    # zeros spread unevenly over the four ranks' shards of two rows each:
    # 60% of rank 0's targets, 10% of rank 1's, none of the others'
    y = arr["dp/y"].copy()
    for rows, frac in ((slice(0, 2), 0.6), (slice(2, 4), 0.1)):
        y[rows][rng.uniform(size=y[rows].shape) < frac] = 0.0
    arr["dp/y_masked"] = y
    for name, (ei, w, n) in graphs.items():
        arr.update({f"{name}/ei": ei, f"{name}/w": w, f"{name}/n": np.int64(n)})
    jg = {k: jgraph(v) for k, v in graphs.items()}

    def init(model, x, g):
        return np_tree(jax.jit(lambda k, v: model.init(k, v, g))(
            key, jnp.asarray(x)))

    with jover(spmm_backend="segment"):
        trees = {
            "tree_cell": init(JDCRNN(out_channels=5, K=3), arr["cell/x"],
                              jg["gd"]),
            "tree_seq": shifted(init(JDCRNNSeq(out_channels=4, K=2),
                                     arr["seq/x"], jg["gd"])),
            "tree_dp": shifted(init(JDCRNNSeq(out_channels=8, K=2),
                                    arr["dp/x"], jg["gdp"])),
            "tree_2d": shifted(init(JDCRNNSeq(out_channels=8, K=2),
                                    arr["2d/x"], jg["g2d"])),
        }
    for name, tree in trees.items():
        arr.update(flat(tree, name))
    return arr, graphs, jg, trees


def jax_exchanges(arr, jg):
    """One jitted program a mesh size for every exchange's output and
    gradient (a shard_map each); the segment oracle; the trailing dims."""
    x, out = jnp.asarray(arr["x"]), {}
    for P in (2, 4):
        mesh = jpar.make_mesh({"graph": P})
        parts = {exchange: jpar.PartitionedGraph.from_graph(jg["g"], P, by=by)
                 for exchange, by in EXCHANGES}

        @jax.jit
        def run(x, mesh=mesh, parts=parts):
            res = {}
            for exchange, pg in parts.items():
                def loss(xp, pg=pg, exchange=exchange):
                    return (jpar.spmm_partitioned(
                        pg, xp, mesh, exchange=exchange) ** 2).sum()

                xp = pg.pad_features(x)
                res[exchange] = dict(
                    out=jpar.spmm_partitioned(pg, xp, mesh,
                                              exchange=exchange),
                    grad=jax.grad(loss)(xp))
            return res

        for exchange, res in np_tree(run(x)).items():
            res["formula"] = parts[exchange].ici_bytes_per_step(x.shape[1])
            out[f"{exchange}{P}"] = res
    out["segment"], out["segment_grad"] = np_tree(jax.jit(lambda v: (
        jsegment(jg["g"], v), jax.grad(
            lambda u: (jsegment(jg["g"], u) ** 2).sum())(v)))(x))
    # trailing dims: the halo exchange of (N_pad, 3, 4)
    mesh = jpar.make_mesh({"graph": 4})
    pops = jpar.PartitionedDiffusionOperators.from_graph(jg["gd"], 4)
    out["trailing"] = np.asarray(jax.jit(lambda v: jpar.spmm_partitioned(
        pops.p_fwd, pops.pad_features(v), mesh, exchange="halo"))(
            jnp.asarray(arr["x3"])))
    return out


def jax_dcrnn(arr, jg, trees):
    g, out = jg["gd"], {}
    x, h = jnp.asarray(arr["cell/x"]), jnp.asarray(arr["cell/h"])
    single_cell = JDCRNN(out_channels=5, K=3)
    with jover(spmm_backend="segment"):
        out["cell_single"] = np.asarray(jax.jit(
            lambda p: single_cell.apply(p, x, g, h))(trees["tree_cell"]))
    mesh = jpar.make_mesh({"graph": 4})
    pops = jpar.PartitionedDiffusionOperators.from_graph(g, 4)
    part_cell = jpar.DCRNNPartitioned(out_channels=5, K=3)
    out["cell_part"] = np.asarray(jax.jit(lambda p: part_cell.apply(
        p, pops.pad_features(x.transpose(1, 0, 2)), pops, mesh,
        pops.pad_features(h.transpose(1, 0, 2))))(trees["tree_cell"]))

    xs, ys = jnp.asarray(arr["seq/x"]), jnp.asarray(arr["seq/y"])
    n = xs.shape[2]
    single = JDCRNNSeq(out_channels=4, K=2)
    with jover(spmm_backend="segment"):
        out["seq_single"] = jax.jit(jax.value_and_grad(
            lambda p: jnp.mean((single.apply(p, xs, g) - ys) ** 2)))(
                trees["tree_seq"])
    part = jpar.DCRNNPartitionedSeq(out_channels=4, K=2)
    xt = jnp.pad(xs.transpose(1, 2, 0, 3),
                 ((0, 0), (0, pops.padded_nodes - n), (0, 0), (0, 0)))
    yt = ys.transpose(1, 2, 0, 3)

    def loss_part(p):
        hs = part.apply(p, xt, pops, mesh)
        return jnp.mean((hs[:, :n] - yt) ** 2)

    out["seq_part"] = jax.jit(jax.value_and_grad(loss_part))(
        trees["tree_seq"])
    return out


def jax_dp(arr, jg, trees):
    g, out = jg["gdp"], {}
    model = JDCRNNSeq(out_channels=8, K=2)
    mesh = jpar.make_mesh({"dp": 8})
    opt = optax.sgd(0.1)
    for case, y, loss in (
            ("mse", arr["dp/y"], lambda a, b: jnp.mean((a - b) ** 2)),
            ("masked", arr["dp/y_masked"], jmasked_mae)):
        def loss_fn(p, xb, yb, loss=loss):
            return loss(model.apply(p, xb, g), yb)

        params = trees["tree_dp"]
        step = jpar.make_dp_train_step(loss_fn, opt, mesh, donate=False)
        p_new, _, value = step(
            jpar.replicate(params, mesh),
            jpar.replicate(opt.init(params), mesh),
            jpar.shard_batch(jnp.asarray(arr["dp/x"]), mesh),
            jpar.shard_batch(jnp.asarray(y), mesh))
        out[case] = (float(value), by_name(np_tree(p_new)))
    # the 2-D case: the single-device forward and SGD step
    g2 = jg["g2d"]
    model = JDCRNNSeq(out_channels=8, K=2)
    x, y = jnp.asarray(arr["2d/x"]), jnp.asarray(arr["2d/y"])
    params = trees["tree_2d"]
    with jover(spmm_backend="segment"):
        out["2d_hs"] = np.asarray(jax.jit(
            lambda p: model.apply(p, x, g2))(params))
        value, grads = jax.jit(jax.value_and_grad(
            lambda p: jnp.mean((model.apply(p, x, g2) - y) ** 2)))(params)
    upd, _ = opt.update(grads, opt.init(params))
    out["2d_step"] = (float(value),
                      by_name(np_tree(optax.apply_updates(params, upd))))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results (one dict a rank) beside the JAX package's."""
    tmp = tmp_path_factory.mktemp("ranks")
    arr, graphs, jg, trees = make_inputs()
    np.savez(tmp / "inputs.npz", **arr)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(RANKS), str(tmp / "inputs.npz"), str(tmp),
         str(WORLD)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:     # the JAX side runs while the ranks do
        oracle = {"ex": jax_exchanges(arr, jg), "dcrnn": jax_dcrnn(
            arr, jg, trees), "dp": jax_dp(arr, jg, trees)}
        _, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stderr[-4000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(arr=arr, graphs=graphs, jg=jg, trees=trees, oracle=oracle,
                ranks=ranks)


def assembled(run, key, P):
    """The P parts' blocks in part order; on the dp=2 × graph=2 mesh both
    dp rows computed the same blocks."""
    ranks = run["ranks"]
    assert [int(ranks[r][f"{key.split('/')[0]}/part"]) for r in range(P)
            ] == list(range(P))
    if P == 2:
        for r in range(2):
            np.testing.assert_array_equal(ranks[r][key], ranks[r + 2][key])
    return np.concatenate([ranks[r][key] for r in range(P)])


def test_ranks_import_no_jax_and_join_the_group(run):
    for r, res in enumerate(run["ranks"]):
        assert list(res["modules"]) == [""], res["modules"]
        assert list(res["info"]) == [r, WORLD]


def test_make_mesh_shapes_and_errors(run):
    for res in run["ranks"]:
        assert list(res["mesh/shapes"]) == [
            "{'dp': 4}", "{'dp': 4}", "{'dp': 2, 'graph': 2}",
            "{'dp': 2, 'graph': 2}", "{'graph': 2}"]
        assert list(res["mesh/errors"]) == ["ValueError", "ValueError"]


def test_named_sharding_placements(run):
    for res in run["ranks"]:
        assert list(res["mesh/placements"]) == [
            "(Shard(dim=0), Shard(dim=2))", "(Replicate(), Replicate())",
            "(Shard(dim=0), Shard(dim=0))", "ValueError"]


def test_shard_batch_and_replicate(run):
    """Rank r sits at graph coordinate r % 2 of the 2 × 2 mesh: its block of
    arange(8) is that of JAX's PartitionSpec('graph'); replicate gives
    every rank the values of rank 0 (each drew its own first)."""
    ranks = run["ranks"]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["mesh/shard"],
                                      np.arange(8)[4 * (r % 2):][:4])
        assert str(res["mesh/shard_error"]) == "ValueError"
        np.testing.assert_array_equal(res["mesh/replicated"],
                                      ranks[0]["mesh/replicated"])
        np.testing.assert_array_equal(res["mesh/replicated_tree"],
                                      np.zeros(3))
    drawn = [DCRNN(2, 3, 2, device="cpu", generator=torch.Generator(
        ).manual_seed(r)).w_h.detach().numpy() for r in (0, 1)]
    np.testing.assert_array_equal(ranks[0]["mesh/replicated"], drawn[0])
    assert not np.array_equal(drawn[0], drawn[1])


@pytest.mark.parametrize("exchange,P", CASES)
def test_exchange_matches_jax(run, exchange, P):
    got = assembled(run, f"{exchange}{P}/out", P)
    want = run["oracle"]["ex"][f"{exchange}{P}"]["out"]
    n = run["arr"]["x"].shape[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:n], run["oracle"]["ex"]["segment"],
                               rtol=0, atol=1e-5)
    assert np.all(got[n:] == 0)     # padding rows stay zero


@pytest.mark.parametrize("exchange,P", CASES)
def test_exchange_gradient_matches_jax(run, exchange, P):
    got = assembled(run, f"{exchange}{P}/grad", P)
    n = run["arr"]["x"].shape[0]
    np.testing.assert_allclose(got, run["oracle"]["ex"][f"{exchange}{P}"]["grad"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:n], run["oracle"]["ex"]["segment_grad"],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("exchange,P", CASES)
def test_collective_bytes_equal_the_formula(run, exchange, P):
    """One forward aggregation sends ``ici_bytes_per_step(F)`` bytes from
    each rank, the JAX package's formula; forward and backward twice that."""
    formula = run["oracle"]["ex"][f"{exchange}{P}"]["formula"]
    for res in run["ranks"]:
        assert int(res[f"{exchange}{P}/formula"]) == formula > 0
        assert int(res[f"{exchange}{P}/bytes_fwd"]) == formula
        assert int(res[f"{exchange}{P}/bytes_all"]) == 2 * formula


PARTITION_FIELDS = ("senders", "receivers_local", "weights", "halo_send_idx",
                    "int_senders", "int_receivers", "int_weights")
PARTITION_META = ("num_parts", "nodes_per_part", "num_nodes",
                  "edges_per_part", "partitioned_by", "halo_size",
                  "interior_edges_per_part", "padded_nodes")


def same_partition(t, j):
    for name in PARTITION_META:
        assert getattr(t, name) == getattr(j, name), name
    for name in PARTITION_FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("by", ["receiver", "sender", "halo"])
@pytest.mark.parametrize("P", [2, 4])
def test_partition_arrays_equal_jax(by, P):
    spec = random_graph(np.random.default_rng(P), 43, 170)
    t = tpar.PartitionedGraph.from_graph(
        TGraph.from_edge_index(spec[0], spec[1], num_nodes=43, device="cpu"),
        P, by=by)
    same_partition(t, jpar.PartitionedGraph.from_graph(jgraph(spec), P,
                                                       by=by))


def ring_of_blocks(n=64, parts=8):
    blk, src, dst = n // parts, [], []
    for b in range(parts):
        lo = b * blk
        for i in range(blk):
            src.append(lo + i)
            dst.append(lo + (i + 1) % blk)
        src.append(lo + blk - 1)
        dst.append((lo + blk) % n)
    return np.stack([np.array(src), np.array(dst)]), blk


def test_halo_interior_boundary_split():
    """On the ring of blocks each part has one boundary edge and one remote
    row (halo_size 1), everything else interior — as in the JAX package."""
    ei, blk = ring_of_blocks()
    w = np.ones(ei.shape[1], np.float32)
    t = tpar.PartitionedGraph.from_graph(
        TGraph.from_edge_index(ei, w, num_nodes=64, device="cpu"), 8,
        by="halo")
    assert (t.halo_size, t.edges_per_part, t.interior_edges_per_part) == (
        1, 1, blk)
    assert int(t.int_senders.max()) < t.nodes_per_part
    same_partition(t, jpar.PartitionedGraph.from_graph(
        JGraph.from_edge_index(ei, w, num_nodes=64), 8, by="halo"))


def test_halo_locality_shrinks_the_exchange():
    """A banded graph's halo is a small part of a node block, so the halo
    exchange sends less than the all-gather; both formulas equal JAX's."""
    rng = np.random.default_rng(0)
    n, e, f, p = 1024, 8000, 16, 4
    s = rng.integers(0, n, size=e)
    r = np.clip(s + rng.integers(-30, 31, size=e), 0, n - 1)
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    tg = TGraph.from_edge_index(np.stack([s, r]), w, num_nodes=n,
                                device="cpu")
    jg = JGraph.from_edge_index(np.stack([s, r]), w, num_nodes=n)
    t_r = tpar.PartitionedGraph.from_graph(tg, p, by="receiver")
    t_h = tpar.PartitionedGraph.from_graph(tg, p, by="halo")
    for t, by in ((t_r, "receiver"), (t_h, "halo")):
        j = jpar.PartitionedGraph.from_graph(jg, p, by=by)
        assert t.ici_bytes_per_step(f) == j.ici_bytes_per_step(f)
        assert t.ici_bytes_per_step(f, 2) == j.ici_bytes_per_step(f, 2)
    assert 0 < t_h.halo_size < t_r.nodes_per_part / 2
    assert t_h.ici_bytes_per_step(f) < t_r.ici_bytes_per_step(f)


def test_exchange_validation(run):
    """Mismatched partitions, an unknown exchange or partition, a mesh axis
    of another size and a block of the wrong height all raise."""
    for res in run["ranks"]:
        assert list(res["validation"]) == ["ValueError"] * 7


def test_trailing_dims_flatten(run):
    for res in run["ranks"]:
        np.testing.assert_array_equal(
            res["trailing/out"].reshape(res["trailing/flat"].shape),
            res["trailing/flat"])
    got = np.concatenate([res["trailing/out"] for res in run["ranks"]])
    np.testing.assert_allclose(got, run["oracle"]["ex"]["trailing"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("P", [2, 4])
def test_partitioned_cell_matches_jax(run, P):
    """The flax tree of a single-device DCRNN loads into the partitioned
    cell; its output matches the single-device cell on the real rows (and
    at P=4 the JAX partitioned cell on every row: padded rows stay zero)."""
    got = np.concatenate([run["ranks"][r][f"cell{P}/out"] for r in range(P)])
    n = run["arr"]["cell/x"].shape[1]
    np.testing.assert_allclose(got[:n].transpose(1, 0, 2),
                               run["oracle"]["dcrnn"]["cell_single"], rtol=0,
                               atol=1e-4)
    assert np.all(got[n:] == 0)
    if P == 4:
        np.testing.assert_allclose(got, run["oracle"]["dcrnn"]["cell_part"],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("P", [2, 4])
def test_partitioned_seq_loss_and_gradients_match_jax(run, P):
    oracles = [run["oracle"]["dcrnn"]["seq_single"]]
    if P == 4:
        oracles.append(run["oracle"]["dcrnn"]["seq_part"])
    for r in range(P):
        res = run["ranks"][r]
        for value, grads in oracles:
            np.testing.assert_allclose(float(res[f"seq{P}/loss"][0]), float(value),
                                       rtol=1e-4)
            want = by_name(np_tree(grads))
            assert set(want) == {k.split("/", 2)[2] for k in res
                                 if k.startswith(f"seq{P}/grad/")}
            for name, g in want.items():
                np.testing.assert_allclose(res[f"seq{P}/grad/{name}"], g,
                                           rtol=1e-3, atol=1e-4,
                                           err_msg=name)


@pytest.mark.parametrize("case", ["mse", "masked"])
def test_dp_step_matches_jax(run, case):
    """Four ranks of two rows each against JAX's step on 8 devices: the
    global loss and the updated parameters.  With masked MAE over targets
    whose zeros fall unevenly on the shards the ranks' plain mean differs
    from the global loss; the step returns the global one."""
    value, params = run["oracle"]["dp"][case]
    for res in run["ranks"]:
        np.testing.assert_allclose(float(res[f"dp_{case}/loss"]), value,
                                   rtol=1e-5)
        for name, p in params.items():
            np.testing.assert_allclose(res[f"dp_{case}/param/{name}"], p,
                                       rtol=0, atol=1e-5, err_msg=name)
        assert int(res[f"dp_{case}/all_reduce_bytes"]) > 0
    naive = float(run["ranks"][0][f"dp_{case}/naive"][0])
    if case == "masked":
        assert abs(naive - value) > 1e-3 * abs(value)
    else:
        np.testing.assert_allclose(naive, value, rtol=1e-5)


def test_2d_mesh_forward_and_step_match_jax(run):
    """dp=2 × graph=2: batch halves over 'dp', node blocks over 'graph';
    the forward against the single-device DCRNNSeq, then one SGD step with
    gradients summed over both axes against the single-device step."""
    ranks = run["ranks"]
    T, n = run["arr"]["2d/x"].shape[1], run["arr"]["2d/x"].shape[2]
    grid = {tuple(res["2d/coords"]): res["2d/hs"] for res in ranks}
    # (T, npp, B/2, C) blocks -> (B, T, N, C)
    hs = np.concatenate([np.concatenate([grid[(d, q)] for q in (0, 1)],
                                        axis=1) for d in (0, 1)], axis=2)
    np.testing.assert_allclose(hs[:, :n].transpose(2, 0, 1, 3),
                               run["oracle"]["dp"]["2d_hs"], rtol=0,
                               atol=2e-4)
    value, params = run["oracle"]["dp"]["2d_step"]
    assert T == 3
    for res in ranks:
        np.testing.assert_allclose(float(res["2d/loss"]), value, rtol=2e-4)
        for name, p in params.items():
            np.testing.assert_allclose(res[f"2d/param/{name}"], p, rtol=0,
                                       atol=2e-4, err_msg=name)


def test_assert_same_across_hosts(run):
    for res in run["ranks"]:
        assert str(res["same/equal"]) == ""
        assert str(res["same/planted"]) == "AssertionError"


def test_initialize_single_host():
    """One process, no group: no initialization, rank 0 of 1."""
    info = tpar.initialize_multihost()
    assert info == {"rank": 0, "world_size": 1, "local_devices": 1,
                    "global_devices": 1}
    assert not torch.distributed.is_initialized()
    tpar.assert_same_across_hosts({"a": torch.ones(2)})  # a no-op


@pytest.mark.parametrize("name", ["partition_edges", "csr_from_coo"])
def test_native_matches_numpy_and_jax(monkeypatch, name):
    r = np.random.default_rng(3).integers(0, 64, size=1000).astype(np.int32)
    args = (r, 16, 4) if name == "partition_edges" else (r, 64)
    native = getattr(tnative, name)(*args)
    want = getattr(jnative, name)(*args)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    fallback = getattr(tnative, name)(*args)
    for a, b, c in zip(native, fallback, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    order = native[1]
    key = r // 16 if name == "partition_edges" else r
    assert np.all(np.diff(key[order]) >= 0)     # grouped, stable below
    assert sorted(order) == list(range(1000))


def test_dp_step_over_gloo_runs_eagerly_and_refuses_capture_true():
    """gloo's collectives go through the host, which a CUDA graph cannot
    capture: over a gloo group (here the group of one ``make_mesh`` makes
    on the CPU) ``capture=None`` runs the step eagerly, as False does, and
    ``capture=True`` raises naming the backend.  A group of one sends no
    byte."""
    from pytorch_geometric_temporal_tpu_torch.parallel import mesh as tmesh
    from pytorch_geometric_temporal_tpu_torch.train import TrainState, mse

    assert not torch.distributed.is_initialized()
    mesh = tpar.make_mesh({"dp": 1}, device="cpu")
    try:
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
        y = torch.from_numpy(rng.normal(size=(4, 1)).astype(np.float32))
        for capture in (None, False):
            model = torch.nn.Linear(3, 1)
            state = TrainState.create(
                model, lambda ps: torch.optim.Adam(ps, 1e-2))
            step = tpar.make_dp_train_step(
                lambda m, xb, yb: mse(m(xb), yb), mesh, capture=capture)
            tpar.reset_collective_bytes()
            for _ in range(2):
                state, loss = step(state, x, y)
            assert torch.isfinite(loss) and int(state.step) == 2
            assert (step.graphs.captures, step.graphs.replays) == (0, 0)
            assert tpar.collective_bytes["all_reduce"] == 0
        with pytest.raises(ValueError, match=r"NCCL.*'dp' over gloo"):
            tpar.make_dp_train_step(lambda m, xb, yb: mse(m(xb), yb), mesh,
                                    capture=True)
    finally:
        tmesh.release_group_of_one()
    assert not torch.distributed.is_initialized()
