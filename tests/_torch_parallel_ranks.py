"""Ranks of the port's parallel tests, spawned over gloo.

    python tests/_torch_parallel_ranks.py INPUTS.npz OUT_DIR WORLD [DEVICE]

Spawns WORLD processes (``torch.multiprocessing``, spawn), joined through a
``file://`` store in OUT_DIR.  Each rank reads the seeded inputs and flax
parameter trees from INPUTS.npz, runs every case of
``tests/test_torch_parallel.py`` (CPU, WORLD=4) or the card twins of
``tests/test_torch_cuda.py`` (DEVICE=cuda, WORLD=2), and writes its arrays
to OUT_DIR/rank<r>.npz; the test compares them with the JAX package (or, on
the card, with the port's single-process results).  A rank imports torch,
numpy and the port only; it records the modules it ended with.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from pytorch_geometric_temporal_tpu_torch import parallel as par
from pytorch_geometric_temporal_tpu_torch.models import DCRNN, DCRNNSeq
from pytorch_geometric_temporal_tpu_torch.ops import Graph
from pytorch_geometric_temporal_tpu_torch.train import (
    TrainState, apply_gradients, masked_mae_loss, mse)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "pytorch_geometric_temporal_tpu")
# (exchange, partitioned_by) of spmm_partitioned
EXCHANGES = (("gather", "receiver"), ("scatter", "sender"), ("halo", "halo"))


def flax_tree(inp, prefix):
    """The nested ``{"params": ...}`` tree stored flat under ``prefix/``."""
    tree = {}
    for key in inp.files:
        if key.startswith(prefix + "/"):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = inp[key]
    return tree


def graph_of(inp, name, device):
    return Graph.from_edge_index(inp[f"{name}/ei"], inp[f"{name}/w"],
                                 num_nodes=int(inp[f"{name}/n"]),
                                 device=device)


def raises(fn):
    """The name of the exception ``fn`` raises, or '' when it returns."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads which class
        return type(e).__name__
    return ""


def grads_summed(model, group):
    """The parameter gradients summed over ``group``, by name."""
    flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    par.collectives.all_reduce_(flat, [group])
    out, off = {}, 0
    for name, p in model.named_parameters():
        out[name] = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return out


def exchange_cases(inp, res, meshes, device):
    g = graph_of(inp, "g", device)
    x = inp["x"]
    for P, mesh in meshes.items():
        p = mesh.get_local_rank("graph")
        for exchange, by in EXCHANGES:
            pg = par.PartitionedGraph.from_graph(g, P, by=by)
            xs = pg.shard_features(x, mesh).requires_grad_()
            par.reset_collective_bytes()
            out = par.spmm_partitioned(pg, xs, mesh, exchange=exchange)
            fwd = sum(par.collective_bytes.values())
            (out ** 2).sum().backward()
            key = f"{exchange}{P}"
            res[f"{key}/out"] = out.detach().numpy().copy()
            res[f"{key}/grad"] = xs.grad.numpy()
            res[f"{key}/bytes_fwd"] = np.int64(fwd)
            res[f"{key}/bytes_all"] = np.int64(sum(
                par.collective_bytes.values()))
            res[f"{key}/formula"] = np.int64(pg.ici_bytes_per_step(
                x.shape[1]))
            res[f"{key}/part"] = np.int64(p)
    # exchange validation on the 4-part mesh
    mesh = meshes[4]
    pg_r = par.PartitionedGraph.from_graph(g, 4, by="receiver")
    pg_s = par.PartitionedGraph.from_graph(g, 4, by="sender")
    xs = pg_r.shard_features(x, mesh)
    res["validation"] = np.array([
        raises(lambda: par.spmm_partitioned(pg_r, xs, mesh,
                                            exchange="scatter")),
        raises(lambda: par.spmm_partitioned(pg_s, xs, mesh,
                                            exchange="gather")),
        raises(lambda: par.spmm_partitioned(pg_r, xs, mesh,
                                            exchange="halo")),
        raises(lambda: par.spmm_partitioned(pg_r, xs, mesh,
                                            exchange="bogus")),
        raises(lambda: par.PartitionedGraph.from_graph(g, 4, by="bogus")),
        raises(lambda: par.spmm_partitioned(pg_r, xs, meshes[2])),
        raises(lambda: par.spmm_partitioned(pg_r, xs[:-1], mesh)),
    ])
    # trailing dims flatten: (npp, 3, 4) against (npp, 12)
    pops_g = graph_of(inp, "gd", device)
    pops = par.PartitionedDiffusionOperators.from_graph(pops_g, 4)
    x3 = pops.shard_features(inp["x3"], mesh)
    out3 = par.spmm_partitioned(pops.p_fwd, x3, mesh, exchange="halo")
    flat = par.spmm_partitioned(pops.p_fwd, x3.reshape(x3.shape[0], -1),
                                mesh, exchange="halo")
    res["trailing/out"] = out3.numpy()
    res["trailing/flat"] = flat.numpy()


def dcrnn_cases(inp, res, meshes, device):
    g = graph_of(inp, "gd", device)
    for P, mesh in meshes.items():
        group = mesh.get_group("graph")
        pops = par.PartitionedDiffusionOperators.from_graph(g, P)
        # the cell, node-leading (n, B, F)
        cell = par.DCRNNPartitioned(2, 5, 3, device=device)
        cell.params_from_flax(flax_tree(inp, "tree_cell"))
        xp = pops.shard_features(inp["cell/x"].transpose(1, 0, 2), mesh)
        hp = pops.shard_features(inp["cell/h"].transpose(1, 0, 2), mesh)
        res[f"cell{P}/out"] = cell(xp, pops, mesh, hp).detach().numpy().copy()
        # the sequence: (B, T, n, F) -> (T, n, B, F), loss and gradients
        x, y = inp["seq/x"], inp["seq/y"]
        n = x.shape[2]
        seq = par.DCRNNPartitionedSeq(2, 4, 2, device=device)
        seq.params_from_flax(flax_tree(inp, "tree_seq"))
        xt = pops.p_fwd.shard_features(x.transpose(1, 2, 0, 3), mesh,
                                       node_axis=1)
        yt = pops.p_fwd.shard_features(y.transpose(1, 2, 0, 3), mesh,
                                       node_axis=1)
        real = max(0, min(n - mesh.get_local_rank("graph")
                          * pops.p_fwd.nodes_per_part,
                          pops.p_fwd.nodes_per_part))
        hs = seq(xt, pops, mesh)
        local = ((hs[:, :real] - yt[:, :real]) ** 2).sum() / y.size
        local.backward()
        loss = local.detach().reshape(1).clone()
        par.collectives.all_reduce_(loss, [group])
        res[f"seq{P}/hs"] = hs.detach().numpy().copy()
        res[f"seq{P}/loss"] = loss.numpy()
        for name, grad in grads_summed(seq, group).items():
            res[f"seq{P}/grad/{name}"] = grad.numpy()


def dp_cases(inp, res, rank, device):
    g = graph_of(inp, "gdp", device)
    mesh = par.make_mesh({"dp": 4}, device=device)
    x, y = inp["dp/x"], inp["dp/y"]
    for case, y_all in (("mse", y), ("masked", inp["dp/y_masked"])):
        model = DCRNNSeq(3, 8, 2, device=device)
        model.params_from_flax(flax_tree(inp, "tree_dp"))
        par.replicate(model, mesh)
        state = TrainState.create(model,
                                  lambda ps: torch.optim.SGD(ps, lr=0.1))
        if case == "mse":
            def loss_fn(m, xb, yb):
                return mse(m(xb, g), yb)
            weight_fn = None
        else:
            def loss_fn(m, xb, yb):
                return masked_mae_loss(m(xb, g), yb)

            def weight_fn(xb, yb):
                return (yb != 0).sum()
        xb, yb = par.shard_batch((x, y_all), mesh)
        with torch.no_grad():   # each rank's own mean, averaged: not JAX's
            naive = loss_fn(model, xb, yb).reshape(1).clone()
        par.collectives.all_reduce_(naive, [mesh.get_group("dp")])
        step = par.make_dp_train_step(loss_fn, mesh, weight_fn=weight_fn)
        par.reset_collective_bytes()
        state, loss = step(state, xb, yb)
        res[f"dp_{case}/loss"] = loss.numpy()
        res[f"dp_{case}/naive"] = (naive / 4).numpy()
        res[f"dp_{case}/all_reduce_bytes"] = np.int64(
            par.collective_bytes["all_reduce"])
        for name, p in model.named_parameters():
            res[f"dp_{case}/param/{name}"] = p.detach().numpy().copy()
    # the check on replicated values: equal, then one rank differs
    res["same/equal"] = np.array(raises(
        lambda: par.assert_same_across_hosts(model)))
    if rank == 1:
        with torch.no_grad():
            model.cell.w_h[0, 0] += 1.0
    res["same/planted"] = np.array(raises(
        lambda: par.assert_same_across_hosts(model)))


def mesh_cases(inp, res, rank, device):
    shapes = []
    for axes in ({"dp": 4}, {"dp": -1}, {"dp": 2, "graph": 2},
                 {"dp": -1, "graph": 2}, {"graph": 2}):
        mesh = par.make_mesh(axes, device=device)
        shapes.append(f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    res["mesh/shapes"] = np.array(shapes)
    res["mesh/errors"] = np.array([
        raises(lambda: par.make_mesh({"dp": 8}, device=device)),
        raises(lambda: par.make_mesh({"a": -1, "b": -1}, device=device)),
    ])
    mesh = par.make_mesh({"dp": 2, "graph": 2}, device=device)
    res["mesh/placements"] = np.array([
        str(par.named_sharding(mesh, "dp", None, "graph")),
        str(par.named_sharding(mesh)),
        str(par.named_sharding(mesh, ("dp", "graph"))),
        raises(lambda: par.named_sharding(mesh, "bogus"))])
    res["mesh/shard"] = par.shard_batch(np.arange(8), mesh, "graph").numpy()
    res["mesh/shard_error"] = np.array(raises(
        lambda: par.shard_batch(np.arange(5), mesh, "graph")))
    model = DCRNN(2, 3, 2, device=device,
                  generator=torch.Generator().manual_seed(rank))
    par.replicate(model, mesh)
    res["mesh/replicated"] = model.w_h.detach().numpy().copy()
    res["mesh/replicated_tree"] = par.replicate(
        {"a": [np.full(3, float(rank))]}, mesh)["a"][0].numpy()


def mesh2d_cases(inp, res, device):
    """Batch over 'dp' and nodes over 'graph': the forward, then one step
    whose gradients are summed over both axes."""
    mesh = par.make_mesh({"dp": 2, "graph": 2}, device=device)
    g = graph_of(inp, "g2d", device)
    pops = par.PartitionedDiffusionOperators.from_graph(g, 2)
    x, y = inp["2d/x"], inp["2d/y"]
    n, npp = x.shape[2], pops.p_fwd.nodes_per_part
    real = max(0, min(n - mesh.get_local_rank("graph") * npp, npp))

    def local_block(a):     # (B, T, N, C) -> (T, npp, B/2, C)
        b = par.shard_batch(a, mesh, "dp").permute(1, 2, 0, 3)
        return pops.p_fwd.shard_features(b, mesh, node_axis=1)

    xb, yb = local_block(x), local_block(y)
    model = par.DCRNNPartitionedSeq(3, 8, 2, device=device)
    model.params_from_flax(flax_tree(inp, "tree_2d"))
    res["2d/hs"] = model(xb, pops, mesh).detach().numpy().copy()
    res["2d/coords"] = np.array([mesh.get_local_rank("dp"),
                                 mesh.get_local_rank("graph")])

    def loss_fn(m, xl, yl):
        return mse(m(xl, pops, mesh)[:, :real], yl[:, :real])

    state = TrainState.create(model, lambda ps: torch.optim.SGD(ps, lr=0.1))
    step = par.make_dp_train_step(
        loss_fn, mesh, axis_name=("dp", "graph"),
        weight_fn=lambda xl, yl: yl[:, :real].numel())
    state, loss = step(state, xb, yb)
    res["2d/loss"] = loss.numpy()
    for name, p in model.named_parameters():
        res[f"2d/param/{name}"] = p.detach().numpy().copy()


def cuda_twin_cases(inp, res, rank, device):
    """On the card: a two-rank DP step against the single-process step on
    the whole batch, and a halo aggregation against the segment path."""
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr, spmm_segment

    g = graph_of(inp, "gdp", device)
    mesh = par.make_mesh({"dp": -1}, device=device)
    x, y = inp["dp/x"], inp["dp/y_masked"]
    model = DCRNNSeq(2, 2, 2, device=device)
    model.params_from_flax(flax_tree(inp, "tree_dp"))
    ref = DCRNNSeq(2, 2, 2, device=device)
    ref.load_state_dict(model.state_dict())
    ref_state = TrainState.create(ref, lambda ps: torch.optim.Adam(ps, 1e-3))
    xa, ya = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    loss_ref = masked_mae_loss(ref(xa, g), ya)
    grads = torch.autograd.grad(loss_ref, list(ref.parameters()))
    apply_gradients(ref_state, grads)
    state = TrainState.create(model, lambda ps: torch.optim.Adam(ps, 1e-3))
    seen = []   # what the optimizer is given: the all-reduced gradient
    state.opt_state.register_step_pre_hook(
        lambda opt, args, kwargs: seen.extend(
            p.grad.clone() for p in model.parameters()))
    step = par.make_dp_train_step(
        lambda m, xb, yb: masked_mae_loss(m(xb, g), yb), mesh,
        weight_fn=lambda xb, yb: (yb != 0).sum())
    xb, yb = par.shard_batch((x, y), mesh)
    bcsr.reset_launch_counts()
    state, loss = step(state, xb, yb)
    res["dp/launches"] = np.int64(bcsr.hybrid_spmm.launches)
    res["dp/captures"] = np.int64(step.graphs.captures)    # gloo: eager
    res["dp/loss"] = loss.cpu().numpy()
    res["dp/loss_ref"] = loss_ref.detach().cpu().numpy()
    for (name, p), q, gr, gq in zip(model.named_parameters(),
                                    ref.parameters(), seen, grads):
        res[f"dp/param/{name}"] = p.detach().cpu().numpy()
        res[f"dp/ref/{name}"] = q.detach().cpu().numpy()
        res[f"dp/grad/{name}"] = gr.cpu().numpy()
        res[f"dp/ref_grad/{name}"] = gq.cpu().numpy()
    # the halo aggregation at P = 2
    gh = graph_of(inp, "gd", device)
    pg = par.PartitionedGraph.from_graph(gh, 2, by="halo")
    xh = torch.from_numpy(inp["x3"].reshape(inp["x3"].shape[0], -1))
    xs = pg.shard_features(xh, mesh, "dp")
    par.reset_collective_bytes()
    out = par.spmm_partitioned(pg, xs, mesh, "dp", "halo")
    want = spmm_segment(gh, xh.to(device))
    lo = mesh.get_local_rank("dp") * pg.nodes_per_part
    want = want[lo:lo + pg.nodes_per_part]      # the last block is short
    res["halo/out"] = out[:want.shape[0]].cpu().numpy()
    res["halo/want"] = want.cpu().numpy()
    res["halo/bytes"] = np.int64(par.collective_bytes["all_to_all"])
    res["halo/formula"] = np.int64(pg.ici_bytes_per_step(xh.shape[1]))


def rank_main(rank, world, inputs, out_dir, device):
    torch.set_num_threads(1)
    par.make_mesh({"graph": 1}, device=device)  # a group of one, replaced
    info = par.initialize_multihost(
        f"file://{os.path.join(out_dir, 'store')}", world, rank,
        backend="gloo", device=device)
    inp = np.load(inputs)
    res = {"info": np.array([info["rank"], info["world_size"]])}
    if device == "cuda":
        cuda_twin_cases(inp, res, rank, device)
    else:
        meshes = {2: par.make_mesh({"dp": 2, "graph": 2}, device=device),
                  4: par.make_mesh({"graph": 4}, device=device)}
        mesh_cases(inp, res, rank, device)
        exchange_cases(inp, res, meshes, device)
        dcrnn_cases(inp, res, meshes, device)
        dp_cases(inp, res, rank, device)
        mesh2d_cases(inp, res, device)
    res["modules"] = np.array(sorted(
        m for m in sys.modules
        if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)) or [""])
    dist.barrier()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


if __name__ == "__main__":
    inputs, out_dir, world = sys.argv[1], sys.argv[2], int(sys.argv[3])
    device = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    torch.multiprocessing.start_processes(
        rank_main, args=(world, inputs, out_dir, device), nprocs=world,
        start_method="spawn")
