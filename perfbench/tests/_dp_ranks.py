"""Ranks of the data-parallel reference test: each joins a gloo group
through a ``file://`` store, takes its block of the global batch and runs
the port's ``make_dp_train_step`` once; rank 0 writes the loss and the
parameters after the step."""

import numpy as np
import torch
import torch.distributed as dist


def model_of(config):
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq

    m = config["model"]
    return DCRNNSeq(int(m["input_dim"]), int(m["rnn_units"]),
                    int(m["basis_terms"]), device="cpu",
                    generator=torch.Generator().manual_seed(0))


def rank_main(rank, world, store, inputs_path, out_path, config):
    from pytorch_geometric_temporal_tpu_torch import parallel as par
    from pytorch_geometric_temporal_tpu_torch.ops import Graph
    from pytorch_geometric_temporal_tpu_torch.train import (
        TrainState, ZScoreScaler, masked_mae_loss)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        inp = np.load(inputs_path)
        graph = Graph.from_edge_index(inp["ei"], inp["w"],
                                      num_nodes=int(inp["n"]), device="cpu")
        scaler = ZScoreScaler(mean=torch.from_numpy(inp["means"]),
                              std=torch.from_numpy(inp["stds"]))
        x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
        per = x.shape[0] // world
        xb, yb = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
        model = model_of(config)
        state = TrainState.create(
            model, lambda ps: torch.optim.Adam(ps, float(config["recipe"]["lr"])))
        mesh = par.make_mesh({"dp": world}, device="cpu")

        def loss_of(m, xb, yb):
            return masked_mae_loss(scaler.inverse(m(xb, graph)),
                                   scaler.inverse(yb))

        step = par.make_dp_train_step(
            loss_of, mesh, weight_fn=lambda xb, yb: (scaler.inverse(yb) != 0).sum())
        state, loss = step(state, xb, yb)
        if rank == 0:
            np.savez(out_path, loss=float(loss), **{
                n: p.detach().numpy() for n, p in model.named_parameters()})
    finally:
        dist.destroy_process_group()
