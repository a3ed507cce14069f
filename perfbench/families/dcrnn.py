"""DCRNN (Li et al., ICLR 2018): the port's ``DCRNNSeq``, each hidden state
through a ``Dense`` readout when the configuration has an ``output_dim``,
and masked MAE over the first ``output_dim`` features of the target; the
random-walk operators P_fwd and P_bwd its diffusion hops run on."""

from __future__ import annotations

import torch

from perfbench import costs, manifest
from perfbench.families import Model

REFERENCE = manifest.load_reference(__file__)
# the program's parameter names (by suffix) -> the reference's
PARAM_NAMES = {"cell.w_zr": "w_zr", "cell.b_zr": "b_zr", "cell.w_h": "w_h",
               "cell.b_h": "b_h", "readout.kernel": "w_out",
               "readout.bias": "b_out"}


class _Forecaster(torch.nn.Module):
    """``DCRNNSeq``'s hidden states, each through a ``Dense`` readout when
    the configuration has one."""

    def __init__(self, seq, readout):
        super().__init__()
        self.seq, self.readout = seq, readout

    def forward(self, x, graph):
        h = self.seq(x, graph)
        return h if self.readout is None else self.readout(h)


def build(config: dict, inputs, graph, device, generator) -> Model:
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.models._cells import Dense
    from pytorch_geometric_temporal_tpu_torch.train import (
        ZScoreScaler, masked_mae_loss)

    m = config["model"]
    seq = DCRNNSeq(int(m["input_dim"]), int(m["rnn_units"]),
                   int(m["basis_terms"]), device=device, generator=generator)
    out = m.get("output_dim")
    readout = (Dense(int(m["rnn_units"]), int(out), device=device,
                     generator=generator) if out else None)
    model = _Forecaster(seq, readout)

    def loss(scaler):
        if not (out and int(out) < inputs.series.shape[-1]):
            return None
        # the loss is over the first ``out`` features (speed), as the
        # configuration's published output_dim has it
        part = ZScoreScaler(mean=scaler.mean[:int(out)],
                            std=scaler.std[:int(out)])

        def loss_fn(pred, target):
            return masked_mae_loss(part.inverse(pred),
                                   part.inverse(target[..., :int(out)]))
        return loss_fn

    names = {}
    for name, _ in model.named_parameters():
        hit = [v for k, v in PARAM_NAMES.items() if name.endswith(k)]
        if len(hit) != 1:
            raise RuntimeError(f"parameter {name!r} has no reference name")
        names[name] = hit[0]
    return Model(model, lambda xb: model(xb, graph), loss, names)


def work(config: dict, batch: int, train: bool):
    return costs.dcrnn_work(config["model"], int(config["recipe"]["seq_len"]),
                            batch, int(config["data"]["num_nodes"]), train)


def operators(inputs) -> dict:
    s = costs.operator_stats(inputs.senders, inputs.receivers,
                             inputs.num_nodes)
    n = s["num_nodes"]
    return {d: {"nnz": s["nnz"], "shape": (n, n), "x_rows": s[d]}
            for d in ("fwd", "bwd")}


def tiny(config: dict) -> None:
    """A narrow hidden state, for the CPU only."""
    config["model"]["rnn_units"] = min(config["model"]["rnn_units"], 8)
