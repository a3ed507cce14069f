"""ASTGCN (Guo et al., AAAI 2019) in edge mode: the port's ``ASTGCN`` with
``attention_mode="edge"`` over the loader's (B, T, N, F) batches, laid out
(B, N, F, T) for the model, its (B, N, P) forecast returned as
(B, P, N, 1); masked MAE over the first ``output_dim`` features of the
target; the reversed scaled Laplacian L̂ its hops past the first run on.

The yardstick's arithmetic for the family lives here beside the model, as
``costs.py``'s does for DCRNN, counted from shapes and the cell's graph."""

from __future__ import annotations

import numpy as np

from perfbench import costs, manifest
from perfbench.families import Model

REFERENCE = manifest.load_reference(__file__)
# the program's parameter names (by suffix) -> the reference's, per block
BLOCK_NAMES = {
    "temporal_attention.U1": "U1", "temporal_attention.U2": "U2",
    "temporal_attention.U3": "U3", "temporal_attention.be": "be",
    "temporal_attention.Ve": "Ve", "spatial_attention.W1": "W1",
    "spatial_attention.W2": "W2", "spatial_attention.W3": "W3",
    "spatial_attention.bs": "bs", "chebconv_attention.weight": "theta",
    "chebconv_attention.bias": "theta_b", "time_convolution.kernel": "time_w",
    "time_convolution.bias": "time_b", "residual_convolution.kernel": "res_w",
    "residual_convolution.bias": "res_b", "layer_norm.scale": "ln_g",
    "layer_norm.bias": "ln_b"}
HEAD_NAMES = {"final_conv_w": "head_w", "final_conv_b": "head_b"}


def reference_name(name: str) -> str:
    """``block_<i>.<part>.<leaf>`` -> ``b<i>.<short>``; the head's own."""
    if name in HEAD_NAMES:
        return HEAD_NAMES[name]
    block, rest = name.split(".", 1)
    if not block.startswith("block_") or rest not in BLOCK_NAMES:
        raise RuntimeError(f"parameter {name!r} has no reference name")
    return f"b{block[len('block_'):]}.{BLOCK_NAMES[rest]}"


def build(config: dict, inputs, graph, device, generator) -> Model:
    from pytorch_geometric_temporal_tpu_torch.models import ASTGCN
    from pytorch_geometric_temporal_tpu_torch.train import (
        ZScoreScaler, masked_mae_loss)

    m = config["model"]
    model = ASTGCN(
        nb_block=int(m["nb_block"]), in_channels=int(m["in_channels"]),
        K=int(m["K"]), nb_chev_filter=int(m["nb_chev_filter"]),
        nb_time_filter=int(m["nb_time_filter"]),
        time_strides=int(m["time_strides"]),
        num_for_predict=int(m["num_for_predict"]),
        len_input=int(m["len_input"]), num_of_vertices=inputs.num_nodes,
        normalization=m["normalization"],
        attention_mode=m["attention_mode"], device=device,
        generator=generator,
        temporal_vector_init=m["temporal_vector_init"])
    out = int(m["output_dim"])

    def forward(xb):
        # (B, T, N, F) -> (B, N, F, T) -> (B, N, P) -> (B, P, N, 1)
        return model(xb.permute(0, 2, 3, 1), graph).transpose(1, 2)[..., None]

    def loss(scaler):
        # over the first ``out`` features (speed), as the configuration's
        # output_dim has it
        part = ZScoreScaler(mean=scaler.mean[:out], std=scaler.std[:out])

        def loss_fn(pred, target):
            return masked_mae_loss(part.inverse(pred),
                                   part.inverse(target[..., :out]))
        return loss_fn

    names = {name: reference_name(name) for name, _ in
             model.named_parameters()}
    return Model(model, forward, loss, names)


def lhat_stats(senders, receivers, num_nodes: int) -> dict:
    """L̂ (sym, λ_max = 2) as an operator: its nonzeros at the distinct
    (s, r), s ≠ r, of the edges (self-loops are removed before the
    Laplacian, and its diagonal, 1 − 1, is 0), (N, N), and the x rows a
    product reads: L̂ @ x those at its columns, the gradient's L̂ᵀ @ g
    those at its rows (``costs.operator_stats``' P_fwd counts)."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    keep = s != r
    st = costs.operator_stats(s[keep], r[keep], num_nodes)
    n = int(num_nodes)
    return {"nnz": st["nnz"], "shape": (n, n), "x_rows": st["fwd"]}


def astgcn_work(model: dict, seq_len: int, batch: int, num_nodes: int,
                num_edges: int, train: bool):
    """(GEMM operations, hops) of one edge-mode ASTGCN step over
    ``seq_len`` inputs of ``batch`` windows on a graph of ``num_edges``
    listed edges, each product counted whole as its shapes state: per
    block the temporal attention's products (X·U_1, ·U_2, U_3·X, lhs·rhs,
    V_e·σ, X·E), the spatial attention's (X̃·W_1, ·W_2, W_3·X̃, a T-long
    dot at each edge and at the diagonal), the K Chebyshev GEMMs, hop 1's
    2·F operations at each of L̂'s E + 2N listed entries a window and
    step, the time and residual convolutions; the head.  A hop is
    (``"lhat_rev"``, is the gradient's, width): each Chebyshev term past
    T_1 is one product with L̂ over the whole (B, T, N, F) tensor, width
    B·T·F.

    For a train step each product's backward adds its operations once for
    each operand that takes a gradient: every operand derived from the
    parameters does; the first block's input, the data, does not."""
    t, b, n = int(seq_len), int(batch), int(num_nodes)
    e = int(num_edges)
    k = int(model["K"])
    c, ct = int(model["nb_chev_filter"]), int(model["nb_time_filter"])
    f = int(model["in_channels"])
    flops, hops = 0, []

    def product(ops, with_grad):
        # forward, and a train step's product for each of ``with_grad``
        # operands that take a gradient
        return ops * (1 + with_grad) if train else ops

    for i in range(int(model["nb_block"])):
        x_grad = int(i > 0)             # the block's input takes a gradient
        flops += product(2 * b * n * f * t, 1 + x_grad)       # X·U_1
        flops += product(2 * b * t * f * n, 2)                # ·U_2
        flops += product(2 * b * n * f * t, 1 + x_grad)       # U_3·X
        flops += product(2 * b * t * n * t, 2)                # lhs·rhs
        flops += product(2 * b * t * t * t, 2)                # V_e·σ
        flops += product(2 * b * n * f * t * t, 1 + x_grad)   # X·E
        flops += product(3 * 2 * b * n * f * t, 2)   # X̃·W_1, ·W_2, W_3·X̃
        flops += product(2 * b * (e + n) * t, 2)              # the scores
        flops += product(k * 2 * b * t * n * f * c, 2)        # T_k·Θ_k
        if k > 1:
            flops += product(2 * b * t * (e + 2 * n) * f, 2)  # hop 1
        hops += [("lhat_rev", False, b * t * f)] * (k - 2)
        if train:
            hops += [("lhat_rev", True, b * t * f)] * (k - 2)
        flops += product(2 * b * n * t * 3 * c * ct, 2)       # time conv
        flops += product(2 * b * n * t * f * ct, 1 + x_grad)  # residual
        f = ct
    p = int(model["num_for_predict"])
    flops += product(2 * b * n * p * t * f, 2)                # the head
    return flops, hops


def work(config: dict, batch: int, train: bool):
    data = config["data"]
    n = int(data["num_nodes"])
    # the stand-in draws ``degree`` edges a sensor, whatever the seed
    return astgcn_work(config["model"], int(config["recipe"]["seq_len"]),
                       batch, n, n * int(data["degree"]), train)


def operators(inputs) -> dict:
    return {"lhat_rev": lhat_stats(inputs.senders, inputs.receivers,
                                   inputs.num_nodes)}


def tiny(config: dict) -> None:
    """Narrow filters, for the CPU only."""
    m = config["model"]
    m["nb_chev_filter"] = min(m["nb_chev_filter"], 8)
    m["nb_time_filter"] = min(m["nb_time_filter"], 8)
