"""The yardstick's arithmetic: the card's peaks, the least time of one
aggregation (``need_bound``), and the operations a DCRNN step needs (its
family, ``families/dcrnn.py``, hands them on), all counted from shapes and
from the cell's graph, never from what the program stored or launched.

Peaks: NVIDIA's data sheet for the H100 SXM part, dense rates, at the full
700 W limit.  The configurations state f32 with TF32 off, so their
operations run outside the tensor cores at 67 TFLOP/s.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def operator_stats(senders, receivers, num_nodes: int) -> dict:
    """Nonzeros of the two random-walk operators and the rows each
    references, from the edge list (duplicate edges are one nonzero).

    P_fwd[i, j] = W[i, j] / deg_out(i) has the nonzeros (s, r) of the
    edges; P_bwd = D_in^-1 Wᵀ has (r, s).  A product P @ x reads the x
    rows of P's distinct columns; its gradient Pᵀ @ g reads those of P's
    distinct rows."""
    key = np.unique(np.asarray(senders, np.int64) * num_nodes
                    + np.asarray(receivers, np.int64))
    rows, cols = key // num_nodes, key % num_nodes
    nnz = int(key.size)
    u_rows, u_cols = int(np.unique(rows).size), int(np.unique(cols).size)
    return {"nnz": nnz, "num_nodes": int(num_nodes),
            # (x rows read forward, x rows read by the gradient)
            "fwd": (u_cols, u_rows), "bwd": (u_rows, u_cols)}


def need_bound_s(nnz: int, x_rows: int, num_rows: int, width: int,
                 dtype: str = "float32") -> float:
    """Least seconds of ``out = A @ x`` on the card from what the product
    needs: each nonzero once (its value and a 4-byte column), the row
    pointers, the x rows some nonzero references, the output written once;
    2 operations a nonzero and feature at the type's peak."""
    b = DTYPE_BYTES[dtype]
    n_bytes = (nnz * (b + 4) + (num_rows + 1) * 4 + x_rows * width * b
               + num_rows * width * b)
    ops = 2 * nnz * width
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def dcrnn_work(model: dict, seq_len: int, batch: int, num_nodes: int,
               train: bool):
    """(GEMM operations, hops) of one DCRNN step over ``seq_len`` inputs of
    ``batch`` windows: the gate and candidate products over the stacked
    bidirectional basis, the readout, and the aggregations, each product
    counted whole as its shapes state; forward, and for a train step the
    backward products that a gradient flows through.  A hop is (direction,
    is the gradient's, width): one product with P_fwd or P_bwd (or its
    transpose) at ``width`` = batch × (input + hidden) features.

    At t = 0 the state is zero, so nothing upstream of either basis takes
    a gradient (the data; the zero state; r, through r·h = 0): the weights'
    gradients only, no input-gradient product and no backward hop.  From
    t = 1 on the state depends on the parameters, and both bases pass a
    gradient back."""
    f, c = int(model["input_dim"]), int(model["rnn_units"])
    k = int(model["basis_terms"])
    out = model.get("output_dim")
    rows = batch * num_nodes
    width = 2 * k * (f + c)
    gate, cand = 2 * rows * width * (2 * c), 2 * rows * width * c
    flops, hops = 0, []
    hop_w = batch * (f + c)
    for t in range(seq_len):
        flops += gate + cand
        for d in ("fwd", "bwd"):
            hops += [(d, False, hop_w)] * (2 * (k - 1))
        if out:
            flops += 2 * rows * c * out
        if not train:
            continue
        if out:
            # the readout's weight and input gradients
            flops += 2 * (2 * rows * c * out)
        if t == 0:
            flops += gate + cand
            continue
        # the weights' gradients, then the bases' inputs' gradients
        flops += 2 * (gate + cand)
        for d in ("fwd", "bwd"):
            hops += [(d, True, hop_w)] * (2 * (k - 1))
    return flops, hops


def hops_bound_s(operators: dict, hops) -> float:
    """Σ ``need_bound_s`` of the ``hops`` [(operator name, is the
    gradient's, width)] on the ``operators`` {name: {"nnz", "shape",
    "x_rows"}}.  A gradient's product is with the transpose: it writes one
    row for each of the operator's columns and reads the x rows that
    ``x_rows`` counts second."""
    total = 0.0
    for name, grad, width in hops:
        op = operators[name]
        total += need_bound_s(op["nnz"], op["x_rows"][1 if grad else 0],
                              op["shape"][1 if grad else 0], width)
    return total


def hops_flops(operators: dict, hops) -> int:
    return sum(2 * operators[name]["nnz"] * width for name, _, width in hops)
