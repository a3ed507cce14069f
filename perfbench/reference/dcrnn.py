"""Plain PyTorch DCRNN training, the reference that decides ``correct``.

Follows the DCRNN paper (Li et al., ICLR 2018, arXiv 1707.01926) as the
index-batching recipe trains it: random-walk operators rebuilt from the
edge list, the stacked bidirectional diffusion basis, the GRU gates, an
optional linear readout, masked MAE on de-normalized values, and Adam
(PyTorch's defaults).  It imports torch and numpy only: nothing of the
program, nothing it made.  Sums run in f32 with TF32 off, in blocks of the
batch, so that the largest configuration fits beside nothing else.

``precision="tf32"`` rounds every dense product's operands to TF32 (10
mantissa bits, to nearest even) before an f32 product: the control, the
step below the configurations' f32.

Departures from the paper, shared with the program and stated in each
configuration: one recurrent layer over the input sequence (no
encoder-decoder), the basis layout [T_0..T_{K-1} forward | T_0..T_{K-1}
backward] with T_0 = X in both halves, T_k = 2·P·T_{k-1} − T_{k-2}.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) with its mantissa rounded to TF32's 10 bits, to
    nearest even: what a TF32 tensor core reads of an f32 operand."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & -0x2000).view(torch.float32)


class Operators:
    """P_fwd = D_out^-1 W and P_bwd = D_in^-1 Wᵀ (W[s, r] = Σ w over the
    edges s -> r) as CSR matrices, each with its transpose for the
    gradient.  Degrees sum in float64; a node without edges gets 0."""

    def __init__(self, senders, receivers, weights, num_nodes: int,
                 device):
        n = int(num_nodes)
        s = torch.as_tensor(np.asarray(senders), dtype=torch.int64)
        r = torch.as_tensor(np.asarray(receivers), dtype=torch.int64)
        w = torch.as_tensor(np.asarray(weights), dtype=torch.float64)
        deg_out = torch.zeros(n, dtype=torch.float64).index_add_(0, s, w)
        deg_in = torch.zeros(n, dtype=torch.float64).index_add_(0, r, w)
        inv_out = torch.where(deg_out > 0, 1.0 / deg_out.clamp(min=1e-300),
                              torch.zeros_like(deg_out))
        inv_in = torch.where(deg_in > 0, 1.0 / deg_in.clamp(min=1e-300),
                             torch.zeros_like(deg_in))
        self.num_nodes = n
        self.mats = []
        for rows, cols, vals in ((s, r, w * inv_out[s]), (r, s, w * inv_in[r])):
            a = _csr(rows, cols, vals, n, device)
            at = _csr(cols, rows, vals, n, device)
            self.mats.append((a, at))


def _csr(rows, cols, vals, n, device):
    warnings.filterwarnings("ignore", "Sparse CSR tensor support")
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                  (n, n)).coalesce()
    return coo.to(torch.float32).to_sparse_csr().to(device)


class _Hop(torch.autograd.Function):
    """y = A @ x on (N, width); the gradient Aᵀ @ g."""

    @staticmethod
    def forward(ctx, x, a, at):
        ctx.at = at
        return a @ x

    @staticmethod
    def backward(ctx, g):
        return ctx.at @ g, None, None


def hop(a, at, x: torch.Tensor) -> torch.Tensor:
    """A @ x for x of shape (B, N, F)."""
    b, n, f = x.shape
    y = _Hop.apply(x.permute(1, 0, 2).reshape(n, b * f), a, at)
    return y.reshape(n, b, f).permute(1, 0, 2)


def basis(ops: Operators, x: torch.Tensor, k: int) -> torch.Tensor:
    out = []
    for a, at in ops.mats:
        tx = [x]
        if k > 1:
            tx.append(hop(a, at, x))
        for _ in range(2, k):
            tx.append(2.0 * hop(a, at, tx[-1]) - tx[-2])
        out.extend(tx)
    return torch.cat(out, dim=-1)


class _TF32Matmul(torch.autograd.Function):
    """a @ w with the operands of the product and of both gradient products
    rounded to TF32, as TF32 mode computes all three."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return tf32(a) @ tf32(w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g2 = tf32(g.reshape(-1, g.shape[-1]))
        ga = (g2 @ tf32(w).T).reshape(a.shape)
        gw = tf32(a.reshape(-1, a.shape[-1])).T @ g2
        return ga, gw


def _mm(a, w, precision):
    if precision == "tf32":
        return _TF32Matmul.apply(a, w)
    return a @ w


def forward(params: dict, ops: Operators, x: torch.Tensor, model: dict,
            precision: str = "float32") -> torch.Tensor:
    """(B, T, N, F) inputs -> (B, T, N, out): the DCRNN cell over T steps
    from a zero state, each hidden state through the readout if any."""
    k = int(model["basis_terms"])
    c = int(model["rnn_units"])
    b, t, n, _ = x.shape
    h = x.new_zeros((b, n, c))
    outs = []
    for i in range(t):
        xi = x[:, i]
        zr = torch.sigmoid(_mm(basis(ops, torch.cat([xi, h], -1), k),
                               params["w_zr"], precision) + params["b_zr"])
        z, r = zr[..., :c], zr[..., c:]
        cand = torch.tanh(_mm(basis(ops, torch.cat([xi, h * r], -1), k),
                              params["w_h"], precision) + params["b_h"])
        h = z * h + (1.0 - z) * cand
        if model.get("output_dim"):
            outs.append(_mm(h, params["w_out"], precision) + params["b_out"])
        else:
            outs.append(h)
    return torch.stack(outs, dim=1)


def windows(series: torch.Tensor, starts, lags: int):
    """(x, y) of the windows at ``starts``: x = series[s : s+lags], y =
    series[s+lags : s+2·lags]."""
    idx = torch.as_tensor(np.asarray(starts), dtype=torch.int64,
                          device=series.device)
    steps = torch.arange(2 * lags, device=series.device)
    win = series[idx[:, None] + steps[None, :]]
    return win[:, :lags], win[:, lags:]


def out_dim(model: dict) -> int:
    """The output's features: the readout's, else the hidden state's.  The
    loss is over the targets' first ``out_dim`` features."""
    return int(model.get("output_dim") or model["rnn_units"])


def loss_and_grads(params: dict, ops, x, y, means, stds, model: dict,
                   block: int, precision: str = "float32"):
    """Masked MAE on de-normalized values over the whole batch, and its
    gradients, computed ``block`` windows at a time: the loss is
    Σ |p − t|·mask / Σ mask over every entry, so the blocks' sums add up
    to it.  Returns (loss, {name: grad})."""
    out = out_dim(model)
    means, stds = means[:out], stds[:out]
    true = y[..., :out] * stds + means
    count = (true != 0).sum().to(torch.float64)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = 0.0
    for lo in range(0, x.shape[0], block):
        pred = forward(leaves, ops, x[lo:lo + block], model, precision)
        t = true[lo:lo + block]
        err = torch.abs(pred * stds + means - t) * (t != 0)
        err = torch.where(torch.isnan(err), torch.zeros_like(err), err)
        part = err.sum() / count.float()
        g = torch.autograd.grad(part, list(leaves.values()))
        for name, gi in zip(leaves, g):
            grads[name] += gi
        total += float(part.detach())
    return total, grads


def train(params: dict, ops, batches, means, stds, model: dict, lr: float,
          block: int, precision: str = "float32"):
    """Adam over ``batches`` [(x, y), ...] from ``params``.  Returns the
    losses, the first step's gradients and the parameters after the
    last step."""
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for step, (x, y) in enumerate(batches, start=1):
        loss, g = loss_and_grads(p, ops, x, y, means, stds, model, block,
                                 precision)
        losses.append(loss)
        if first is None:
            first = {k: gi.clone() for k, gi in g.items()}
        c1 = 1.0 - BETAS[0] ** step
        c2 = 1.0 - BETAS[1] ** step
        for k in p:
            m[k] = BETAS[0] * m[k] + (1.0 - BETAS[0]) * g[k]
            v2[k] = BETAS[1] * v2[k] + (1.0 - BETAS[1]) * g[k] * g[k]
            denom = torch.sqrt(v2[k]) / math.sqrt(c2) + EPS
            p[k] = p[k] - (lr / c1) * m[k] / denom
    return losses, first, p
