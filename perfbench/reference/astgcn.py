"""Plain PyTorch ASTGCN training, the reference that decides ``correct``.

Follows ASTGCN (Guo, Lin, Feng, Song, Wan, "Attention Based
Spatial-Temporal Graph Convolutional Networks for Traffic Flow
Forecasting", AAAI 2019) as its recent-period component, as the index-
batching recipe trains it: blocks of temporal attention, spatial
attention, a Chebyshev convolution with attention-scaled terms, a (1, 3)
time convolution beside a (1, 1) residual one, ReLU and LayerNorm; a head
from (T, F) to the predicted steps; masked MAE on the de-normalized first
feature; Adam (PyTorch's defaults).  It imports torch and numpy only:
nothing of the program, nothing it made.  The scaled Laplacian is built
here from the edge list; products run in f32 with TF32 off, in blocks of
the batch, so that the configuration fits beside nothing else.

``precision="tf32"`` rounds every dense product's operands to TF32 before
an f32 product: the control, the step below the configuration's f32.  The sparse products stay f32.

Departures from the paper, shared with the program and stated in the
configuration:

- the recent component only (the paper adds daily and weekly ones), as
  PyTorch Geometric Temporal's ``ASTGCN`` class builds it;
- spatial attention restricted to the graph: the paper's
  S = softmax(V_s · σ((X W_1) W_2 (W_3 X)ᵀ + b_s)) over all N × N pairs
  becomes σ(lhs_i · rhs_j + b) at each listed edge (i, j) and at the
  diagonal, with a scalar b in place of the (N, N) ``V_s`` and ``b_s``,
  normalized over each column j's entries: the edges into j, each listed
  edge one entry (a duplicate twice, a self-loop beside the diagonal), and
  the diagonal;
- L̂ = 2L/λ_max − I with λ_max = 2 for the symmetric Laplacian of the
  graph with its self-loops removed, degrees over the senders (PyG's
  ``ChebConv``); the paper takes the largest eigenvalue.  L̂'s diagonal is
  then 0;
- the Chebyshev terms as PGT computes them: T_0 = diag(S) X, T_1 =
  (L̂ ∘ S) X, T_k = 2 L̂ T_{k-1} − T_{k-2} with the raw L̂ for k ≥ 2;
- LayerNorm with ε = 1e-6 (flax's; PGT uses torch's 1e-5).

Hop 1 is a product with a matrix of its own for each window, whose values
are L̂'s times the window's attention; its gradient flows to both the
features and the values.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

BETAS = (0.9, 0.999)
EPS = 1e-8
LN_EPS = 1e-6


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) with its mantissa rounded to TF32's 10 bits, to
    nearest even: what a TF32 tensor core reads of an f32 operand."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & -0x2000).view(torch.float32)


def windows(series: torch.Tensor, starts, lags: int):
    """(x, y) of the windows at ``starts``: x = series[s : s+lags], y =
    series[s+lags : s+2·lags]."""
    idx = torch.as_tensor(np.asarray(starts), dtype=torch.int64,
                          device=series.device)
    steps = torch.arange(2 * lags, device=series.device)
    win = series[idx[:, None] + steps[None, :]]
    return win[:, :lags], win[:, lags:]


class Operators:
    """L̂ (sym, λ_max = 2) of the graph as a CSR matrix with rows at the
    senders and columns at the receivers, and its transpose; the pattern
    hop 1's per-window matrices share; the edge list the attention reads.
    Degrees sum in float64; a node without edges gets 0."""

    def __init__(self, senders, receivers, weights, num_nodes: int,
                 device):
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        n = int(num_nodes)
        s = torch.as_tensor(np.asarray(senders), dtype=torch.int64)
        r = torch.as_tensor(np.asarray(receivers), dtype=torch.int64)
        w = torch.as_tensor(np.asarray(weights), dtype=torch.float64)
        w = w * (s != r)
        deg = torch.zeros(n, dtype=torch.float64).index_add_(0, s, w)
        dis = torch.where(deg > 0, deg.clamp(min=1e-300).rsqrt(),
                          torch.zeros_like(deg))
        keep = torch.nonzero(s != r).squeeze(1)
        lhat = -dis[s[keep]] * w[keep] * dis[r[keep]]
        # the distinct (row, column) pairs in row-major order, and where
        # each kept edge's value goes among them
        key, slot = torch.unique(s[keep] * n + r[keep], return_inverse=True)
        rows, cols = key // n, key % n
        t_order = torch.argsort(cols * n + rows)
        self.num_nodes, self.nnz = n, int(key.numel())
        self.senders, self.receivers = s.to(device), r.to(device)
        self.keep, self.slot = keep.to(device), slot.to(device)
        self.lhat = lhat.to(torch.float32).to(device)
        self.rows, self.cols = rows.to(device), cols.to(device)
        self.crow = _crow(rows, n).to(device)
        self.crow_t = _crow(cols, n).to(device)
        self.col_t = rows[t_order].to(device)
        self.t_order = t_order.to(device)
        vals = torch.zeros(self.nnz, dtype=torch.float64).index_add_(
            0, slot, lhat).to(torch.float32).to(device)
        self.mat = self.csr(vals)
        self.mat_t = self.csr_t(vals)

    def csr(self, vals: torch.Tensor) -> torch.Tensor:
        return torch.sparse_csr_tensor(self.crow, self.cols, vals,
                                       (self.num_nodes, self.num_nodes),
                                       check_invariants=False)

    def csr_t(self, vals: torch.Tensor) -> torch.Tensor:
        return torch.sparse_csr_tensor(self.crow_t, self.col_t,
                                       vals[self.t_order],
                                       (self.num_nodes, self.num_nodes),
                                       check_invariants=False)


class _Hop(torch.autograd.Function):
    """y = A @ x on (N, width); the gradient Aᵀ @ g."""

    @staticmethod
    def forward(ctx, x, a, at):
        ctx.at = at
        return a @ x

    @staticmethod
    def backward(ctx, g):
        return ctx.at @ g, None, None


def _crow(rows: torch.Tensor, n: int) -> torch.Tensor:
    counts = torch.bincount(rows, minlength=n)
    return torch.cat([counts.new_zeros(1), counts.cumsum(0)])


class _ValuedHop(torch.autograd.Function):
    """y = A @ x for one window's A (``ops``' pattern, values ``vals``) and
    x (N, width); the gradients Aᵀ @ g and, at each nonzero (i, j),
    Σ_k g[i, k] · x[j, k]."""

    @staticmethod
    def forward(ctx, x, vals, ops):
        ctx.save_for_backward(x, vals)
        ctx.ops = ops
        return ops.csr(vals) @ x

    @staticmethod
    def backward(ctx, g):
        x, vals = ctx.saved_tensors
        ops = ctx.ops
        gx = ops.csr_t(vals) @ g
        gv = (g[ops.rows] * x[ops.cols]).sum(-1)
        return gx, gv, None


def _lhat_hop(ops: Operators, v: torch.Tensor) -> torch.Tensor:
    """L̂ @ v over the node axis of v (B, T, N, F)."""
    b, t, n, f = v.shape
    y = _Hop.apply(v.permute(2, 0, 1, 3).reshape(n, b * t * f), ops.mat,
                   ops.mat_t)
    return y.reshape(n, b, t, f).permute(1, 2, 0, 3)


def _attention_hop(ops: Operators, s_edge: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """(L̂ ∘ S_b) @ v_b for each window b: v (B, T, N, F), s_edge (B, E)
    the attention at each listed edge."""
    b, t, n, f = v.shape
    vals = torch.zeros((b, ops.nnz), dtype=v.dtype, device=v.device)
    vals = vals.index_add(1, ops.slot, ops.lhat * s_edge[:, ops.keep])
    out = []
    for i in range(b):
        x = v[i].permute(1, 0, 2).reshape(n, t * f)
        y = _ValuedHop.apply(x, vals[i], ops)
        out.append(y.reshape(n, t, f).permute(1, 0, 2))
    return torch.stack(out)


class _TF32Matmul(torch.autograd.Function):
    """a @ b (batched, broadcasting) with the operands of the product and
    of both gradient products rounded to TF32, as TF32 mode computes all
    three."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        ga = (g @ tf32(b).mT).sum_to_size(a.shape)
        gb = (tf32(a).mT @ g).sum_to_size(b.shape)
        return ga, gb


def _mm(a, b, precision):
    if precision == "tf32":
        return _TF32Matmul.apply(a, b)
    return a @ b


def _temporal_attention(p, x, precision):
    """E (B, T, T) = softmax over dim 1 of V_e · σ(((X U_1) U_2)(U_3 X) +
    b_e) for x (B, N, F, T)."""
    b, n, f, t = x.shape
    xt = x.permute(0, 3, 2, 1)                               # (B, T, F, N)
    lhs = _mm(_mm(xt, p["U1"][:, None], precision)[..., 0], p["U2"],
              precision)                                     # (B, T, N)
    rhs = _mm(x.permute(0, 1, 3, 2), p["U3"][:, None],
              precision)[..., 0]                             # (B, N, T)
    e = _mm(p["Ve"], torch.sigmoid(_mm(lhs, rhs, precision) + p["be"]),
            precision)
    return torch.softmax(e, dim=1)


def _spatial_attention(p, ops: Operators, x, precision):
    """(S at each listed edge (B, E), S's diagonal (B, N)) for x (B, N, F,
    T): σ(lhs_i · rhs_j + b) normalized over each column's entries."""
    lhs = _mm(_mm(x, p["W1"][:, None], precision)[..., 0], p["W2"],
              precision)                                     # (B, N, T)
    rhs = _mm(x.permute(0, 1, 3, 2), p["W3"][:, None],
              precision)[..., 0]                             # (B, N, T)
    s, r = ops.senders, ops.receivers
    raw_e = torch.sigmoid((lhs[:, s] * rhs[:, r]).sum(-1) + p["bs"])
    raw_d = torch.sigmoid((lhs * rhs).sum(-1) + p["bs"])
    # the raw scores lie in (0, 1): exp needs no shift
    exp_e, exp_d = torch.exp(raw_e), torch.exp(raw_d)
    denom = exp_d.index_add(1, r, exp_e)
    return exp_e / denom[:, r], exp_d / denom


def _block(p, ops: Operators, x, model: dict, precision):
    """One block on x (B, N, F, T) -> (B, N, C_t, T)."""
    k = int(model["K"])
    e = _temporal_attention(p, x, precision)
    x_tilde = _mm(x, e[:, None], precision)                  # (B, N, F, T)
    s_edge, s_diag = _spatial_attention(p, ops, x_tilde, precision)
    xt = x.permute(0, 3, 1, 2)                               # (B, T, N, F)
    terms = [xt * s_diag[:, None, :, None]]
    if k > 1:
        terms.append(_attention_hop(ops, s_edge, terms[0]))
    for _ in range(2, k):
        terms.append(2.0 * _lhat_hop(ops, terms[-1]) - terms[-2])
    cheb = sum(_mm(tk, p["theta"][i], precision)
               for i, tk in enumerate(terms)) + p["theta_b"]
    h = torch.relu(cheb).permute(0, 2, 1, 3)                 # (B, N, T, C)
    # the (1, 3) time convolution, padded by one step on each side, as a
    # product over the three shifted copies
    t = h.shape[2]
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1))
    taps = torch.cat([hp[:, :, j:j + t] for j in range(3)], dim=-1)
    kt = p["time_w"][0]                                      # (3, C, C_t)
    conv = _mm(taps, kt.reshape(-1, kt.shape[-1]), precision) + p["time_b"]
    res = _mm(x.permute(0, 1, 3, 2), p["res_w"][0, 0],
              precision) + p["res_b"]
    z = torch.relu(res + conv)
    mean = z.mean(-1, keepdim=True)
    var = ((z - mean) ** 2).mean(-1, keepdim=True)
    out = (z - mean) / torch.sqrt(var + LN_EPS) * p["ln_g"] + p["ln_b"]
    return out.permute(0, 1, 3, 2)


def block_params(p: dict, i: int) -> dict:
    prefix = f"b{i}."
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def forward(params: dict, ops: Operators, x: torch.Tensor, model: dict,
            precision: str = "float32") -> torch.Tensor:
    """(B, T, N, F) inputs -> (B, P, N, 1): the blocks over x laid out
    (B, N, F, T), then the head out[b, n, p] = Σ_{t, f} X[b, n, f, t] ·
    W[p, t, f] + c[p]."""
    h = x.permute(0, 2, 3, 1)
    for i in range(int(model["nb_block"])):
        h = _block(block_params(params, i), ops, h, model, precision)
    b, n, f, t = h.shape
    w = params["head_w"]                                     # (P, T, F)
    flat = h.permute(0, 1, 3, 2).reshape(b, n, t * f)
    out = _mm(flat, w.reshape(w.shape[0], -1).T, precision) + params["head_b"]
    return out.permute(0, 2, 1)[..., None]


def loss_and_grads(params: dict, ops, x, y, means, stds, model: dict,
                   block: int, precision: str = "float32"):
    """Masked MAE on the de-normalized first ``output_dim`` features over
    the whole batch, and its gradients, computed ``block`` windows at a
    time: the loss is Σ |p − t|·mask / Σ mask over every entry, so the
    blocks' sums add up to it.  Returns (loss, {name: grad})."""
    out = int(model["output_dim"])
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
