"""An ASTGCN block's tail in the Chebyshev output's own layout:

    pre = xt @ W_res + Σ_k shift_k(xh) @ W_time[k]
    z   = relu(pre + b_time + b_res)
    y   = (z − mean) · rsqrt(var + ε) · γ + β,  var = max(E[z²] − E[z]², 0)

over rows of C channels, for xh (B, T, N, C_in) (the ReLU of the
Chebyshev output), xt (B, T, N, F) (the block's input) and y (B, T, N, C),
all with the channels last.  It is the time convolution (kernel 1 × 3 over
T, zero padding, stride 1: shift_k(xh)[t] = xh[t + k − 1], zero outside),
the residual convolution (1 × 1), their sum, ReLU and flax's
``LayerNorm``, as ``models/attention/astgcn.py`` ``ASTGCNBlock`` has them
(``_BlockTail``).

- The convolutions are plain GEMMs on the rows (:func:`conv_forward`,
  :func:`conv_backward`): each shift of xh is a view offset by N rows
  within a batch element, so a batched GEMM reads it where it lies and
  accumulates into one (B·T·N, C) buffer ``pre``; the biases are left
  out of it.  CPU and card run the same plan.
- The elementwise part, forward and backward, is one pass each:
  on the card ``csrc/block_tail.cu`` (:func:`block_tail_forward`,
  :func:`block_tail_backward`), on the CPU the plain version
  (:func:`plain_forward`, :func:`plain_backward`).  The forward writes y
  and each row's (mean, variance before the clip); the backward reads the
  gradient and ``pre``, recomputes z and x̂ and writes the gradient of
  ``pre`` once, which is the gradient of both convolutions' outputs, with
  γ's, β's and the biases' gradients summed in a fixed order.

The counter ``block_tail`` holds the kernel's forward and backward
launches and the bytes copied into the tail's layout (an operand whose
rows are not contiguous), which the model's path keeps at 0
(``_counters``).
"""

from __future__ import annotations

import torch

from .. import _counters
from .bcsr import launch

# the widest row the kernel takes: 32 lanes of one float4
MAX_WIDTH = 128
# the most CTAs either kernel runs (a fixed grid, so the backward's sums of
# γ's, β's and the biases' gradients add in the same order on any card)
CTAS = 1024


def takes(width: int) -> bool:
    """The kernel takes rows of ``width`` channels: a multiple of 4, at
    most :data:`MAX_WIDTH`."""
    return 0 < width <= MAX_WIDTH and width % 4 == 0


def contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy of it counted in
    ``block_tail_forward.copied``."""
    if not t.is_contiguous():
        t = t.contiguous()
        block_tail_forward.copied += t.numel() * t.element_size()
    return t


def rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (…, C) as a (rows, C) view of :func:`contiguous` ``t``."""
    return contiguous(t).view(-1, t.shape[-1])


def conv_forward(xh: torch.Tensor, xt: torch.Tensor, w_time: torch.Tensor,
                 w_res: torch.Tensor) -> torch.Tensor:
    """``pre`` (B·T·N, C) = xt @ W_res + Σ_k shift_k(xh) @ W_time[k] for xh
    (B, T, N, C_in) contiguous, xt's rows (B·T·N, F), w_time (1, 3, C_in,
    C), w_res (1, 1, F, C): one GEMM a term, the shifted ones batched over
    B with xh's rows read where they lie."""
    B, T, N, c_in = xh.shape
    c = w_time.shape[-1]
    xs = xh.view(B, T * N, c_in)
    pre = torch.mm(xt, w_res[0, 0])
    pre.addmm_(xh.view(-1, c_in), w_time[0, 1])
    if T > 1:
        pv = pre.view(B, T * N, c)
        # t takes xh[t − 1] through tap 0 and xh[t + 1] through tap 2
        pv[:, N:].baddbmm_(xs[:, :-N], w_time[0, 0].expand(B, c_in, c))
        pv[:, :-N].baddbmm_(xs[:, N:], w_time[0, 2].expand(B, c_in, c))
    return pre


def conv_backward(g_pre: torch.Tensor, xh: torch.Tensor, xt: torch.Tensor,
                  w_time: torch.Tensor, w_res: torch.Tensor,
                  needs: tuple) -> tuple:
    """(g_xh, g_xt, g_w_time, g_w_res) of :func:`conv_forward` from the
    gradient of ``pre`` (B·T·N, C); g_xh (B, T, N, C_in), g_xt as xt's
    rows; ``needs`` says which are wanted (None for the others)."""
    B, T, N, c_in = xh.shape
    c = g_pre.shape[1]
    gv = g_pre.view(B, T * N, c)
    g_xh = g_xt = g_wt = g_wr = None
    if needs[0]:
        g_xh = torch.mm(g_pre, w_time[0, 1].t())
        if T > 1:
            gx = g_xh.view(B, T * N, c_in)
            gx[:, :-N].baddbmm_(gv[:, N:],
                                w_time[0, 0].t().expand(B, c, c_in))
            gx[:, N:].baddbmm_(gv[:, :-N],
                               w_time[0, 2].t().expand(B, c, c_in))
        g_xh = g_xh.view(xh.shape)
    if needs[1]:
        g_xt = torch.mm(g_pre, w_res[0, 0].t())
    if needs[2]:
        flat = xh.view(-1, c_in)
        mid = torch.mm(flat.t(), g_pre)
        if T > 1:
            # tap 0 pairs xh[b, t − 1] with g[b, t]: every pair of rows N
            # apart, less those across two batch elements, (b, T − 1) with
            # (b + 1, 0); tap 2 the same the other way
            before = torch.mm(flat[:-N].t(), g_pre[N:])
            after = torch.mm(flat[N:].t(), g_pre[:-N])
            if B > 1:
                g4 = g_pre.view(B, T, N, c)
                before -= torch.bmm(xh[:-1, -1].transpose(1, 2),
                                    g4[1:, 0]).sum(0)
                after -= torch.bmm(xh[1:, 0].transpose(1, 2),
                                   g4[:-1, -1]).sum(0)
        else:
            before = after = torch.zeros_like(mid)
        g_wt = torch.stack([before, mid, after])[None]
    if needs[3]:
        g_wr = torch.mm(xt.t(), g_pre)[None, None]
    return g_xh, g_xt, g_wt, g_wr


def plain_forward(pre, b_time, b_res, gamma, beta, eps) -> tuple:
    """The plain version: (y (rows, C), stats (rows, 2): each row's mean
    and its variance before the clip)."""
    z = torch.relu(pre + (b_time + b_res))
    mean = z.mean(-1, keepdim=True)
    var = (z * z).mean(-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var.clamp(min=0.0) + eps)
    y = (z - mean) * (rstd * gamma) + beta
    return y, torch.cat([mean, var], dim=1)


def plain_backward(g, pre, stats, b_time, b_res, gamma, eps) -> tuple:
    """The plain version's gradients for g (B, T, N, C) in any layout, read
    where it lies: (g_pre (rows, C), (3, C): the sums over rows of g·x̂
    (γ's), of g (β's) and of g_pre (each bias's))."""
    c = g.shape[-1]
    a = pre.view(g.shape) + (b_time + b_res)
    stats = stats.view(g.shape[:-1] + (2,))
    mean, var = stats[..., :1], stats[..., 1:]
    rstd = torch.rsqrt(var.clamp(min=0.0) + eps)
    xhat = (torch.relu(a) - mean) * rstd
    dy = g * gamma
    m_dy = dy.sum(-1, keepdim=True) / c
    # the clip's gradient: none where E[z²] − E[z]² fell below 0
    m_dyx = torch.where(var >= 0, (dy * xhat).sum(-1, keepdim=True) / c,
                        torch.zeros_like(var))
    g_pre = torch.empty_like(pre).view(g.shape)
    torch.mul(rstd, dy - m_dy - xhat * m_dyx, out=g_pre)
    g_pre.masked_fill_(a <= 0, 0.0)
    over = tuple(range(g.dim() - 1))
    return g_pre.view(-1, c), torch.stack(
        [(g * xhat).sum(over), g.sum(over), g_pre.sum(over)])


def check(pre: torch.Tensor) -> None:
    """Refuse what the kernel does not take: f32 alone, on a CUDA device,
    rows of a width :func:`takes` starting on the 16-byte grid, fewer than
    2**30 of them (it indexes rows in 32 bits)."""
    if pre.dtype != torch.float32:
        raise TypeError(f"block_tail: the kernel takes f32, got {pre.dtype}")
    if pre.device.type != "cuda":
        raise ValueError(f"block_tail: no kernel for a tensor on "
                         f"{pre.device}")
    if not takes(pre.shape[1]):
        raise ValueError(f"block_tail: the kernel takes rows of a multiple "
                         f"of 4 channels up to {MAX_WIDTH}, got "
                         f"{pre.shape[1]}")
    if pre.data_ptr() % 16:
        raise ValueError("block_tail: rows off the 16-byte grid")
    if pre.shape[0] >= 1 << 30:
        raise ValueError(f"block_tail: {pre.shape[0]} rows, the kernel "
                         "takes fewer than 2**30")


def _params(pre, *vectors) -> list:
    """The pointers of the (C,) channel vectors, each checked against
    ``pre``."""
    for v in vectors:
        if v.shape != (pre.shape[1],) or v.dtype != pre.dtype or (
                v.device != pre.device) or v.stride(0) != 1:
            raise ValueError(f"block_tail: a channel vector must be a "
                             f"contiguous ({pre.shape[1]},) {pre.dtype} on "
                             f"{pre.device}, got {tuple(v.shape)} "
                             f"{v.dtype} on {v.device}")
    return [v.data_ptr() for v in vectors]


def block_tail_forward(pre, b_time, b_res, gamma, beta, eps) -> tuple:
    """The forward on the card (``pgtt_block_tail_fwd``) for ``pre``
    (rows, C) contiguous f32: (y, stats) as :func:`plain_forward`."""
    check(pre)
    pre = contiguous(pre)
    y = torch.empty_like(pre)
    stats = pre.new_empty((pre.shape[0], 2))
    launch(block_tail_forward, "pgtt_block_tail_fwd", pre, pre.data_ptr(),
           *_params(pre, b_time, b_res, gamma, beta), y.data_ptr(),
           stats.data_ptr(), pre.shape[0], pre.shape[1], float(eps), CTAS)
    return y, stats


def _row_strides(g: torch.Tensor) -> tuple:
    """g (B, T, N, C)'s row strides by b, t and n where each row's channels
    are contiguous and every row starts on the 16-byte grid, else None."""
    strides = tuple(0 if size == 1 else stride
                    for size, stride in zip(g.shape[:3], g.stride()[:3]))
    if (g.shape[3] > 1 and g.stride(3) != 1) or g.data_ptr() % 16 or any(
            s % 4 for s in strides):
        return None
    return strides


def block_tail_backward(g, pre, stats, b_time, b_res, gamma, eps) -> tuple:
    """The backward on the card (``pgtt_block_tail_bwd``) for g (B, T, N,
    C): (g_pre, (3, C)) as :func:`plain_backward`.  g's rows are read where
    they lie if each row's channels are contiguous (:func:`_row_strides`),
    else from a contiguous copy (counted)."""
    check(pre)
    B, T, N, C = g.shape
    if g.dtype != pre.dtype or g.device != pre.device or (
            B * T * N, C) != tuple(pre.shape):
        raise ValueError(f"block_tail: a gradient {tuple(g.shape)} "
                         f"{g.dtype} on {g.device} for rows "
                         f"{tuple(pre.shape)} {pre.dtype} on {pre.device}")
    strides = _row_strides(g)
    if strides is None:
        g = contiguous(g)
        strides = _row_strides(g)
    g_pre = torch.empty_like(pre)
    sums = pre.new_zeros((3, C))
    partial = pre.new_empty((CTAS, 3, C))
    launch(block_tail_backward, "pgtt_block_tail_bwd", pre, g.data_ptr(),
           *strides, T, N, pre.data_ptr(), stats.data_ptr(),
           *_params(pre, b_time, b_res, gamma), g_pre.data_ptr(),
           partial.data_ptr(), sums.data_ptr(), pre.shape[0], C, float(eps),
           CTAS)
    return g_pre, sums


block_tail_forward.launches = 0
# bytes of operands copied into rows of contiguous channels
block_tail_forward.copied = 0
block_tail_backward.launches = 0


def block_tail_counts() -> tuple:
    """(forward launches, backward launches, bytes copied into rows) of
    the kernel."""
    return (block_tail_forward.launches, block_tail_backward.launches,
            block_tail_forward.copied)


def add_block_tail_counts(delta) -> None:
    """Add ``delta`` (a :func:`block_tail_counts` tuple), as the captured
    steps do at each replay (``_counters``)."""
    block_tail_forward.launches += delta[0]
    block_tail_backward.launches += delta[1]
    block_tail_forward.copied += delta[2]


_counters.register("block_tail", block_tail_counts, add_block_tail_counts)
