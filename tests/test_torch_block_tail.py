"""An ASTGCN block's tail in the Chebyshev output's layout on the CPU
(``ops/block_tail.py``, ``models/attention/astgcn.py`` ``_BlockTail``):
against the flax ``Conv`` + ``LayerNorm`` formulation it replaced, forward
and every gradient, in both attention modes, on block 0's and block 1's
inputs, with rows whose variance is clipped; ``gradcheck`` of the plain
version in float64; no copy of a full-size tensor inside the tail; the
gradient read where the model's consumers leave it; the benchmark's reader
of the kernel's time."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from pytorch_geometric_temporal_tpu_torch import _counters
from pytorch_geometric_temporal_tpu_torch.models import ASTGCN
from pytorch_geometric_temporal_tpu_torch.models._cells import Conv, LayerNorm
from pytorch_geometric_temporal_tpu_torch.models.attention import astgcn
from pytorch_geometric_temporal_tpu_torch.ops import Graph, block_tail

N = 9


def _graph(n=N, e=40, seed=0):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, e))
    w = rng.uniform(0.2, 1.0, e).astype(np.float32)
    return Graph.from_edge_index(ei, w, num_nodes=n, device="cpu")


def _block(mode, f_in, c=64, seed=1):
    return astgcn.ASTGCNBlock(
        f_in, 3, c, c, 1, N, 6, "sym", attention_mode=mode, device="cpu",
        generator=torch.Generator().manual_seed(seed))


def _value_and_grads(block, x, g, gout):
    out = block(x, g)
    grads = torch.autograd.grad(out, [x] + list(block.parameters()), gout)
    return out.detach(), grads


def _close(got, want, rel, what=""):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale, what


@pytest.mark.parametrize("f_in", [2, 64])
@pytest.mark.parametrize("mode", ["dense", "edge"])
def test_block_matches_the_flax_formulation(mode, f_in):
    """A stride-1 block at the cell's width (C = 64) with block 0's input
    width (F = 2) and block 1's (F = 64): the fused tail against the same
    block through the flax ``Conv`` and ``LayerNorm`` modules, the output
    and the gradient of the input and of every parameter.  Both sum the
    same f32 products in other orders (GEMMs against a convolution over a
    padded copy; LayerNorm's sums over a contiguous row against one
    strided by N·T): they read up to 3e-7 of the output's scale and 1.2e-6
    of a gradient's largest entry, against a limit of 1e-5."""
    g = _graph()
    block = _block(mode, f_in)
    assert block.fused_tail
    x = torch.randn(2, N, f_in, 6, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    gout = torch.randn(2, N, 64, 6, generator=torch.Generator().manual_seed(3))
    got = _value_and_grads(block, x, g, gout)
    block.fused_tail = False
    want = _value_and_grads(block, x, g, gout)
    assert got[0].shape == want[0].shape == (2, N, 64, 6)
    _close(got[0], want[0], 1e-5, "output")
    names = ["x"] + [name for name, _ in block.named_parameters()]
    for name, a, e in zip(names, got[1], want[1]):
        _close(a, e, 1e-5, name)


def _flax_tail(tc, rc, ln, xh, xt):
    """The tail as the flax modules compute it: (B, T, N, C) out."""
    x_hat = tc(xh.transpose(1, 2))
    res = rc(xt.transpose(1, 2))
    return ln(torch.relu(res + x_hat)).transpose(1, 2)


def _tail_modules(f_in, c, dtype, seed=4):
    gen = torch.Generator().manual_seed(seed)
    tc = Conv(c, c, (1, 3), padding=((0, 0), (1, 1)), device="cpu",
              generator=gen).to(dtype)
    rc = Conv(f_in, c, (1, 1), device="cpu", generator=gen).to(dtype)
    ln = LayerNorm(c, device="cpu").to(dtype)
    with torch.no_grad():
        for p in (tc.bias, rc.bias, ln.scale, ln.bias):
            p.add_(0.1 * torch.randn(p.shape, generator=gen, dtype=dtype))
    return tc, rc, ln


def _fused_tail(tc, rc, ln, xh, xt):
    return astgcn._BlockTail.apply(xh, xt, tc.kernel, tc.bias, rc.kernel,
                                   rc.bias, ln.scale, ln.bias, ln.epsilon)


def test_variance_clip_as_flax_has_it():
    """float64, C = 64, F = 2: batch element 0's rows are all but constant
    (inputs of 1e-9 and 0, a time bias equal in every channel), so
    E[z²] − E[z]² is rounding and falls below 0 on some of them, where
    flax clips it and its gradient is 0.  Output and every gradient
    against the flax formulation within 1e-9 of their scale (both sides'
    sums differ by float64 rounding, which 1/sqrt(ε) = 1,000 magnifies on
    those rows)."""
    dt = torch.float64
    b, t, n, c, f = 3, 5, 7, 64, 2
    tc, rc, ln = _tail_modules(f, c, dt)
    gen = torch.Generator().manual_seed(5)
    xh = torch.relu(torch.randn(b, t, n, c, generator=gen, dtype=dt))
    xt = torch.randn(b, t, n, f, generator=gen, dtype=dt)
    xh[0] = 1e-9 * torch.rand(t, n, c, generator=gen, dtype=dt)
    xt[0] = 0.0
    with torch.no_grad():
        tc.bias.fill_(0.7)
        rc.bias.zero_()
    pre = block_tail.conv_forward(xh, block_tail.rows(xt), tc.kernel,
                                  rc.kernel)
    _, stats = block_tail.plain_forward(pre, tc.bias, rc.bias, ln.scale,
                                        ln.bias, ln.epsilon)
    var = stats[:, 1].view(b, t, n)
    assert int((var[0] < 0).sum()) > 0, "no row's variance was clipped"
    ins = [xh.requires_grad_(True), xt.requires_grad_(True)]
    params = [tc.kernel, tc.bias, rc.kernel, rc.bias, ln.scale, ln.bias]
    gout = torch.randn(b, t, n, c, generator=gen, dtype=dt)
    got = _fused_tail(tc, rc, ln, *ins)
    want = _flax_tail(tc, rc, ln, *ins)
    _close(got.detach(), want.detach(), 1e-9, "output")
    for name, a, e in zip(
            ["xh", "xt", "time kernel", "time bias", "res kernel",
             "res bias", "scale", "bias"],
            torch.autograd.grad(got, ins + params, gout),
            torch.autograd.grad(want, ins + params, gout)):
        _close(a, e, 1e-9, name)


@pytest.mark.parametrize("xt_layout", ["contiguous", "windows"])
def test_plain_tail_gradcheck_in_float64(xt_layout):
    """``gradcheck`` of ``_BlockTail`` on the CPU (the plain version and
    the GEMM plan) in float64, with the block input contiguous and laid
    out as the model gets it, (B, N, F, T) viewed (B, T, N, F), which the
    tail copies into rows."""
    dt = torch.float64
    gen = torch.Generator().manual_seed(6)
    b, t, n, c, f = 2, 4, 3, 8, 2
    xh = torch.relu(torch.randn(b, t, n, c, generator=gen, dtype=dt))
    if xt_layout == "contiguous":
        xt = torch.randn(b, t, n, f, generator=gen, dtype=dt)
    else:
        xt = torch.randn(b, n, f, t, generator=gen, dtype=dt).permute(
            0, 3, 1, 2)
    leaves = [xh, xt, 0.3 * torch.randn(1, 3, c, c, generator=gen, dtype=dt),
              0.1 * torch.randn(c, generator=gen, dtype=dt),
              0.3 * torch.randn(1, 1, f, c, generator=gen, dtype=dt),
              0.1 * torch.randn(c, generator=gen, dtype=dt),
              1 + 0.1 * torch.randn(c, generator=gen, dtype=dt),
              0.1 * torch.randn(c, generator=gen, dtype=dt)]
    leaves = [v.requires_grad_(True) for v in leaves]
    assert torch.autograd.gradcheck(
        lambda *a: astgcn._BlockTail.apply(*a, 1e-6), leaves)


class _Copies(TorchDispatchMode):
    """Records each copy (``copy_``, ``clone``, ``constant_pad_nd``,
    ``_to_copy``) that reads or writes a tensor of at least ``numel``
    values."""

    OPS = ("copy_", "clone", "constant_pad_nd", "_to_copy")

    def __init__(self, numel):
        super().__init__()
        self.numel, self.seen = numel, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in self.OPS:
            tensors = [a for a in tree_flatten((args, kwargs, out))[0]
                       if isinstance(a, torch.Tensor)]
            if any(a.numel() >= self.numel for a in tensors):
                self.seen.append(func.overloadpacket.__name__)
        return out


@pytest.mark.parametrize("head_layout", [True, False])
@pytest.mark.parametrize("f_in", [2, 64])
def test_no_full_size_copy_between_the_chebyshev_output_and_the_block_output(
        f_in, head_layout):
    """From the Chebyshev output's ReLU (B, T, N, C) contiguous to the
    block's (B, N, C, T) output, forward and backward, the tail copies no
    tensor of B·T·N·C values: the gradient arriving as the head leaves it
    (each (b, n)'s T·C values together) or contiguous, as block 1's
    consumers leave block 0's.  The flax formulation, under the same
    watch, pads and copies."""
    b, t, n, c = 2, 6, 11, 64
    tc, rc, ln = _tail_modules(f_in, c, torch.float32)
    gen = torch.Generator().manual_seed(7)
    xh = torch.relu(torch.randn(b, t, n, c, generator=gen)).requires_grad_()
    xt = torch.randn(b, t, n, f_in, generator=gen).requires_grad_()
    if head_layout:
        gy = torch.randn(b, n, t, c, generator=gen).permute(0, 1, 3, 2)
    else:
        gy = torch.randn(b, t, n, c, generator=gen).permute(0, 2, 3, 1)
    params = [tc.kernel, tc.bias, rc.kernel, rc.bias, ln.scale, ln.bias]
    full = b * t * n * c
    before = block_tail.block_tail_counts()
    with _Copies(full) as watch:
        out = _fused_tail(tc, rc, ln, xh, xt).permute(0, 2, 3, 1)
        torch.autograd.grad(out, [xh, xt] + params, gy)
    assert watch.seen == []
    assert block_tail.block_tail_counts()[2] == before[2]
    with _Copies(full) as flax:
        out = _flax_tail(tc, rc, ln, xh, xt).permute(0, 2, 3, 1)
        torch.autograd.grad(out, [xh, xt] + params, gy)
    assert "constant_pad_nd" in flax.seen


def test_the_model_reads_each_gradient_where_it_lies(monkeypatch):
    """ASTGCN at the cell's widths (C = 64) through the benchmark's forward
    (windows (B, T, N, F) laid out (B, N, F, T)) and a masked-MAE-like
    loss: each block's tail gets a gradient whose rows the kernel reads
    where they lie, and nothing is copied into the tail's layout."""
    seen = []
    plain = block_tail.plain_backward

    def spy(g, *args):
        seen.append(block_tail._row_strides(g) is not None)
        return plain(g, *args)

    monkeypatch.setattr(block_tail, "plain_backward", spy)
    n = 40
    model = ASTGCN(nb_block=2, in_channels=2, K=3, nb_chev_filter=64,
                   nb_time_filter=64, time_strides=1, num_for_predict=12,
                   len_input=12, num_of_vertices=n, normalization="sym",
                   attention_mode="edge", device="cpu",
                   generator=torch.Generator().manual_seed(8),
                   temporal_vector_init="glorot")
    assert model.block_0.fused_tail and model.block_1.fused_tail
    xb = torch.randn(3, 12, n, 2, generator=torch.Generator().manual_seed(9))
    before = _counters.read()
    out = model(xb.permute(0, 2, 3, 1), _graph(n=n, e=200)).transpose(
        1, 2)[..., None]
    out.abs().mean().backward()
    assert seen == [True, True]
    # the plain version launches nothing; nothing was copied
    assert _counters.counted_since(before)["block_tail"] == (0, 0, 0)


def test_which_blocks_fuse_their_tail():
    """The fused tail needs stride 1 and a width the kernel takes (a
    multiple of 4 up to 128); any other block keeps the flax modules."""
    def fused(c, stride):
        return astgcn.ASTGCNBlock(2, 2, 4, c, stride, N, 6, device="cpu",
                                  generator=torch.Generator()).fused_tail

    assert fused(64, 1) and fused(4, 1) and fused(128, 1)
    assert not (fused(64, 2) or fused(5, 1) or fused(132, 1))
    assert [block_tail.takes(c) for c in (0, 4, 6, 128, 132)] == [
        False, True, False, True, False]


def test_a_tensor_off_the_cpu_takes_the_kernel_or_raises():
    """The Function sends anything but a CPU tensor to the kernel, which
    takes f32 on an NVIDIA card alone and raises otherwise, launching and
    counting nothing."""
    tc, rc, ln = _tail_modules(2, 8, torch.float32)
    xh = torch.rand(2, 3, 5, 8, device="meta")
    xt = torch.rand(2, 3, 5, 2, device="meta")
    before = block_tail.block_tail_counts()
    with pytest.raises(ValueError, match="no kernel"):
        _fused_tail(*(m.to("meta") for m in (tc, rc, ln)), xh, xt)
    pre = torch.zeros(30, 8, dtype=torch.float64)
    with pytest.raises(TypeError, match="f32"):
        block_tail.block_tail_forward(pre, *[pre[0]] * 4, 1e-6)
    assert block_tail.block_tail_counts() == before


# the profiler's names of the tail's kernels, hop 1's and the fused
# kernel's (an H100's trace)
TAIL_KERNEL_NAMES = (
    "void (anonymous namespace)::block_tail_fwd_kernel<16>(float const*, "
    "float const*, float const*, float const*, float const*, float*, "
    "float2*, int, int, float)",
    "void (anonymous namespace)::block_tail_bwd_kernel<16>(float const*, "
    "long, long, long, int, int, float const*, float2 const*, float const*, "
    "float const*, float const*, float*, float*, int, int, float)",
    "(anonymous namespace)::block_tail_sum_kernel(float const*, int, int, "
    "float*)")
HOP_KERNEL_NAME = (
    "void (anonymous namespace)::weighted_hop_fwd_kernel<4, 6>(float "
    "const*, long, long, float const*, long, long, int const*, int const*, "
    "int const*, float*, long, long, int, int, int, int)")
SPMM_KERNEL_NAME = ("void (anonymous namespace)::hybrid_spmm_kernel<float, "
                    "96>(CUtensorMap_st, int const*, int const*)")


class _Summary:
    def __init__(self, kernels):
        self.kernels = kernels


class _Run:
    def __init__(self, kernels, kinds):
        self.summary = None if kernels is None else _Summary(kernels)
        self.sub_kinds = kinds


@pytest.mark.parametrize("kernels,kinds,want", [
    ({TAIL_KERNEL_NAMES[0]: [0.004, 4], TAIL_KERNEL_NAMES[1]: [0.006, 4],
      TAIL_KERNEL_NAMES[2]: [0.0002, 4], HOP_KERNEL_NAME: [0.5, 4],
      SPMM_KERNEL_NAME: [0.5, 8]}, [("train", 32)] * 2, 5.1),
    ({HOP_KERNEL_NAME: [0.5, 4], SPMM_KERNEL_NAME: [0.5, 8]},
     [("train", 32)] * 2, None),
    ({TAIL_KERNEL_NAMES[0]: [0.004, 4]}, [], None),
    (None, [("train", 32)], None),
])
def test_block_tail_ms_per_step_reads_the_kernels_by_name(kernels, kinds,
                                                           want):
    """``perfbench/metrics/block_tail_ms_per_step.py``: the tail's kernels'
    device ms a train step, silent where none ran (the parent's program)
    or no train step was traced; their names are apart from the kernels
    that ``spmm_ms_per_step`` and ``hop1_ms_per_step`` read."""
    from perfbench import manifest
    from perfbench.metrics import _common

    metric = manifest.load_metric("block_tail_ms_per_step")
    hop = manifest.load_metric("hop1_ms_per_step")
    got = metric.read(_Run(kernels, kinds))
    assert got == (None if want is None else pytest.approx(want))
    assert all(metric.KERNELS.search(k) for k in TAIL_KERNEL_NAMES)
    assert not any(_common.SPMM_KERNELS.search(k) or hop.KERNELS.search(k)
                   for k in TAIL_KERNEL_NAMES)
    assert not any(metric.KERNELS.search(k)
                   for k in (HOP_KERNEL_NAME, SPMM_KERNEL_NAME))
    assert (metric.LAYER, metric.UNIT, metric.MOVES, metric.SOURCE) == (
        hop.LAYER, "ms", "train_samples_per_s", "device_trace")
