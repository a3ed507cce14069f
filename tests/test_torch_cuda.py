"""The port's CUDA kernels on the card, against their plain versions: the
fused hybrid SpMM (the main path) and its baseline pair K1/K2.

Marked ``cuda``: each test skips without an NVIDIA card (decided inside
the fixture, never at import), and runs in f32 (TF32 off in cuDNN and
cuBLAS).  Run on the card with ``python -m pytest tests/test_torch_cuda.py
-m cuda``.  Tolerance: both sides sum the same f32 products in another
order, 1e-4 of the output's scale.
"""

import os
import statistics
import traceback

import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu_torch import config_override
from pytorch_geometric_temporal_tpu_torch.models import (
    ASTGCN, DCRNNSeq, EvolveGCNHSeq, EvolveGCNOSeq, GConvGRU, MSTGCN, STConv,
    TGCN)
from pytorch_geometric_temporal_tpu_torch.ops import (
    DiffusionOperators, Graph, Prenormalized, bcsr, host_cheb_norm,
    lambda_max, prenormalize_cheb, prenormalize_gcn, prepare_graph,
    spmm_segment, stack_bcsr, stack_bcsr_gcn, stack_graphs)
from pytorch_geometric_temporal_tpu_torch.signal import StackedSignal
from pytorch_geometric_temporal_tpu_torch.train import SnapshotTrainer, mse

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    # f32 throughout, as chip_smoke.py runs.  cuDNN's convolutions default
    # to TF32, which rounds their inputs to 10 mantissa bits: where two
    # paths differ by their sum order (~1e-7), an input may round to the
    # neighbouring TF32 value (2^-11 apart), and one output then misses a
    # 1e-4 limit (tools/astgcn_edge_noise.py)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def banded(n, e, seed=0, band=40):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, size=e)
    r = np.clip(s + rng.integers(-band, band + 1, size=e), 0, n - 1)
    s = np.concatenate([s, rng.integers(0, n, size=e // 20)])
    r = np.concatenate([r, rng.integers(0, n, size=e // 20)])
    return np.stack([s, r]), rng.uniform(0.1, 1.0, s.size).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [8, 13, 96, 200, 768])
def test_kernels_match_plain(cuda, dtype, f):
    ei, w = banded(1500, 30000)
    g = Graph.from_edge_index(ei, w, num_nodes=1500, device=cuda)
    mat = bcsr.BCSRMatrix.from_graph(g, dtype=dtype)
    for half in (mat.fwd, mat.bwd):
        assert half.nnzb and half.num_rem
        x = torch.randn(half.num_cols, f, device=cuda).to(dtype)
        before = bcsr.tile_spmm.launches, bcsr.rem_scatter_.launches
        out = bcsr.tile_spmm(half, x)
        ref = bcsr.tile_spmm_plain(half, x)
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))
        bcsr.rem_scatter_(half, x, out)
        bcsr.rem_scatter_plain(half, x, ref)
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))
        assert (bcsr.tile_spmm.launches, bcsr.rem_scatter_.launches) == (
            before[0] + 1, before[1] + 1)


def operator_shape(name):
    """(edge_index, weights, n, min_block_edges) of the four operator
    shapes: tiles and a remainder, tiles only, remainder only, and a graph
    whose row blocks 3 and 4 (nodes 384..639) receive no edge."""
    n = 1000
    ei, w = banded(n, 20000, seed=4)
    if name == "empty-rows":
        keep = ~((ei[1] >= 384) & (ei[1] < 640))
        ei, w = ei[:, keep], w[keep]
    mbe = {"hybrid": 32, "all-tiles": 0, "all-remainder": 10**6,
           "empty-rows": 32}[name]
    return ei, w, n, mbe


@pytest.mark.parametrize("shape", ["hybrid", "all-tiles", "all-remainder",
                                   "empty-rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# one width for each instantiation (n-tile counts 1, 2, 4, 5, 6, 8, 12, 16:
# F = 4, 16, 32, 40, 48, 64, 96, 128), several feature tiles (200, 256,
# 768) and rows that take the element-by-element staging (13; 36 on bf16)
@pytest.mark.parametrize("f", [4, 8, 13, 16, 32, 36, 40, 48, 64, 96, 128,
                               200, 256, 768])
def test_fused_kernel_matches_plain(cuda, shape, dtype, f):
    ei, w, n, mbe = operator_shape(shape)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    mat = bcsr.BCSRMatrix.from_graph(g, dtype=dtype, min_block_edges=mbe)
    for half in (mat.fwd, mat.bwd):
        x = torch.randn(half.num_cols, f, device=cuda).to(dtype)
        before = bcsr.hybrid_spmm.launches
        out = bcsr.hybrid_spmm(half, x)
        ref = bcsr.hybrid_spmm_plain(half, x)
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(ref.abs().max())))
        assert bcsr.hybrid_spmm.launches == before + 1


def remainder_case(name, seed=6):
    """(edge_index, weights, n, min_block_edges) of the remainder cases: a
    remainder-only operator of several hundred tasks, a row of 20,000 edges
    beside a banded graph, and a remainder-only operator that is given x
    rows off the 16-byte grid (``ragged``)."""
    if name == "hub":
        rng = np.random.default_rng(seed)
        ei, w = banded(1500, 12000, seed=seed)
        hub_s = rng.integers(0, 1500, 20000)
        ei = np.concatenate([ei, np.stack([hub_s, np.full_like(hub_s, 700)])],
                            1)
        w = np.concatenate([w, rng.uniform(0.1, 1.0, 20000).astype(
            np.float32)])
        return ei, w, 1500, 10**6
    ei, w = banded(8192, 200000, seed=seed, band=300)
    return ei, w, 8192, 10**6


@pytest.mark.parametrize("case", ["remainder-large", "hub", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 8, 14, 64, 96, 200])
def test_fused_kernel_remainder_cases(cuda, case, dtype, f):
    """The fused kernel's remainder (all consumer threads, remainder-only
    tasks, one hub row, x rows a kernel cannot read 16 bytes at a time)
    against its plain version, one launch a call."""
    ei, w, n, mbe = remainder_case(case)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    mat = bcsr.BCSRMatrix.from_graph(g, dtype=dtype, min_block_edges=mbe)
    for half in (mat.fwd, mat.bwd):
        x = torch.randn(half.num_cols, f, device=cuda).to(dtype)
        if case == "ragged":
            buf = torch.empty(x.numel() + 8, dtype=dtype, device=cuda)
            x = buf[1:1 + x.numel()].view_as(x).copy_(x)
            assert x.data_ptr() % 16
        before = bcsr.hybrid_spmm.launches
        out = bcsr.hybrid_spmm(half, x)
        ref = bcsr.hybrid_spmm_plain(half, x)
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(ref.abs().max())))
        assert bcsr.hybrid_spmm.launches == before + 1


def test_one_fused_launch_per_bcsr_matmul(cuda):
    ei, w, n, mbe = operator_shape("hybrid")
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    mat = bcsr.BCSRMatrix.from_graph(g, dtype=torch.bfloat16,
                                     min_block_edges=mbe)
    x = torch.randn(3, n, 16, device=cuda, requires_grad=True)
    bcsr.reset_launch_counts()
    out = bcsr.bcsr_spmm(mat, x)            # one forward bcsr_matmul
    out.sum().backward()                    # one on the transposed half
    torch.cuda.synchronize()
    assert (bcsr.hybrid_spmm.launches, bcsr.tile_spmm.launches,
            bcsr.rem_scatter_.launches) == (2, 0, 0)


def _dcrnn_forward(inputs, dev):
    """DCRNNSeq(4, 8, K=2) over f32 BCSR diffusion operators on ``dev``."""
    g = Graph.from_edge_index(inputs["ei"], inputs["w"],
                              num_nodes=int(inputs["n"]), device=dev)
    ops = DiffusionOperators.from_graph(g, bcsr=True, device=dev)
    model = DCRNNSeq(4, 8, 2, device=dev,
                     generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        return model(torch.from_numpy(inputs["x"]).to(dev), ops).cpu()


def _cpu_reference(inputs, tmp_path):
    """:func:`_dcrnn_forward` on the CPU in a process of its own: one
    thread, MKL's conditional numerical reproducibility at COMPATIBLE.  In
    the test's own process the CPU result was seen to move with what the
    session ran before it, past the 1e-5 limit."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    np.savez(tmp_path / "inputs.npz", **inputs)
    code = ("import sys, numpy as np, torch; torch.set_num_threads(1); "
            "from test_torch_cuda import _dcrnn_forward; np.save(sys.argv[2],"
            " _dcrnn_forward(np.load(sys.argv[1]), 'cpu').numpy())")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent), str(here)]), OMP_NUM_THREADS="1",
        MKL_NUM_THREADS="1", MKL_CBWR="COMPATIBLE")
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "inputs.npz"),
                    str(tmp_path / "out.npy")], env=env, check=True,
                   timeout=300)
    return torch.from_numpy(np.load(tmp_path / "out.npy"))


def test_model_on_card_matches_cpu(cuda, tmp_path):
    n = 900
    ei, w = banded(n, 12000, seed=2)
    inputs = dict(ei=ei, w=w, n=np.int64(n), x=np.random.default_rng(3)
                  .normal(size=(2, 3, n, 4)).astype(np.float32))
    want = _cpu_reference(inputs, tmp_path)
    got = _dcrnn_forward(inputs, cuda)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [14, 1])
def test_fused_kernel_on_the_chebyshev_operator(cuda, dtype, f):
    """The snapshot pipeline's ragged widths (F=14: 28-byte bf16 rows;
    F=1: the power iteration's single column) over an operator with
    negative weights and cancelling +1/−1 self-loop entries."""
    ei, w, n, mbe = operator_shape("hybrid")
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    mat = prenormalize_cheb(g, bcsr=True, dtype=dtype,
                            min_block_edges=mbe).op
    for half in (mat.fwd, mat.bwd):
        assert half.nnzb and half.num_rem
        x = torch.randn(half.num_cols, f, device=cuda).to(dtype)
        before = bcsr.hybrid_spmm.launches
        out = bcsr.hybrid_spmm(half, x)
        ref = bcsr.hybrid_spmm_plain(half, x)
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(ref.abs().max())))
        assert bcsr.hybrid_spmm.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [16, 32])
def test_fused_kernel_on_the_gcn_operator(cuda, dtype, f):
    """The GCN paths' widths over a GCN-normalized operator: positive
    weights and a dense self-loop diagonal."""
    ei, w, n, mbe = operator_shape("hybrid")
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    mat = prenormalize_gcn(g, bcsr=True, dtype=dtype, min_block_edges=mbe)
    for half in (mat.fwd, mat.bwd):
        assert half.nnzb and half.num_rem
        x = torch.randn(half.num_cols, f, device=cuda).to(dtype)
        before = bcsr.hybrid_spmm.launches
        out = bcsr.hybrid_spmm(half, x)
        ref = bcsr.hybrid_spmm_plain(half, x)
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(ref.abs().max())))
        assert bcsr.hybrid_spmm.launches == before + 1


def test_tgcn_over_a_prepared_gcn_operator(cuda):
    """TGCN's GCNConvs normalize; over a PreparedGraph ``gcn_norm`` hands
    them the prebuilt BCSR operator: three fused launches a step, the raw
    graph never normalized."""
    n, f = 5000, 8
    ei, w = banded(n, 100_000, seed=12)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    prepared = prepare_graph(g, kinds=("gcn",), bcsr=True,
                             dtype=torch.bfloat16)
    seg = prepare_graph(g, kinds=("gcn",), bcsr=False)
    cell = TGCN(f, 16, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda)
    h = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)).to(
        cuda)
    bcsr.reset_launch_counts()
    got = cell(x, prepared, h)
    assert bcsr.hybrid_spmm.launches == 3
    got.sum().backward()
    torch.cuda.synchronize()
    assert (bcsr.hybrid_spmm.launches, bcsr.tile_spmm.launches,
            bcsr.rem_scatter_.launches) == (6, 0, 0)
    assert not getattr(g, "_op_cache", {})
    with torch.no_grad(), config_override(spmm_backend="segment"):
        want = cell(x, seg, h)
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("variant", ["O", "H"])
def test_evolvegcn_seq_over_stack_bcsr_gcn(cuda, variant):
    n, t, f = 1200, 3, 16
    graphs = []
    for i in range(t):
        ei, w = banded(n, 15000 + 2000 * i, seed=20 + i)
        graphs.append(Graph.from_edge_index(ei, w, num_nodes=n, device=cuda))
    stacked = stack_bcsr_gcn(graphs, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    if variant == "O":
        model = EvolveGCNOSeq(f, normalize=False, generator=gen)
        ref = EvolveGCNOSeq(f)
    else:
        model = EvolveGCNHSeq(n, f, normalize=False, generator=gen)
        ref = EvolveGCNHSeq(n, f)
    ref.load_state_dict(model.state_dict())
    xs = torch.from_numpy(np.random.default_rng(21).normal(
        size=(t, n, f)).astype(np.float32)).to(cuda)
    bcsr.reset_launch_counts()
    out = model(xs, stacked)
    assert bcsr.hybrid_spmm.launches == t
    (out ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (bcsr.hybrid_spmm.launches, bcsr.tile_spmm.launches,
            bcsr.rem_scatter_.launches) == (2 * t, 0, 0)
    with torch.no_grad(), config_override(spmm_backend="segment"):
        want = ref(xs, stack_graphs(graphs))
    # bf16 tiles and bf16-cast X·W against the f32 segment path
    torch.testing.assert_close(out.detach(), want, rtol=0,
                               atol=2e-2 * float(want.abs().max()))
    with pytest.raises(ValueError, match="normalize=False"):
        ref(xs, stacked)


def test_one_fused_launch_per_step_of_a_stacked_operator(cuda):
    rng = np.random.default_rng(5)
    n, t, f = 1200, 3, 32
    graphs = []
    for i in range(t):
        ei, w = banded(n, 15000 + 2000 * i, seed=10 + i)
        graphs.append(Graph.from_edge_index(ei, w / 20.0, num_nodes=n,
                                            device=cuda))
    stacked = stack_bcsr([bcsr.BCSRMatrix.from_graph(
        g, dtype=torch.bfloat16) for g in graphs])
    h0 = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(
        cuda).requires_grad_()
    bcsr.reset_launch_counts()
    h = h0
    for step, (mat_t, g) in enumerate(zip(stacked, graphs)):
        out = bcsr.bcsr_spmm(mat_t, h)
        assert bcsr.hybrid_spmm.launches == step + 1
        # bf16 tiles and bf16-cast activations against the f32 segment
        # path: 1e-2 of the step's largest value (the values shrink as the
        # sequence goes on)
        want = spmm_segment(g, h)
        torch.testing.assert_close(out, want, rtol=0,
                                   atol=1e-2 * float(want.abs().max()))
        h = torch.tanh(out)
    h.sum().backward()
    torch.cuda.synchronize()
    assert (bcsr.hybrid_spmm.launches, bcsr.tile_spmm.launches,
            bcsr.rem_scatter_.launches) == (2 * t, 0, 0)
    assert torch.isfinite(h0.grad).all()


def test_gconv_gru_over_bcsr_matches_the_segment_path(cuda):
    n, f = 5000, 14
    ei, w = banded(n, 100_000, seed=6)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    op = prenormalize_cheb(g, bcsr=True, dtype=torch.bfloat16)
    seg = Prenormalized(host_cheb_norm(g))
    cell = GConvGRU(f, 32, 2, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda)
    h = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32)).to(
        cuda)
    bcsr.reset_launch_counts()
    with torch.no_grad():
        got = cell(x, op, h)
        assert bcsr.hybrid_spmm.launches == 3       # bx, bh, bhr
        with config_override(spmm_backend="segment"):
            want = cell(x, seg, h)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)


def test_snapshot_trainer_launches_with_and_without_remat(cuda):
    n, f, t = 2000, 6, 3
    ei, w = banded(n, 30_000, seed=8)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    op = prenormalize_cheb(g, bcsr=True, dtype=torch.bfloat16)
    rng = np.random.default_rng(9)
    sig = StackedSignal.from_arrays(rng.normal(size=(t, n, f)),
                                    rng.normal(size=(t, n)), ei, w)
    for remat, want in ((False, 5 * t - 1), (True, 8 * t - 1)):
        cell = GConvGRU(f, 8, 2, generator=torch.Generator().manual_seed(0))

        def loss_and_state(carry, x, y, graph):
            h = cell(x, op, carry)
            return mse(h.sum(-1), y), h

        trainer = SnapshotTrainer(cell, loss_and_state, remat=remat)
        bcsr.reset_launch_counts()
        loss = trainer.train_epoch(sig, None)
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        assert bcsr.hybrid_spmm.launches == want


def test_lambda_max_through_the_kernel_matches_the_segment_path(cuda):
    """The Laplacian inside the power iteration is derived anew on every
    call (a transient graph): above the dense threshold its aggregations
    take the segment path, build no operator and launch no kernel; the
    same Laplacian as a caller's own graph goes through the fused kernel
    (f32 tiles, F=1) and gives the same eigenvalue."""
    from pytorch_geometric_temporal_tpu_torch.ops import laplacian, spmm

    n = 5000
    rng = np.random.default_rng(11)
    s = rng.integers(0, n, size=40_000)
    r = np.clip(s + rng.integers(1, 30, size=40_000), 0, n - 1)
    keep = s != r
    ei = np.stack([np.concatenate([s[keep], r[keep]]),
                   np.concatenate([r[keep], s[keep]])])
    g = Graph.from_edge_index(ei, num_nodes=n, device=cuda)
    bcsr.reset_launch_counts()
    got = lambda_max(g, iters=16)
    assert bcsr.hybrid_spmm.launches == 0
    with config_override(spmm_backend="segment"):
        want = lambda_max(g, iters=16)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    lap = laplacian(g.remove_self_loops(), "sym")
    v = torch.full((n, 1), n ** -0.5, device=cuda)
    for _ in range(16):
        v = spmm(lap, v)
        v = v / torch.linalg.norm(v)
    assert bcsr.hybrid_spmm.launches == 16
    through = (v * spmm(lap, v)).sum() / (v * v).sum()
    torch.testing.assert_close(through, want, rtol=1e-4, atol=0)


class _Builds:
    """Counts ``BCSRMatrix.from_graph`` calls while active."""

    def __init__(self, monkeypatch):
        self.calls = 0
        inner = bcsr.BCSRMatrix.from_graph

        def counted(*a, **kw):
            self.calls += 1
            return inner(*a, **kw)

        monkeypatch.setattr(bcsr.BCSRMatrix, "from_graph",
                            staticmethod(counted))


def test_edge_mode_astgcn_tiles_the_reversed_lhat_once(cuda, monkeypatch):
    """Edge-mode ASTGCN("sym", K=3) above the dense threshold: one operator
    build in the first forward and none after, (K−2) fused launches per
    block forward and as many backward, the same output as the segment
    path; ASTGCN(None) and MSTGCN build nothing and launch nothing."""
    builds = _Builds(monkeypatch)
    n = 5000
    ei, w = banded(n, 60_000, seed=12)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    x = torch.randn(2, n, 2, 6,
                    generator=torch.Generator().manual_seed(0)).to(cuda)
    cfg = dict(nb_block=2, in_channels=2, K=3, nb_chev_filter=8,
               nb_time_filter=8, time_strides=1, num_for_predict=3,
               len_input=6, num_of_vertices=n, attention_mode="edge")
    gen = torch.Generator().manual_seed(0)
    model = ASTGCN(**cfg, normalization="sym", generator=gen)
    bcsr.reset_launch_counts()
    out = model(x, g)
    assert (builds.calls, bcsr.hybrid_spmm.launches) == (1, 2)
    out.square().sum().backward()
    assert (builds.calls, bcsr.hybrid_spmm.launches) == (1, 4)
    model(x, g)
    assert (builds.calls, bcsr.hybrid_spmm.launches) == (1, 6)
    assert (bcsr.tile_spmm.launches, bcsr.rem_scatter_.launches) == (0, 0)
    with config_override(spmm_backend="segment"):
        want = model(x, g)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    bcsr.reset_launch_counts()
    with torch.no_grad():
        ASTGCN(**cfg, normalization=None, generator=gen)(x, g)
        MSTGCN(2, 2, 3, 8, 8, 1, 3, 6, generator=gen)(x, g)
    assert (builds.calls, bcsr.hybrid_spmm.launches) == (1, 0)


# chip_smoke.py's phase 14 limits for edge-mode ASTGCN against the segment
# path: the forward's largest absolute error; every parameter gradient's
# largest error over its largest entry, and its error's 2-norm over its
# 2-norm (the spatial attention's scalar bias sums ~E terms that nearly
# cancel, added by atomics in an order that changes from run to run)
EDGE_TOLS = (1e-4, 1e-2, 1e-2)


def test_astgcn_configuration_trains_a_step_at_reduced_n(cuda, monkeypatch):
    """The benchmark's ASTGCN configuration (perfbench/configs/
    astgcn-guo2019-pems.json: 2 blocks, K=3, 64 and 64 filters, 12 -> 12,
    edge mode, "sym", Glorot temporal-attention vectors) at N = 5,000 through ``BatchTrainer``'s eager step:
    one operator build and 4 fused launches (a hop past T_1 a block,
    forward and gradient), hop 1's calls with no message formed and its
    kernel's 2 + 2 launches (``csrc/weighted_hop.cu``, a block forward
    and backward), the block tail's 2 + 2 (``csrc/block_tail.cu``) with
    nothing copied, and the bcsr path against the segment path within
    ``EDGE_TOLS``."""
    import json
    from pathlib import Path

    from pytorch_geometric_temporal_tpu_torch import _counters
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer

    root = Path(__file__).resolve().parent.parent
    m = json.loads((root / "perfbench" / "configs"
                    / "astgcn-guo2019-pems.json").read_text())["model"]
    n, b, t = 5000, 2, int(m["len_input"])
    ei, w = banded(n, 30_000, seed=21)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    model = ASTGCN(
        nb_block=m["nb_block"], in_channels=m["in_channels"], K=m["K"],
        nb_chev_filter=m["nb_chev_filter"],
        nb_time_filter=m["nb_time_filter"], time_strides=m["time_strides"],
        num_for_predict=m["num_for_predict"], len_input=t,
        num_of_vertices=n, normalization=m["normalization"],
        attention_mode=m["attention_mode"],
        temporal_vector_init=m["temporal_vector_init"],
        generator=torch.Generator().manual_seed(3))

    def forward(xb):
        return model(xb.permute(0, 2, 3, 1), g).transpose(1, 2)[..., None]

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(b, t, n, m["in_channels"], generator=gen).to(cuda)
    y = torch.randn(b, m["num_for_predict"], n, 1, generator=gen).to(cuda)
    trainer = BatchTrainer(model, forward, lr=1e-3, loss_fn=mse,
                           device=cuda, capture=False)
    builds = _Builds(monkeypatch)
    bcsr.reset_launch_counts()
    before = _counters.read()
    trainer.train_step(x, y)
    torch.cuda.synchronize()
    assert (builds.calls, bcsr.hybrid_spmm.launches) == (1, 4)
    counted = _counters.counted_since(before)
    # forward and backward a block; the kernel forms no message and reads
    # the gradient where it lies, and each block's T_0, whose rows have
    # gaps, is copied once into dense rows and saved for the backward
    assert counted["astgcn_hop1"] == (2 * m["nb_block"], 0)
    widths = m["in_channels"] + m["nb_time_filter"]
    assert counted["weighted_hop"] == (m["nb_block"], m["nb_block"],
                                       b * t * n * widths * 4)
    # the tail's kernel once a block each way, in the Chebyshev output's
    # layout: nothing copied
    assert counted["block_tail"] == (m["nb_block"], m["nb_block"], 0)

    def outputs_and_grads():
        out = forward(x)
        return out.detach(), torch.autograd.grad(mse(out, y),
                                                 list(model.parameters()))

    out, grads = outputs_and_grads()
    with config_override(spmm_backend="segment"):
        want, want_grads = outputs_and_grads()
    fwd_tol, grad_tol, l2_tol = EDGE_TOLS
    assert float((out - want).abs().max()) <= fwd_tol
    # a leaf whose gradient is 0 or round-off (a saturated sigmoid's) is
    # measured against the larger of its own scale and the median leaf's
    big = statistics.median(float(gs.abs().max()) for gs in want_grads)
    norm = statistics.median(float(torch.linalg.norm(gs))
                             for gs in want_grads)
    for (name, _), gb, gs in zip(model.named_parameters(), grads,
                                 want_grads):
        rel = float((gb - gs).abs().max()) / max(float(gs.abs().max()), big)
        l2 = float(torch.linalg.norm(gb - gs)) / max(
            float(torch.linalg.norm(gs)), norm)
        assert rel <= grad_tol and l2 <= l2_tol, (name, rel, l2)
    assert builds.calls == 1


# -- edge-mode ASTGCN's hop 1 as a kernel (csrc/weighted_hop.cu) -------------

def _hop_graph(n, cuda, hub=False, seed=31):
    """The reversed L̂ (sym) of a banded graph like the PeMS stand-in (6
    entries a sensor within ±8), or of a random directed graph with a hub
    row of n/2 entries each way."""
    from pytorch_geometric_temporal_tpu_torch.models.attention import astgcn

    rng = np.random.default_rng(seed)
    if hub:
        s = rng.integers(0, n, 6 * n)
        r = rng.integers(0, n, 6 * n)
        r[: n // 2] = 7
        s[n // 2:n] = 11
    else:
        s = np.repeat(np.arange(n), 6)
        r = np.clip(s + rng.integers(-8, 9, s.shape[0]), 0, n - 1)
    w = rng.uniform(0.3, 1.0, s.shape[0]).astype(np.float32)
    g = Graph.from_edge_index(np.stack([s, r]), w, num_nodes=n, device=cuda)
    return astgcn._reversed(astgcn._lhat_graph(g, "sym"))


def _t0_like(b, t, n, f, layout, gen, cuda):
    """A (B, T, N, F) input laid out as block 2's T_0 lies, (B, F, N, T)
    ("bfnt"), or as block 1's from contiguous windows ("contiguous")."""
    if layout == "bfnt":
        return torch.randn(b, f, n, t, generator=gen).to(cuda).permute(
            0, 3, 2, 1)
    return torch.randn(b, t, n, f, generator=gen).to(cuda)


def _hop_plain(wh, rev, x, w, g):
    """(out, g_x, g_w) of the plain version."""
    args = (rev.senders, rev.receivers)
    return (wh.plain_forward(x, w, *args, rev.num_nodes)[0],
            *wh.plain_backward(g, x, w, *args, True, True)[:2])


def _hop_both(wh, rev, x, w, g):
    """(out, g_x, g_w) of the kernel and of the plain version, and the
    same sums over |terms| (the plain version on |x|, |w|, |g|)."""
    by_r, by_s = wh.hop_csrs(rev)
    out = wh.weighted_hop_forward(x, w, by_r, rev.num_nodes)
    gx, gw = wh.weighted_hop_backward(g, x, w, by_s, True, True)
    return ((out, gx, gw), _hop_plain(wh, rev, x, w, g),
            _hop_plain(wh, rev, x.abs(), w.abs(), g.abs()))


def _within_sum_order(got, want, mag, terms):
    """Two f32 sums of the same ``terms`` products in other orders differ
    by at most 2·terms·2⁻²⁴ of the sum of the products' magnitudes (each
    recursive sum errs by at most (terms − 1)·u of it)."""
    bound = 2 * terms * 2.0 ** -24 * mag
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("layout", ["bfnt", "contiguous"])
@pytest.mark.parametrize("f", [2, 64])
def test_weighted_hop_matches_plain_at_the_cells_shapes(cuda, f, layout):
    """B = 32, N = 11,160, T = 12: block 1 (F = 2, P = 24) and block 2
    (F = 64, P = 768), x laid out as either block's T_0, (B, F, N, T) and
    contiguous, copied into dense rows by each call (counted); g in the
    layout the consumers give, rows of an (N, B, T, F) buffer, read where
    it lies.  Each output within the bound of two sum orders of its terms:
    a row's entries for out and g_x, its P values for g_w."""
    from pytorch_geometric_temporal_tpu_torch.ops import weighted_hop as wh

    b, t, n = 32, 12, 11_160
    rev = _hop_graph(n, cuda)
    gen = torch.Generator().manual_seed(0)
    x = _t0_like(b, t, n, f, layout, gen, cuda)
    w = torch.randn(b, rev.senders.shape[0], generator=gen).to(cuda)
    g = torch.randn(n, b, t, f, generator=gen).to(cuda).permute(1, 2, 0, 3)
    before = wh.weighted_hop_counts()
    got, want, mags = _hop_both(wh, rev, x, w, g)
    torch.cuda.synchronize()
    counts = wh.weighted_hop_counts()
    assert tuple(a - c for a, c in zip(counts, before)) == (
        1, 1, 2 * x.numel() * 4)
    deg = int(max(k.ptr.diff().max() for k in wh.hop_csrs(rev)))
    assert got[0].permute(2, 0, 1, 3).is_contiguous()
    assert got[0].shape == (b, t, n, f)
    for a, e, m, terms in zip(got, want, mags, (deg, deg, t * f)):
        assert a.shape == e.shape
        _within_sum_order(a, e, m, terms)


def test_weighted_hop_on_a_hub_row_and_bits(cuda):
    """A random directed graph with a hub row of 2,500 entries, P = 768
    and P = 25 off the 16-byte grid (F = 5, T = 5: single values), against
    the plain version within the sum-order bound; two runs of each
    kernel give the same bits (no atomics)."""
    from pytorch_geometric_temporal_tpu_torch.ops import weighted_hop as wh

    n = 5000
    rev = _hop_graph(n, cuda, hub=True)
    by_r, by_s = wh.hop_csrs(rev)
    deg = int(max(by_r.ptr.diff().max(), by_s.ptr.diff().max()))
    assert deg >= n // 2
    gen = torch.Generator().manual_seed(1)
    for b, t, f in ((4, 12, 64), (3, 5, 5)):
        x = _t0_like(b, t, n, f, "bfnt", gen, cuda)
        w = torch.randn(b, rev.senders.shape[0], generator=gen).to(cuda)
        g = torch.randn(n, b, t, f, generator=gen).to(cuda).permute(
            1, 2, 0, 3)
        got, want, mags = _hop_both(wh, rev, x, w, g)
        for a, e, m, terms in zip(got, want, mags, (deg, deg, t * f)):
            _within_sum_order(a, e, m, terms)
        again = (wh.weighted_hop_forward(x, w, by_r, n),
                 *wh.weighted_hop_backward(g, x, w, by_s, True, True))
        for a, c in zip(got, again):
            assert torch.equal(a, c)


def test_weighted_hop_through_autograd_counts_and_names(cuda):
    """``_weighted_hop`` on the card: one launch forward and one backward,
    hop 1's calls with 0 bytes of messages, each output skipped where
    autograd needs none, a non-f32 input refused, and the kernels' names
    (``weighted_hop_*``) apart from the aggregation kernels that
    ``spmm_ms_per_step`` reads."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.metrics import _common
    from pytorch_geometric_temporal_tpu_torch import _counters
    from pytorch_geometric_temporal_tpu_torch.models.attention import astgcn
    from pytorch_geometric_temporal_tpu_torch.ops import weighted_hop as wh

    n, b, t, f = 3000, 2, 12, 8
    rev = _hop_graph(n, cuda)
    gen = torch.Generator().manual_seed(2)
    x = _t0_like(b, t, n, f, "bfnt", gen, cuda).requires_grad_(True)
    w = torch.randn(b, rev.senders.shape[0], generator=gen).to(
        cuda).requires_grad_(True)
    before = _counters.read()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = astgcn._weighted_hop(rev, x, w)
        out.square().sum().backward()
        torch.cuda.synchronize()
    counted = _counters.counted_since(before)
    # x, laid out (B, F, N, T), copied once into dense rows and saved
    assert counted["weighted_hop"] == (1, 1, x.numel() * 4)
    assert counted["astgcn_hop1"] == (2, 0)
    names = {e.name for e in prof.events() if "weighted_hop" in e.name}
    assert any("fwd" in k for k in names) and any("bwd" in k for k in names)
    assert not any(_common.SPMM_KERNELS.search(k) for k in names)
    want_x, want_w = x.grad.clone(), w.grad.clone()
    args = (rev.senders, rev.receivers)
    g, xd, wd = 2 * out.detach(), x.detach(), w.detach()
    plain = wh.plain_backward(g, xd, wd, *args, True, True)[:2]
    mags = wh.plain_backward(g.abs(), xd.abs(), wd.abs(), *args, True,
                             True)[:2]
    deg = int(wh.hop_csrs(rev)[1].ptr.diff().max())
    for a, e, m, terms in zip((want_x, want_w), plain, mags, (deg, t * f)):
        _within_sum_order(a, e, m, terms)
    # x alone, then w alone, take a gradient
    gx, = torch.autograd.grad(astgcn._weighted_hop(rev, x, w.detach())
                              .square().sum(), [x])
    assert torch.equal(gx, want_x)
    gw, = torch.autograd.grad(astgcn._weighted_hop(rev, x.detach(), w)
                              .square().sum(), [w])
    assert torch.equal(gw, want_w)
    with pytest.raises(TypeError, match="f32"):
        astgcn._weighted_hop(rev, x.detach().bfloat16(), w.detach())


# -- an ASTGCN block's tail as a kernel (csrc/block_tail.cu) -----------------

def _tail_case(cuda, b, t, n, c, seed=0, head_layout=True):
    """``pre`` (B·T·N, C), the channel vectors and a gradient g (B, T, N,
    C): laid out as ASTGCN's head gives it (each (b, n)'s T·C values
    together) or contiguous."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    pre = torch.randn(b * t * n, c, device=cuda, generator=gen)
    vecs = [0.3 * torch.randn(c, device=cuda, generator=gen)
            for _ in range(4)]
    vecs[2] = vecs[2] + 1.0     # gamma
    if head_layout:
        g = torch.randn(b, n, t, c, device=cuda, generator=gen).permute(
            0, 2, 1, 3)
    else:
        g = torch.randn(b, t, n, c, device=cuda, generator=gen)
    return pre, vecs, g


def _tail_both(bt, pre, vecs, g, eps=1e-6):
    """(y, stats, g_pre, sums) of the kernel and of the plain version."""
    b_t, b_r, gamma, beta = vecs
    y, stats = bt.block_tail_forward(pre, b_t, b_r, gamma, beta, eps)
    g_pre, sums = bt.block_tail_backward(g, pre, stats, b_t, b_r, gamma,
                                         eps)
    py, pstats = bt.plain_forward(pre, b_t, b_r, gamma, beta, eps)
    pg, psums = bt.plain_backward(g, pre, pstats, b_t, b_r, gamma, eps)
    return (y, stats, g_pre, sums), (py, pstats, pg, psums)


@pytest.mark.parametrize("head_layout", [True, False])
def test_block_tail_matches_plain_at_the_cells_shapes(cuda, head_layout):
    """B = 32, T = 12, N = 11,160, C = 64 (the benchmark cell's block):
    the kernel against its plain version on the card, the gradient read
    where the head puts it and contiguous, with no copy.  Row values
    (y, g_pre, the statistics) differ by the two sides' sum orders over a
    row's 64 channels, 1e-5 of their scale; the three gradients summed
    over 4.28M rows by the bound of two sum orders whose longest chains
    are under 1,024 terms (``_within_sum_order``)."""
    from pytorch_geometric_temporal_tpu_torch.ops import block_tail as bt

    b, t, n, c = 32, 12, 11_160, 64
    pre, vecs, g = _tail_case(cuda, b, t, n, c, head_layout=head_layout)
    before = bt.block_tail_counts()
    got, want = _tail_both(bt, pre, vecs, g)
    torch.cuda.synchronize()
    assert tuple(a - w for a, w in zip(bt.block_tail_counts(), before)) == (
        1, 1, 0)
    for a, e in zip(got[:3], want[:3]):
        assert a.shape == e.shape and a.is_contiguous()
        assert float((a - e).abs().max()) <= 1e-5 * float(e.abs().max())
    b_t, b_r, gamma, _ = vecs
    a = pre + (b_t + b_r)
    xhat = (torch.relu(a) - want[1][:, :1]) * torch.rsqrt(
        want[1][:, 1:].clamp(min=0) + 1e-6)
    gr = g.reshape(-1, c)
    mags = torch.stack([(gr * xhat).abs().sum(0), gr.abs().sum(0),
                        want[2].abs().sum(0)])
    _within_sum_order(got[3], want[3], mags, 1024)


def test_block_tail_refuses_and_repeats_its_bits(cuda):
    """The kernel takes f32 rows of a multiple of 4 channels up to 128 on
    the 16-byte grid and refuses the rest; every width it takes (4 to
    128, one to 32 lanes a row) against the plain version, a gradient off
    the 16-byte grid copied (counted); two runs give the same bits; the
    profiler's names of its kernels (``block_tail_*``) are apart from the
    aggregation's and hop 1's, which ``spmm_ms_per_step`` and
    ``hop1_ms_per_step`` read."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.metrics import _common
    from pytorch_geometric_temporal_tpu_torch.ops import block_tail as bt

    pre, vecs, g = _tail_case(cuda, 2, 5, 37, 8)
    with pytest.raises(TypeError, match="f32"):
        bt.block_tail_forward(pre.double(), *[v.double() for v in vecs],
                              1e-6)
    for c in (6, 132):
        bad, bvecs, _ = _tail_case(cuda, 2, 5, 37, c)
        with pytest.raises(ValueError, match="multiple of 4"):
            bt.block_tail_forward(bad, *bvecs, 1e-6)
    with pytest.raises(ValueError, match="no kernel"):
        bt.block_tail_forward(pre.cpu(), *[v.cpu() for v in vecs], 1e-6)
    off_grid = pre.new_zeros(pre.numel() + 1)[1:].view(pre.shape)
    with pytest.raises(ValueError, match="16-byte"):
        bt.block_tail_forward(off_grid, *vecs, 1e-6)
    for c in (4, 8, 12, 16, 32, 40, 64, 96, 128):
        pre, vecs, g = _tail_case(cuda, 2, 5, 37, c, seed=c)
        got, want = _tail_both(bt, pre, vecs, g)
        for a, e in zip(got, want):
            assert float((a - e).abs().max()) <= 1e-5 * float(
                e.abs().max()), c
    pre, vecs, g = _tail_case(cuda, 3, 4, 50, 64, seed=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        first, _ = _tail_both(bt, pre, vecs, g)
        torch.cuda.synchronize()
    again, _ = _tail_both(bt, pre, vecs, g)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    names = {e.name for e in prof.events() if "block_tail" in e.name}
    assert any("fwd" in k for k in names) and any("bwd" in k for k in names)
    hop = manifest_metric("hop1_ms_per_step")
    assert not any(_common.SPMM_KERNELS.search(k) or hop.KERNELS.search(k)
                   for k in names)
    assert all(manifest_metric("block_tail_ms_per_step").KERNELS.search(k)
               for k in names)
    # rows off the 16-byte grid: copied once, counted
    odd = torch.randn(3, 4, 50, 65, device=cuda)[..., 1:]
    before = bt.block_tail_counts()
    got, want = _tail_both(bt, pre, vecs, odd)
    assert bt.block_tail_counts()[2] - before[2] == odd.numel() * 4
    assert float((got[2] - want[2]).abs().max()) <= 1e-5 * float(
        want[2].abs().max())


def manifest_metric(name):
    from perfbench import manifest

    return manifest.load_metric(name)


def test_stconv_launches_over_a_prepared_chebyshev_operator(cuda):
    """Two stacked STConv blocks over ``prepare_graph(kinds=("cheb",),
    bcsr=True)``: the whole (B, T', N, C) tensor is one aggregation, so a
    block launches the fused kernel (K−1) times forward and (K−1) times
    backward whatever B and T' are, and normalizes nothing in the loop."""
    n, K = 3000, 3
    ei, w = banded(n, 50_000, seed=13)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    prepared = prepare_graph(g, kinds=("cheb",), bcsr=True,
                             dtype=torch.bfloat16)
    seg = prepare_graph(Graph.from_edge_index(ei, w, num_nodes=n,
                                              device=cuda),
                        kinds=("cheb",), bcsr=False)
    gen = torch.Generator().manual_seed(0)
    blocks = [STConv(n, 1, 8, 16, 3, K, generator=gen),
              STConv(n, 16, 8, 16, 3, K, generator=gen)]
    x = torch.randn(2, 12, n, 1, device=cuda)

    def run(graph):
        h = x
        for block in blocks:
            h = block(h, graph, train=True)
        return h

    bcsr.reset_launch_counts()
    out = run(prepared)
    assert out.shape == (2, 4, n, 16)
    assert bcsr.hybrid_spmm.launches == 2 * (K - 1)
    out.square().mean().backward()
    assert bcsr.hybrid_spmm.launches == 4 * (K - 1)
    assert (bcsr.tile_spmm.launches, bcsr.rem_scatter_.launches) == (0, 0)
    assert not any(k[0] == "cheb_norm" for k in getattr(g, "_op_cache", {}))
    with config_override(spmm_backend="segment"), torch.no_grad():
        want = run(seg)
    torch.testing.assert_close(out, want, rtol=0, atol=5e-2)


def test_device_windower_on_the_card_matches_host_windows(cuda):
    """Windows gathered on the card equal ``IndexDataset``'s host windows
    bit for bit (a float64 series narrowed to f32, as the JAX package
    does); bad starts raise on the host and leave the context usable."""
    from pytorch_geometric_temporal_tpu_torch.signal import (
        DeviceWindower, IndexDataset)

    data = np.random.default_rng(0).normal(size=(300, 50, 2))
    windower = DeviceWindower(data, 12, device=cuda)
    host = IndexDataset(np.arange(300 - 23), data.astype(np.float32), 12)
    starts = np.array([0, 7, 276, 100, 3])
    x, y = windower(starts)
    assert x.device.type == "cuda" and x.dtype == torch.float32
    for j, s in enumerate(starts):
        hx, hy = host[s]
        np.testing.assert_array_equal(x[j].cpu().numpy(), hx)
        np.testing.assert_array_equal(y[j].cpu().numpy(), hy)
    for bad in ([0, 277], [-1, 5]):
        with pytest.raises(ValueError):
            windower(np.array(bad))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(windower(np.array([1]))[0][0].cpu().numpy(),
                                  host[1][0])


def test_streaming_batches_without_a_sync_stay_distinct(cuda, tmp_path):
    """Consecutive ``StreamingWindower`` batches, held on the card with no
    synchronize between them, equal the device windower's: the reused host
    buffer never reaches a batch after it was handed out."""
    from pytorch_geometric_temporal_tpu_torch.signal import (
        DeviceWindower, StreamingWindower, iter_index_batches)

    data = np.random.default_rng(1).normal(size=(400, 300, 2)).astype(
        np.float32)
    np.save(tmp_path / "s.npy", data)
    stream = StreamingWindower(tmp_path / "s.npy", 12, device=cuda,
                               reopen_every=2)
    dev = DeviceWindower(data, 12, device=cuda)
    batches = list(iter_index_batches(np.arange(400 - 23), 32))
    held = [stream(b) for b in batches]
    want = [dev(b) for b in batches]
    torch.cuda.synchronize()
    for (x, y), (wx, wy) in zip(held, want):
        assert torch.equal(x, wx) and torch.equal(y, wy)


def test_batch_trainer_over_index_loader_launches_on_a_raw_graph(
        cuda, monkeypatch):
    """``BatchTrainer.fit`` over ``make_index_loaders`` with a raw Graph
    above the dense threshold: ``spmm`` tiles each diffusion direction
    once (f32 tiles, the activations' type), then every hop is one fused
    launch — per train batch 2·(2T(K−1) + 2T(K−1) − (K−1)), per eval batch
    2·2T(K−1) — and the losses are finite."""
    from pytorch_geometric_temporal_tpu_torch.data._common import (
        make_index_loaders)
    from pytorch_geometric_temporal_tpu_torch.train import (
        BatchTrainer, ZScoreScaler)

    builds = _Builds(monkeypatch)
    n, lags, K = 5000, 4, 2
    ei, w = banded(n, 30_000, seed=14, band=8)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    data = np.random.default_rng(2).normal(size=(60, n, 2))
    train, val, _ = make_index_loaders(data, lags, 8, shuffle=True,
                                       device=cuda)
    model = DCRNNSeq(2, 2, K, generator=torch.Generator().manual_seed(0))
    scaler = ZScoreScaler(mean=torch.tensor([50.0, 0.5], device=cuda),
                          std=torch.tensor([10.0, 0.3], device=cuda))
    trainer = BatchTrainer(model, lambda x: model(x, g), scaler=scaler)
    curve = []
    bcsr.reset_launch_counts()
    trainer.fit(train, 2, val_loader=val,
                callback=lambda e, tl, vl: curve.append((tl, vl)))
    per_train = 2 * (2 * lags * (K - 1) * 2 - (K - 1))
    per_eval = 2 * 2 * lags * (K - 1)
    assert builds.calls == 2
    assert bcsr.hybrid_spmm.launches == 2 * (len(train) * per_train
                                             + len(val) * per_eval)
    assert (bcsr.tile_spmm.launches, bcsr.rem_scatter_.launches) == (0, 0)
    assert np.isfinite(curve).all()


def _dcrnn_loss(model, ops):
    """``loss_fn(params, x, y)`` of DCRNNSeq over ``ops``: the MSE, in f32,
    of the predictions in the compute dtype; records their dtypes."""
    dtypes = []

    def loss_fn(params, x, y):
        pred = torch.func.functional_call(model, params, (x, ops))
        dtypes.append(pred.dtype)
        return (pred.float() - y.float()).square().mean()

    return loss_fn, dtypes


def test_bf16_mixed_precision_dcrnnseq_launches(cuda):
    """``make_mixed_precision_step(bf16_policy)`` on DCRNNSeq over bf16
    diffusion operators: bf16 predictions, f32 master parameters, one
    fused launch per aggregation (2·(2T(K−1) + 2T(K−1) − (K−1)) a step),
    none of K1/K2, a falling loss."""
    from pytorch_geometric_temporal_tpu_torch.train import (
        TrainState, bf16_policy, make_mixed_precision_step)

    n, T, K, F, C = 5000, 3, 2, 4, 8
    ei, w = banded(n, 60_000, seed=15)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    ops = DiffusionOperators.from_graph(g, bcsr=True, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, T, n, F, generator=gen).to(cuda)
    y = torch.randn(1, T, n, C, generator=gen).to(cuda)
    model = DCRNNSeq(F, C, K, generator=gen)
    loss_fn, dtypes = _dcrnn_loss(model, ops)
    state = TrainState.create(model, lambda p: torch.optim.Adam(p, lr=1e-2))
    step = make_mixed_precision_step(loss_fn, policy=bf16_policy)
    bcsr.reset_launch_counts()
    losses = [float(step(state, x, y)[1]) for _ in range(4)]
    per_step = 2 * (2 * T * (K - 1) * 2 - (K - 1))
    assert bcsr.hybrid_spmm.launches == 4 * per_step
    assert (bcsr.tile_spmm.launches, bcsr.rem_scatter_.launches) == (0, 0)
    assert set(dtypes) == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert int(state.step) == 4


def test_f16_overflow_step_is_skipped_on_the_card(cuda):
    """``f16_policy`` with a dynamic loss scale: a batch that overflows f16
    leaves the parameters, both Adam moments and the step counts bit for
    bit as they were and halves the scale; two clean steps double it."""
    from pytorch_geometric_temporal_tpu_torch.train import (
        DynamicLossScale, TrainState, f16_policy, make_mixed_precision_step)

    n, T, K, F, C = 5000, 2, 2, 4, 8
    ei, w = banded(n, 60_000, seed=16)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    ops = DiffusionOperators.from_graph(g, bcsr=True, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, T, n, F, generator=gen).to(cuda)
    y = torch.randn(1, T, n, C, generator=gen).to(cuda)
    model = DCRNNSeq(F, C, K, generator=gen)
    loss_fn, dtypes = _dcrnn_loss(model, ops)
    state = TrainState.create(model, lambda p: torch.optim.Adam(p, lr=1e-2))
    scale = DynamicLossScale(scale=torch.tensor(256.0, device=cuda),
                             steps_since_growth=torch.tensor(
                                 0, dtype=torch.int32, device=cuda),
                             growth_interval=2)
    step = make_mixed_precision_step(loss_fn, policy=f16_policy,
                                     dynamic_scale=True)
    state, scale, _ = step(state, scale, x, y)        # moments exist now
    before = state.snapshot()
    state, scale, loss = step(state, scale, x * 1e9, y)
    after = state.snapshot()
    assert not torch.isfinite(loss)
    assert float(scale.scale) == 128.0
    assert int(after["step"]) == int(before["step"])
    for name, p in before["params"].items():
        assert torch.equal(after["params"][name], p), name
    for i, moments in before["opt_state"]["state"].items():
        for key, v in moments.items():
            assert torch.equal(after["opt_state"]["state"][i][key], v), key
    for _ in range(2):
        state, scale, loss = step(state, scale, x, y)
        assert torch.isfinite(loss)
    assert float(scale.scale) == 256.0 and int(state.step) == 3
    assert set(dtypes) == {torch.float16}


def test_checkpoint_manager_copies_before_the_next_step(cuda, tmp_path):
    """``CheckpointManager.save`` returns with the state on the host: the
    optimizer steps that follow at once (in place, on the card) do not
    reach the checkpoint."""
    from pytorch_geometric_temporal_tpu_torch.train import (
        CheckpointManager, TrainState, apply_gradients)

    gen = torch.Generator().manual_seed(0)
    module = torch.nn.Linear(512, 512).to(cuda)
    state = TrainState.create(module, lambda p: torch.optim.Adam(p, 1e-2))
    x = torch.randn(256, 512, generator=gen).to(cuda)

    def train_step():
        loss = module(x).square().mean()
        apply_gradients(state, torch.autograd.grad(
            loss, list(module.parameters())))

    train_step()
    with CheckpointManager(str(tmp_path), max_to_keep=2) as mgr:
        want = {k: v.detach().cpu().clone()
                for k, v in module.state_dict().items()}
        moments = {k: v.cpu().clone() for k, v in
                   state.opt_state.state[module.weight].items()}
        assert mgr.save(state.step, state)
        for _ in range(5):
            train_step()
        restored = mgr.restore(step=1)
    for k, v in want.items():
        assert torch.equal(restored["params"][k], v), k
    for k, v in moments.items():
        assert torch.equal(restored["opt_state"]["state"][0][k], v), k
    assert not torch.equal(module.weight.detach().cpu(), want["weight"])


def test_heterogclstm_on_the_card_matches_the_cpu(cuda):
    """HeteroGCLSTM above the dense threshold (bipartite SAGEConv on the
    segment path, no fused launch): outputs against the port on the CPU
    within 1e-4 of their scale, parameter gradients within 1e-2 of each
    gradient's largest entry (atomics on the card)."""
    from pytorch_geometric_temporal_tpu_torch.models import HeteroGCLSTM

    n = {"a": 6000, "b": 4500}
    f = {"a": 5, "b": 3}
    meta = (["a", "b"], [("a", "to", "b"), ("b", "to", "a")])
    rng = np.random.default_rng(17)
    graphs = {}
    for src, rel, dst in meta[1]:
        e = 50_000
        s = rng.integers(0, n[src], e)
        r = np.clip(s * n[dst] // n[src] + rng.integers(-30, 31, e), 0,
                    n[dst] - 1)
        graphs[(src, rel, dst)] = (np.stack([s, r]),
                                   rng.uniform(0.1, 1, e).astype(np.float32))
    x = {k: rng.normal(size=(n[k], f[k])).astype(np.float32) for k in n}
    results = []
    for device in ("cpu", cuda):
        model = HeteroGCLSTM(f, 16, meta, device=device,
                             generator=torch.Generator().manual_seed(0))
        gs = {k: Graph.from_edge_index(ei, w, num_nodes=n[k[2]],
                                       num_src=n[k[0]], device=device)
              for k, (ei, w) in graphs.items()}
        xs = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
        bcsr.reset_launch_counts()
        h, c = model(xs, gs)
        h, c = model(xs, gs, h, c)
        loss = sum(h[k].square().mean() + c[k].sin().mean() for k in h)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        assert bcsr.hybrid_spmm.launches == 0
        results.append(({k: v.detach().cpu() for k, v in h.items()},
                        [gr.cpu() for gr in grads]))
    (h_cpu, g_cpu), (h_gpu, g_gpu) = results
    for k in h_cpu:
        torch.testing.assert_close(h_gpu[k], h_cpu[k], rtol=0,
                                   atol=1e-4 * float(h_cpu[k].abs().max()))
    for got, want in zip(g_gpu, g_cpu):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-2 * float(want.abs().max()))


def test_device_memory_stats_on_the_card(cuda):
    from pytorch_geometric_temporal_tpu_torch.utils import device_memory_stats
    from pytorch_geometric_temporal_tpu_torch.utils.profiling import (
        device_time_per_iter)

    keep = torch.empty(1 << 20, device=cuda)
    stats = device_memory_stats()
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use",
                          "bytes_reserved", "bytes_limit"}
    assert (keep.numel() * 4 <= stats["bytes_in_use"]
            <= stats["peak_bytes_in_use"] <= stats["bytes_limit"])
    assert device_memory_stats(cuda) == stats
    assert device_memory_stats("cpu") == {}
    per = device_time_per_iter(lambda a: a * 0.5 + 1.0, keep, iters=200)
    assert 0 < per < 1e-3


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    """Two gloo ranks on the one card (``tests/_torch_parallel_ranks.py``
    with DEVICE=cuda): a data-parallel step of DCRNNSeq over a raw graph
    above the dense threshold, and a halo aggregation.  The kernels are
    built here first, so the ranks load the built library."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from pytorch_geometric_temporal_tpu_torch import csrc

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    csrc.load()
    tmp = tmp_path_factory.mktemp("card_ranks")
    rng = np.random.default_rng(21)
    arr = {}
    for name, n, e in (("gdp", 5000, 30_000), ("gd", 3001, 20_000)):
        ei, w = banded(n, e, seed=n, band=8)
        arr.update({f"{name}/ei": ei, f"{name}/w": w,
                    f"{name}/n": np.int64(n)})
    arr["dp/x"] = rng.normal(size=(4, 3, 5000, 2)).astype(np.float32)
    y = rng.normal(size=(4, 3, 5000, 2)).astype(np.float32)
    y[:2][rng.uniform(size=y[:2].shape) < 0.5] = 0.0   # rank 0's shard
    arr["dp/y_masked"] = y
    arr["x3"] = rng.normal(size=(3001, 3, 4)).astype(np.float32)
    model = DCRNNSeq(2, 2, 2, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    for name, p in model.named_parameters():
        arr[f"tree_dp/params/{name.replace('.', '/')}"] = (
            p.detach().numpy() + 0.05)
    np.savez(tmp / "inputs.npz", **arr)
    repo = Path(__file__).parent.parent
    subprocess.run([sys.executable, str(Path(__file__).parent
                                        / "_torch_parallel_ranks.py"),
                    str(tmp / "inputs.npz"), str(tmp), "2", "cuda"],
                   cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
                   check=True, timeout=600)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def test_dp_step_of_two_ranks_on_the_card(cuda, card_ranks):
    """Two ranks over gloo with CUDA tensors, masked MAE with rank 0's
    targets half zeros: the step's loss, the all-reduced gradient Adam is
    given (within 1e-4 of each leaf's largest entry: Adam's first update
    sees only the gradient's signs) and the Adam update equal the
    single-process step on the whole batch; 2·(2·2T(K−1) − (K−1)) fused
    launches a rank (T=3, K=2); over gloo the step runs eagerly."""
    for res in card_ranks:
        assert list(res["modules"]) == [""]
        assert int(res["dp/launches"]) == 22
        assert int(res["dp/captures"]) == 0     # gloo goes through the host
        np.testing.assert_allclose(float(res["dp/loss"]),
                                   float(res["dp/loss_ref"]), rtol=1e-5)
        names = [k.split("/", 2)[2] for k in res if k.startswith("dp/ref/")]
        assert names
        for name in names:
            want = res[f"dp/ref_grad/{name}"]
            np.testing.assert_allclose(
                res[f"dp/grad/{name}"], want, rtol=0,
                atol=1e-4 * float(np.abs(want).max()), err_msg=name)
            np.testing.assert_allclose(res[f"dp/param/{name}"],
                                       res[f"dp/ref/{name}"], rtol=0,
                                       atol=1e-5, err_msg=name)


def test_halo_aggregation_of_two_ranks_on_the_card(cuda, card_ranks):
    """Each rank's block of the halo exchange against the segment path on
    the whole graph; the bytes sent equal ``ici_bytes_per_step``."""
    for res in card_ranks:
        want = res["halo/want"]
        np.testing.assert_allclose(res["halo/out"], want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
        assert int(res["halo/bytes"]) == int(res["halo/formula"]) > 0


def scrambled_recovery_graph(cuda):
    """The reorder-recovery draw (``bench.py:bench_reorder_recovery``):
    20,000 nodes, 40 edges a node within ±96 under scrambled ids, weights
    normalized by the weighted in-degree."""
    n, e, band = 20_000, 800_000, 96
    rng = np.random.default_rng(2)
    s = rng.integers(0, n, size=e)
    r = np.clip(s + rng.integers(-band, band + 1, size=e), 0, n - 1)
    scram = rng.permutation(n)
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    d = np.bincount(r, weights=w, minlength=n).astype(np.float32)
    return Graph.from_edge_index(np.stack([scram[s], scram[r]]),
                                 w / np.maximum(d[r], 1e-6), num_nodes=n,
                                 device=cuda)


def test_reordered_operator_through_spmm_on_the_card(cuda, monkeypatch):
    """``spmm`` on a CUDA tensor builds the scrambled graph's operator
    with ``spmm_reorder="auto"``, keeps the RCM order, and launches the
    fused kernel once forward and once backward; output and x-gradient
    match the segment path."""
    from pytorch_geometric_temporal_tpu_torch.ops import spmm

    builds = _Builds(monkeypatch)
    g = scrambled_recovery_graph(cuda)
    x = torch.randn(g.num_nodes, 16, device=cuda, requires_grad=True)
    cot = torch.randn(g.num_nodes, 16, device=cuda)
    bcsr.reset_launch_counts()
    out = spmm(g, x)
    assert bcsr.hybrid_spmm.launches == 1
    (gx,) = torch.autograd.grad((out * cot).sum(), x)
    assert (bcsr.hybrid_spmm.launches, bcsr.tile_spmm.launches,
            bcsr.rem_scatter_.launches) == (2, 0, 0)
    assert builds.calls == 1
    mat = g._op_cache[("bcsr", "None", "auto")]
    assert mat.perm is not None and mat.iperm is not None
    xs = x.detach().requires_grad_()
    want = spmm_segment(g, xs)
    (want_gx,) = torch.autograd.grad((want * cot).sum(), xs)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    torch.testing.assert_close(gx, want_gx, rtol=0,
                               atol=1e-4 * float(want_gx.abs().max()))


def test_avwgcn_topk_on_the_card_matches_the_cpu(cuda):
    """AVWGCN(topk=8) at N=20,000 (``tests/test_learned_adjacency_large_n
    .py``'s configuration): forward and backward on the card, the kept
    columns and the outputs equal to the same module's on the CPU."""
    from pytorch_geometric_temporal_tpu_torch.models import AVWGCN
    from pytorch_geometric_temporal_tpu_torch.models.conv import (
        _topk_support)

    rng = np.random.default_rng(2)
    e_np = rng.normal(size=(20_000, 4)).astype(np.float32)
    x_np = rng.normal(size=(20_000, 3)).astype(np.float32)
    model = AVWGCN(3, 4, 2, 4, topk=8, device=cuda,
                   generator=torch.Generator().manual_seed(0))
    twin = AVWGCN(3, 4, 2, 4, topk=8, device="cpu")
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    e = torch.from_numpy(e_np).to(cuda).requires_grad_()
    out = model(torch.from_numpy(x_np).to(cuda), e)
    loss = (out ** 2).mean()
    loss.backward()
    assert torch.isfinite(loss)
    assert float(model.weights_pool.grad.abs().sum()) > 0
    assert float(e.grad.abs().sum()) > 0
    cols = _topk_support(e.detach(), 8)[0].cpu()
    assert torch.equal(cols, _topk_support(torch.from_numpy(e_np), 8)[0])
    with torch.no_grad():
        want = twin(torch.from_numpy(x_np), torch.from_numpy(e_np))
    torch.testing.assert_close(out.detach().cpu(), want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


# --- the trainers' steps captured as CUDA graphs and replayed -------------
# Captured against eager (capture=False) from the same parameters on the
# same batches.  Both build Adam with capturable=True and launch the same
# kernels on the same inputs; a difference can come only from a library
# picking another algorithm under capture.  Limits: 1e-5 relative on
# losses, 1e-5 absolute on parameters (an Adam step at lr=1e-2 moves each
# by up to 1e-2).

CAPTURE_LOSS_RTOL, CAPTURE_PARAM_ATOL = 1e-5, 1e-5


def _dcrnn_case(cuda, b=2, batches=5, n=5000, T=3, K=2, F=4, C=8):
    """DCRNNSeq over bf16 BCSR diffusion operators at N=5000 (above the
    dense threshold), seeded batches, and a maker of identical models."""
    ei, w = banded(n, 60_000, seed=16)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    ops = DiffusionOperators.from_graph(g, bcsr=True, dtype=torch.bfloat16)
    rng = np.random.default_rng(17)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda)

    data = [(draw(b, T, n, F), draw(b, T, n, C)) for _ in range(batches)]

    def make():
        return DCRNNSeq(F, C, K, generator=torch.Generator().manual_seed(0))

    return ops, data, make


def _assert_same_run(got, want, got_params, want_params):
    torch.testing.assert_close(got, want, rtol=CAPTURE_LOSS_RTOL, atol=0)
    for a, b in zip(got_params, want_params):
        torch.testing.assert_close(a, b, rtol=0, atol=CAPTURE_PARAM_ATOL)


def test_captured_dcrnnseq_steps_match_eager(cuda):
    """Five train steps and three eval steps of DCRNNSeq over bf16 BCSR
    operators, captured against capture=False: the first step runs eagerly
    in both (bit-equal loss), the second captures, the rest replay."""
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer

    ops, data, make = _dcrnn_case(cuda)
    runs = {}
    for capture in (False, True):
        model = make()
        tr = BatchTrainer(model, lambda x, m=model: m(x, ops), lr=1e-2,
                          capture=capture)
        assert tr.capture is capture
        assert tr.optimizer.param_groups[0]["capturable"] is True
        losses = torch.stack([tr.train_step(x, y) for x, y in data])
        evals = torch.stack([tr.eval_step(x, y) for x, y in data[:3]])
        runs[capture] = (losses, evals, list(model.parameters()), tr)
    (le, ee, pe, eager), (lc, ec, pc, captured) = runs[False], runs[True]
    assert (eager.captures, eager.replays) == (0, 0)
    assert (captured.captures, captured.replays) == (2, 4 + 2)
    assert torch.equal(lc[0], le[0]) and torch.equal(ec[0], ee[0])
    assert torch.isfinite(lc).all() and lc[-1] < lc[0]
    _assert_same_run(lc, le, pc, pe)
    _assert_same_run(ec, ee, [], [])


def test_a_new_batch_shape_or_layout_captures_anew(cuda):
    """Batches of 4, then 2 (a last partial batch), then 4 again, then
    window views (DeviceWindower's layout): one graph a shape and layout,
    reused when a signature comes back; each call returns a fresh loss;
    parameters as the eager run's."""
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer

    ops, data, make = _dcrnn_case(cuda, b=4, batches=1)
    x4, y4 = data[0]
    win = torch.cat([x4, torch.flip(x4, (1,))], 1)     # (4, 2T, n, F)
    xv = win[:, :x4.shape[1]]
    assert not xv.is_contiguous()
    seq = [(x4, y4)] * 3 + [(x4[:2], y4[:2])] * 3 + [(x4, y4)] + [(xv, y4)] * 2
    runs = {}
    for capture in (False, True):
        model = make()
        tr = BatchTrainer(model, lambda x, m=model: m(x, ops), lr=1e-2,
                          capture=capture)
        losses = [tr.train_step(x, y) for x, y in seq]
        runs[capture] = (torch.stack(losses), list(model.parameters()), tr,
                         losses)
    le, pe, _, _ = runs[False]
    lc, pc, tr, held = runs[True]
    assert (tr.captures, tr.replays) == (3, 2 + 2 + 1 + 1)
    assert len({t.data_ptr() for t in held}) == len(held)
    assert torch.equal(torch.stack(held), lc)
    _assert_same_run(lc, le, pc, pe)


def test_launch_counts_stay_exact_under_replay(cuda):
    """A capture counts launches that do not run; the trainer takes them
    back out and adds them at each replay: the counters stay kernels
    executed, 2·(2T(K−1)·2 − (K−1)) a train step, 2·2T(K−1) an eval step,
    none of K1/K2."""
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer

    T, K = 3, 2
    ops, data, make = _dcrnn_case(cuda, T=T, K=K)
    model = make()
    tr = BatchTrainer(model, lambda x: model(x, ops), lr=1e-2)
    per_train = 2 * (2 * T * (K - 1) * 2 - (K - 1))
    per_eval = 2 * 2 * T * (K - 1)
    bcsr.reset_launch_counts()
    for i, (x, y) in enumerate(data[:4]):
        tr.train_step(x, y)
        assert bcsr.hybrid_spmm.launches == (i + 1) * per_train
    for i, (x, y) in enumerate(data[:3]):
        tr.eval_step(x, y)
        assert bcsr.hybrid_spmm.launches == 4 * per_train + (i + 1) * per_eval
    assert tr.captures == 2
    assert (bcsr.tile_spmm.launches, bcsr.rem_scatter_.launches) == (0, 0)


def test_captured_snapshot_epoch_of_gconvgru_matches_eager(cuda):
    """SnapshotTrainer epochs of GConvGRU over a bf16 Chebyshev BCSR
    operator with the hidden state threaded: captured against eager, 5T−1
    launches an epoch, a second signal evaluated through its own graph."""
    n, f, t, epochs = 5000, 6, 3, 4
    ei, w = banded(n, 60_000, seed=18)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    op = prenormalize_cheb(g, bcsr=True, dtype=torch.bfloat16)
    rng = np.random.default_rng(19)
    sig = StackedSignal.from_arrays(rng.normal(size=(t, n, f)),
                                    rng.normal(size=(t, n)), ei, w)
    test = StackedSignal.from_arrays(rng.normal(size=(t, n, f)),
                                     rng.normal(size=(t, n)), ei, w)
    runs = {}
    for capture in (False, True):
        cell = GConvGRU(f, 8, 2, generator=torch.Generator().manual_seed(0))

        def loss_and_state(carry, x, y, graph, cell=cell):
            h = cell(x, op, carry)
            return mse(h.sum(-1), y), h

        tr = SnapshotTrainer(cell, loss_and_state, capture=capture)
        bcsr.reset_launch_counts()
        losses = torch.stack([tr.train_epoch(sig, None)
                              for _ in range(epochs)])
        assert bcsr.hybrid_spmm.launches == epochs * (5 * t - 1)
        evals = torch.stack([tr.evaluate(test, None) for _ in range(3)])
        runs[capture] = (losses, evals, list(cell.parameters()), tr)
    (le, ee, pe, _), (lc, ec, pc, tr) = runs[False], runs[True]
    assert (tr.captures, tr.replays) == (2, (epochs - 1) + 2)
    assert torch.equal(lc[0], le[0])
    _assert_same_run(lc, le, pc, pe)
    _assert_same_run(ec, ee, [], [])


def test_captured_epochs_over_the_signals_own_graph_match_eager(cuda):
    """GConvGRU aggregating over the graph the signal hands its step
    (``cell(x, graph, h)``) at N=5000: the Chebyshev operator is derived
    and tiled in the first (eager) epoch and kept with the signal's graph,
    so the capture finds it built; captured against eager, 5T−1 launches
    an epoch."""
    n, f, t, epochs = 5000, 6, 3, 4
    ei, w = banded(n, 60_000, seed=23)
    rng = np.random.default_rng(24)
    sig = StackedSignal.from_arrays(rng.normal(size=(t, n, f)),
                                    rng.normal(size=(t, n)), ei, w,
                                    device=cuda)
    runs = {}
    for capture in (False, True):
        cell = GConvGRU(f, 8, 2, generator=torch.Generator().manual_seed(0))

        def loss_and_state(carry, x, y, graph, cell=cell):
            h = cell(x, graph, carry)
            return mse(h.sum(-1), y), h

        tr = SnapshotTrainer(cell, loss_and_state, capture=capture)
        bcsr.reset_launch_counts()
        losses = torch.stack([tr.train_epoch(sig, None)
                              for _ in range(epochs)])
        assert bcsr.hybrid_spmm.launches == epochs * (5 * t - 1)
        runs[capture] = (losses, list(cell.parameters()), tr)
    (le, pe, _), (lc, pc, tr) = runs[False], runs[True]
    assert tr.captures == 1 and tr.replays == epochs - 1
    assert torch.equal(lc[0], le[0])
    _assert_same_run(lc, le, pc, pe)


def test_a_step_that_cannot_be_captured_raises(cuda):
    """A host read inside the step blocks the capture: the second call
    raises naming the line and capture=False, the launches the failed
    capture counted are taken back out, and the card stays usable: the same
    model then trains eagerly."""
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer

    ops, data, make = _dcrnn_case(cuda)
    model = make()

    def forward(x):
        out = model(x, ops)
        if float(out.abs().max()) > 1e30:     # a host read: blocks capture
            raise AssertionError("diverged")
        return out

    tr = BatchTrainer(model, forward, lr=1e-2)
    tr.train_step(*data[0])
    before = bcsr.launch_counts()
    with pytest.raises(RuntimeError, match="cannot be captured") as err:
        tr.train_step(*data[1])
    assert "capture=False" in str(err.value)
    assert "forward" in _chained_frames(err.value)
    assert bcsr.launch_counts() == before and tr.captures == 0
    eager = BatchTrainer(model, forward, lr=1e-2, capture=False)
    losses = [float(eager.train_step(x, y)) for x, y in data]
    assert np.isfinite(losses).all()


def _chained_frames(exc):
    """The names of the functions in this file on the tracebacks of the
    errors ``exc`` was raised from."""
    names, e = set(), exc.__cause__
    while e is not None:
        names |= {f.name for f in traceback.extract_tb(e.__traceback__)
                  if f.filename == __file__}
        e = e.__cause__ or e.__context__
    return names


def test_a_draw_from_a_steps_own_generator_cannot_be_captured(cuda):
    """A step that draws dropout masks from its own CUDA generator trains
    eagerly; captured, the second call raises from the draw."""
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer

    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)).to(cuda)

    def run(capture, steps):
        gen = torch.Generator(device=cuda).manual_seed(3)
        model = torch.nn.Linear(8, 8).to(cuda)

        def forward(xb):
            keep = torch.rand(xb.shape, device=cuda, generator=gen) < 0.5
            return model(xb) * keep / 0.5

        tr = BatchTrainer(model, forward, lr=1e-2, capture=capture)
        return torch.stack([tr.train_step(x, y) for _ in range(steps)])

    assert torch.isfinite(run(False, 3)).all()
    with pytest.raises(RuntimeError, match="cannot be captured") as err:
        run(True, 2)
    assert "forward" in _chained_frames(err.value)


def test_remat_epochs_capture_and_match_eager(cuda):
    """``remat=True`` (``torch.utils.checkpoint`` a snapshot) captures: the
    recomputation's RNG bookkeeping stays on the device, and the captured
    epochs give the eager epochs' losses and parameters, with 8T−1
    launches an epoch (the forward hops run again in the backward)."""
    n, f, t, epochs = 5000, 6, 3, 4
    ei, w = banded(n, 60_000, seed=21)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    op = prenormalize_cheb(g, bcsr=True, dtype=torch.bfloat16)
    rng = np.random.default_rng(22)
    sig = StackedSignal.from_arrays(rng.normal(size=(t, n, f)),
                                    rng.normal(size=(t, n)), ei, w)
    runs = {}
    for capture in (False, True):
        cell = GConvGRU(f, 8, 2, generator=torch.Generator().manual_seed(0))

        def loss_and_state(carry, x, y, graph, cell=cell):
            h = cell(x, op, carry)
            return mse(h.sum(-1), y), h

        tr = SnapshotTrainer(cell, loss_and_state, remat=True,
                             capture=capture)
        bcsr.reset_launch_counts()
        losses = torch.stack([tr.train_epoch(sig, None)
                              for _ in range(epochs)])
        assert bcsr.hybrid_spmm.launches == epochs * (8 * t - 1)
        runs[capture] = (losses, list(cell.parameters()), tr)
    (le, pe, _), (lc, pc, tr) = runs[False], runs[True]
    assert tr.captures == 1 and tr.replays == epochs - 1
    _assert_same_run(lc, le, pc, pe)


# ---------------------------------------------------------------------------
# The step builders captured: make_mixed_precision_step, make_dp_train_step
# ---------------------------------------------------------------------------


def _mixed_runs(cuda, policy, dynamic_scale, steps=6):
    """``steps`` steps of DCRNNSeq over bf16 operators through
    ``make_mixed_precision_step``, eager (capture=False) and captured,
    from the same parameters: (losses, parameters, step) each way."""
    from pytorch_geometric_temporal_tpu_torch.train import (
        DynamicLossScale, TrainState, make_mixed_precision_step)

    ops, data, make = _dcrnn_case(cuda)
    runs = {}
    for capture in (False, None):
        model = make()
        loss_fn, _ = _dcrnn_loss(model, ops)
        state = TrainState.create(model,
                                  lambda p: torch.optim.Adam(p, lr=1e-2))
        step = make_mixed_precision_step(loss_fn, policy=policy,
                                         dynamic_scale=dynamic_scale,
                                         capture=capture)
        scale = DynamicLossScale(
            scale=torch.tensor(256.0, device=cuda),
            steps_since_growth=torch.tensor(0, dtype=torch.int32,
                                            device=cuda))
        losses = []
        for i in range(steps):
            x, y = data[i % len(data)]
            if dynamic_scale:
                state, scale, loss = step(state, scale, x, y)
            else:
                state, loss = step(state, x, y)
            losses.append(loss)
        runs[capture] = (torch.stack(losses), list(model.parameters()),
                         step, state)
    return runs[False], runs[None]


@pytest.mark.parametrize("policy", ["bf16", "f16"])
def test_captured_mixed_precision_steps_match_eager(cuda, policy):
    """On a CUDA state ``make_mixed_precision_step`` captures by default:
    six steps (the first eager, the second captures, the rest replay)
    against ``capture=False`` from the same parameters, within the
    trainers' capture limits; the first loss bit-equal; Adam made
    capturable by ``TrainState.create``; one fused launch an aggregation
    under replay."""
    from pytorch_geometric_temporal_tpu_torch.train import (
        bf16_policy, f16_policy)

    bcsr.reset_launch_counts()
    (le, pe, se, ste), (lc, pc, sc, stc) = _mixed_runs(
        cuda, bf16_policy if policy == "bf16" else f16_policy,
        policy == "f16")
    per_step = 2 * (2 * 3 * (2 - 1) * 2 - (2 - 1))      # T=3, K=2
    assert bcsr.hybrid_spmm.launches == 2 * 6 * per_step
    assert (se.graphs.captures, se.graphs.replays) == (0, 0)
    assert (sc.graphs.captures, sc.graphs.replays) == (1, 5)
    assert stc.opt_state.param_groups[0]["capturable"] is True
    assert int(ste.step) == int(stc.step) == 6
    assert torch.equal(lc[0], le[0]) and torch.isfinite(lc).all()
    _assert_same_run(lc, le, pc, pe)


def test_captured_f16_step_skips_a_planted_overflow_without_a_sync(cuda):
    """The f16 step's skip is decided on the device: a planted overflow
    and two clean steps run as replays with every host sync an error
    (``torch.cuda.set_sync_debug_mode``); the overflow leaves parameters,
    Adam's moments and step counts and the state's step bit for bit as
    they were and halves the scale, the clean steps grow it back."""
    from pytorch_geometric_temporal_tpu_torch.train import (
        DynamicLossScale, TrainState, f16_policy, make_mixed_precision_step)

    ops, data, make = _dcrnn_case(cuda, b=1)
    x, y = data[0]
    model = make()
    loss_fn, _ = _dcrnn_loss(model, ops)
    state = TrainState.create(model, lambda p: torch.optim.Adam(p, lr=1e-2))
    scale = DynamicLossScale(scale=torch.tensor(256.0, device=cuda),
                             steps_since_growth=torch.tensor(
                                 0, dtype=torch.int32, device=cuda),
                             growth_interval=2)
    step = make_mixed_precision_step(loss_fn, policy=f16_policy,
                                     dynamic_scale=True)
    for _ in range(2):                      # eager, then the capture
        state, scale, _ = step(state, scale, x, y)
    assert float(scale.scale) == 512.0
    x_bad = x * 1e9
    torch.cuda.synchronize()
    before = state.snapshot()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, scale, bad = step(state, scale, x_bad, y)
        halved = scale.scale.clone()
        after = state.snapshot()
        for _ in range(2):
            state, scale, loss = step(state, scale, x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (step.graphs.captures, step.graphs.replays) == (1, 4)
    assert not torch.isfinite(bad) and torch.isfinite(loss)
    assert float(halved) == 256.0 and float(scale.scale) == 512.0
    assert int(after["step"]) == int(before["step"]) == 2
    assert int(state.step) == 4
    for name, p in before["params"].items():
        assert torch.equal(after["params"][name], p), name
    for i, moments in before["opt_state"]["state"].items():
        for key, v in moments.items():
            assert torch.equal(after["opt_state"]["state"][i][key], v), key


def test_a_non_capturable_optimizer_is_refused_by_a_captured_step(cuda):
    """``TrainState.create`` turns Adam's ``capturable`` on for CUDA
    parameters; an optimizer that already had state without it cannot be
    captured, and the step raises naming the option (``capture=False``
    runs it)."""
    from pytorch_geometric_temporal_tpu_torch.train import (
        TrainState, bf16_policy, make_mixed_precision_step)

    ops, data, make = _dcrnn_case(cuda, b=1, batches=1)
    model = make().to(cuda)
    assert TrainState.create(model, lambda p: torch.optim.Adam(p)) \
        .opt_state.param_groups[0]["capturable"] is True
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()                       # state made while not capturable
    state = TrainState.create(model, opt)
    assert opt.param_groups[0]["capturable"] is False
    loss_fn, _ = _dcrnn_loss(model, ops)
    step = make_mixed_precision_step(loss_fn, policy=bf16_policy)
    with pytest.raises(ValueError, match="capturable=False"):
        step(state, *data[0])
    eager = make_mixed_precision_step(loss_fn, policy=bf16_policy,
                                      capture=False)
    _, loss = eager(state, *data[0])
    assert torch.isfinite(loss) and int(state.step) == 1


def test_captured_nccl_dp_step_matches_eager(cuda):
    """``make_dp_train_step`` over the NCCL group of one ``make_mesh``
    makes captures by default, NCCL's all-reduces inside the graph: six
    steps against ``capture=False`` from the same parameters within the
    trainers' capture limits, one graph, the launch counts and the bytes
    a replay sends (none at P=1) as executed."""
    import torch.distributed as dist

    from pytorch_geometric_temporal_tpu_torch import parallel as par
    from pytorch_geometric_temporal_tpu_torch.train import TrainState, mse

    ops, data, make = _dcrnn_case(cuda)
    mesh = par.make_mesh({"dp": 1})
    try:
        assert str(dist.get_backend(mesh.get_group("dp"))) == "nccl"
        runs = {}
        for capture in (False, None):
            model = make()
            state = TrainState.create(
                model, lambda p: torch.optim.Adam(p, lr=1e-2))
            step = par.make_dp_train_step(
                lambda m, x, y: mse(m(x, ops), y), mesh, capture=capture)
            bcsr.reset_launch_counts()
            par.reset_collective_bytes()
            losses = torch.stack([step(state, x, y)[1]
                                  for x, y in data + data[:1]])
            torch.cuda.synchronize()
            runs[capture] = (losses, list(model.parameters()), step,
                             bcsr.hybrid_spmm.launches,
                             par.collective_bytes["all_reduce"])
        (le, pe, se, ne, be), (lc, pc, sc, nc, bc) = runs[False], runs[None]
        assert (se.graphs.captures, sc.graphs.captures) == (0, 1)
        assert sc.graphs.replays == 5
        assert ne == nc == 6 * 2 * (2 * 3 * (2 - 1) * 2 - (2 - 1))
        assert be == bc == 0
        assert torch.equal(lc[0], le[0]) and torch.isfinite(lc).all()
        _assert_same_run(lc, le, pc, pe)
    finally:
        par.mesh.release_group_of_one()


# ---------------------------------------------------------------------------
# The loops the JAX side compiles, captured: the METR-LA protocol, the
# full-sequence protocols, the harness's epoch, MTGNN's dropout step
# ---------------------------------------------------------------------------


def _params_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def test_captured_metrla_protocol_equals_eager_to_the_bit(cuda):
    """The METR-LA loop at 48 sensors, 288 steps, 2 epochs of batches of
    16: captured (one train graph, one test graph: the batch shape is
    fixed) against capture=False, curve, MAE and parameters to the bit."""
    from pytorch_geometric_temporal_tpu_torch.protocols import (
        metrla_protocol as mp)

    epochs, bs, t_len, n, K = 2, 16, 288, 48, 3
    (data, ei, w, means, stds, _), schedule, test_idx = mp._split(
        epochs, 0, t_len, n)
    runs = {c: mp._train(data, ei, w, means, stds, schedule, test_idx, bs,
                         K, cuda, None, 0, c) for c in (False, None)}
    (me, ce, te), (mc, cc, tc) = runs[False], runs[None]
    train_calls = epochs * (len(schedule[0]) // bs)
    eval_calls = len(test_idx) // bs
    assert eval_calls >= 2
    assert (te.captures, te.replays) == (0, 0)
    assert (tc.captures, tc.replays) == (2, train_calls + eval_calls - 2)
    assert ce == cc and me == mc and np.isfinite(me)
    assert _params_equal(te.model, tc.model)


@pytest.mark.parametrize("name", ["twittertennis_evolvegcno",
                                  "twittertennis_evolvegcnh"])
def test_captured_full_sequence_protocol_equals_eager_to_the_bit(cuda, name):
    """Four epochs of a full-sequence TwitterTennis run (24 per-snapshot
    graphs normalized inside the step): the first epoch eager, the second
    captured, the rest replayed; losses, test MSE and parameters equal to
    the eager run's to the bit."""
    from pytorch_geometric_temporal_tpu_torch.protocols import RUNS

    eager = RUNS[name](4, device=cuda, capture=False)
    captured = RUNS[name](4, device=cuda)
    assert (eager.captures, eager.replays) == (0, 0)
    assert (captured.captures, captured.replays) == (1, 3)
    assert captured.losses == eager.losses
    assert captured.test_mse == eager.test_mse
    assert _params_equal(eager.model, captured.model)


def _harness_state(ckpt_dir):
    steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    return torch.load(os.path.join(ckpt_dir, str(steps[-1]), "state.pt"),
                      weights_only=True)


def _tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    return a == b


def test_captured_harness_equals_eager_resumes_and_rolls_back(cuda, tmp_path):
    """The harness on Chickenpox, four epochs eager and captured (one
    epoch graph, one validation graph): histories and the last checkpoint
    equal to the bit; a captured run resumed at epoch 2 captures its own
    graph after the restore and equals the uninterrupted one to the bit; a
    NaN planted in epoch 1 is rolled back inside the replays."""
    from pytorch_geometric_temporal_tpu_torch.protocols import harness

    def run(epochs, name, capture=None, **kw):
        lines = []
        _, hist = harness.main(epochs, ckpt_dir=str(tmp_path / name),
                               log=lines.append, capture=capture, **kw)
        return hist, lines

    eager, _ = run(4, "eager", capture=False)
    whole, lines = run(4, "whole")
    assert lines[-1] == "2 CUDA graphs captured, 6 replays"
    assert whole == eager
    assert _tree_equal(_harness_state(tmp_path / "eager"),
                       _harness_state(tmp_path / "whole"))
    run(2, "resumed")
    rest, lines = run(4, "resumed")
    assert any(line.startswith("resumed from step") for line in lines)
    assert lines[-1] == "2 CUDA graphs captured, 2 replays"
    assert rest == whole[2:]
    assert _tree_equal(_harness_state(tmp_path / "resumed"),
                       _harness_state(tmp_path / "whole"))
    guarded, lines = run(3, "guarded", nan_epochs={1})
    assert sum("rolled back" in line for line in lines) == 1
    assert [h["epoch"] for h in guarded] == [0, 2]
    assert guarded[1]["train_mse"] == whole[1]["train_mse"]


@pytest.mark.parametrize("reseed", [True, False])
def test_mtgnn_dropout_step_captures_with_its_generator(cuda, monkeypatch,
                                                        reseed):
    """MTGNN in train mode, its dropout masks drawn from a CUDA generator
    made once and handed to the trainer: three steps captured (one graph,
    two replays) equal the eager steps to the bit, whether the generator
    is reseeded before each step (the same mask every step) or runs on.
    cuDNN's default convolution backward is not deterministic (two eager
    runs differ in the last bits), so both run with its deterministic
    algorithms."""
    from pytorch_geometric_temporal_tpu_torch.models import MTGNN
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)

    n, t = 20, 24
    rng = np.random.default_rng(25)
    x = torch.from_numpy(rng.normal(size=(4, 2, n, t)).astype(
        np.float32)).to(cuda)
    y = torch.from_numpy(rng.normal(size=(4, 12, n, 1)).astype(
        np.float32)).to(cuda)
    runs = {}
    for capture in (False, None):
        model = MTGNN(True, True, 2, n, [2, 3, 6, 7], 7, 0.3, 5, 16, 2, 8,
                      8, 16, 32, t, 2, 12, 3, 0.05, 3.0, True,
                      generator=torch.Generator().manual_seed(0))
        gen = torch.Generator(device=cuda).manual_seed(7)
        tr = BatchTrainer(model, lambda xb, m=model, g=gen: m(
            xb, train=True, generator=g), lr=1e-3, loss_fn=mse,
            capture=capture, generators=(gen,))
        losses = []
        for _ in range(3):
            if reseed:
                gen.manual_seed(7)
            losses.append(tr.train_step(x, y))
        runs[capture] = (torch.stack(losses), model, tr)
    (le, me, te), (lc, mc, tc) = runs[False], runs[None]
    assert (te.captures, tc.captures, tc.replays) == (0, 1, 2)
    assert torch.equal(le, lc) and torch.isfinite(lc).all()
    assert _params_equal(me, mc)


def test_degrees_on_the_card_are_the_same_bits_every_run(cuda):
    """Weighted degrees sum each node's edges in one order (a stable sort,
    not atomics): two graphs of the same edges give the same bits, close
    to the CPU's in-order sum (METR-LA's k-NN graph, Gaussian weights)."""
    from pytorch_geometric_temporal_tpu_torch.protocols import (
        metrla_protocol as mp)

    _, ei, w, *_ = mp.load_series(seed=0, t=288, n=207)
    graphs = [Graph.from_edge_index(ei, w, num_nodes=207, device=d)
              for d in (cuda, cuda, "cpu")]
    for name in ("in_degree", "out_degree"):
        a, b, host = (getattr(g, name)() for g in graphs)
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), host, rtol=1e-6, atol=0)


# --- walked f32 tiles (ops/bcsr.py _walk_lists) ---------------------------
# The fused kernel multiplies a sparse f32 tile by walking its nonzeros.
# Each output is the dense path's fmaf chain less the terms whose tile value
# is zero, so for finite x the two paths give the same bits: each operator
# is held against its twin built with every tile dense.


def walk_case(name):
    """(edge_index, weights, n) of the walked-tile operators: a PeMS-like
    band (6 edges a node within ±8, every tile walked), the same with
    scrambled ids (most edges in the remainder) and a band beside a first
    tile 40% full (dense)."""
    rng = np.random.default_rng(19)
    n = 6000
    s = np.repeat(np.arange(n), 6)
    r = np.clip(s + rng.integers(-8, 9, s.size), 0, n - 1)
    if name == "scrambled":
        sigma = rng.permutation(n)
        s, r = sigma[s], sigma[r]
    elif name == "mixed":
        full = np.flatnonzero(rng.random(128 * 128) < 0.4)
        s = np.concatenate([s, full % 128])
        r = np.concatenate([r, full // 128])
    return (np.stack([s, r]), rng.uniform(0.1, 1.0, s.size).astype(
        np.float32), n)


def walked_and_dense(cuda, monkeypatch, name):
    ei, w, n = walk_case(name)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    mat = bcsr.BCSRMatrix.from_graph(g)
    with monkeypatch.context() as m:
        m.setattr(bcsr, "F32_WALK_MAX_NNZ", -1)
        dense = bcsr.BCSRMatrix.from_graph(g)
    assert dense.fwd.num_walked == dense.bwd.num_walked == 0
    return mat, dense


@pytest.mark.parametrize("name", ["band", "scrambled", "mixed"])
@pytest.mark.parametrize("f", [4, 13, 24, 256, 768, 4224])
def test_walked_tiles_give_the_dense_paths_bits(cuda, monkeypatch, name, f):
    """Forward on each half and through ``_BCSRSpmm`` (the backward runs
    the transposed half): the same bits as the all-dense operator, and the
    plain version within 1e-4 of the output's scale."""
    mat, dense = walked_and_dense(cuda, monkeypatch, name)
    assert mat.fwd.num_walked == mat.fwd.nnzb - (name == "mixed")
    if name == "scrambled":
        assert mat.fwd.num_rem > 5 * mat.fwd.nnzb
    gen = torch.Generator(device=cuda).manual_seed(f)
    for half, twin in ((mat.fwd, dense.fwd), (mat.bwd, dense.bwd)):
        x = torch.randn(half.num_cols, f, device=cuda, generator=gen)
        out = bcsr.hybrid_spmm(half, x)
        assert torch.equal(out.view(torch.int32),
                           bcsr.hybrid_spmm(twin, x).view(torch.int32))
        ref = bcsr.hybrid_spmm_plain(half, x)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * max(
            1.0, float(ref.abs().max())))
    x = torch.randn(2, mat.num_nodes, -(-f // 2), device=cuda, generator=gen)
    grads = []
    for m in (mat, dense):
        xr = x.clone().requires_grad_(True)
        out = bcsr.bcsr_spmm(m, xr)
        out.backward(torch.cos(out))
        grads.append((out.detach(), xr.grad))
    for a, b in zip(*grads):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_a_tile_above_the_cut_takes_the_dense_path(cuda, monkeypatch):
    """The mixed operator's full tile is dense, its band tiles walked; with
    the cut moved under the band tiles' nonzeros every tile is dense.  The
    launches count their (tile, feature tile) products by path."""
    mat, _ = walked_and_dense(cuda, monkeypatch, "mixed")
    half = mat.fwd
    full = int(torch.count_nonzero(half.blocks[0]))
    assert full > bcsr.F32_WALK_MAX_NNZ
    assert not bool(half.walk_ptr[4] > half.walk_ptr[0])   # tile 0 dense
    x = torch.randn(half.num_cols, 200, device=cuda)
    bcsr.reset_launch_counts()
    out = bcsr.hybrid_spmm(half, x)
    ref = bcsr.hybrid_spmm_plain(half, x)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    nft = bcsr._fused_shape(200, False)[1]
    assert bcsr.tile_counts() == ((half.nnzb - 1) * nft, nft)
    ei, w, n = walk_case("mixed")
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    band = int(torch.count_nonzero(half.blocks[1:half.nnzb], (1, 2)).max())
    monkeypatch.setattr(bcsr, "F32_WALK_MAX_NNZ", band - 1)
    lowered = bcsr.BCSRMatrix.from_graph(g).fwd
    assert lowered.num_walked < half.num_walked
    assert torch.equal(bcsr.hybrid_spmm(lowered, x).view(torch.int32),
                       out.view(torch.int32))
    bcsr.reset_launch_counts()


def test_a_captured_step_counts_the_eager_steps_tiles(cuda):
    """DCRNNSeq over f32 BCSR operators: each captured train step (warm,
    capture, replays) adds to ``bcsr_tiles`` what an eager step adds."""
    from pytorch_geometric_temporal_tpu_torch.train import BatchTrainer

    ei, w, n = walk_case("band")
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
    ops = DiffusionOperators.from_graph(g, bcsr=True)
    assert ops.p_fwd.fwd.num_walked == ops.p_fwd.fwd.nnzb > 0
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.normal(size=(2, 3, n, 4)).astype(
        np.float32)).to(cuda)
    y = torch.from_numpy(rng.normal(size=(2, 3, n, 8)).astype(
        np.float32)).to(cuda)
    deltas = {}
    for capture in (False, True):
        model = DCRNNSeq(4, 8, 2, generator=torch.Generator().manual_seed(0))
        tr = BatchTrainer(model, lambda xb, m=model: m(xb, ops), lr=1e-2,
                          capture=capture)
        deltas[capture] = []
        for _ in range(4):
            before = bcsr.tile_counts()
            tr.train_step(x, y)
            torch.cuda.synchronize()
            deltas[capture].append(tuple(
                a - b for a, b in zip(bcsr.tile_counts(), before)))
    assert tr.captures == 1 and tr.replays == 3
    assert deltas[False][0][0] > 0 and deltas[False][0][1] == 0
    assert deltas[True] == deltas[False] == [deltas[False][0]] * 4
