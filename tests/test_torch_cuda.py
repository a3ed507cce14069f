"""The port's CUDA kernels on the card, against their plain versions: the
fused hybrid SpMM (the main path) and its baseline pair K1/K2.

Marked ``cuda``: each test skips without an NVIDIA card (decided inside
the fixture, never at import), and runs in f32 (TF32 off in cuDNN and
cuBLAS).  Run on the card with ``python -m pytest tests/test_torch_cuda.py
-m cuda``.  Tolerance: both sides sum the same f32 products in another
order, 1e-4 of the output's scale.
"""

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


def test_model_on_card_matches_cpu(cuda):
    n = 900
    ei, w = banded(n, 12000, seed=2)
    outs = []
    for dev in ("cpu", cuda):
        g = Graph.from_edge_index(ei, w, num_nodes=n, device=dev)
        ops = DiffusionOperators.from_graph(g, bcsr=True, device=dev)
        model = DCRNNSeq(4, 8, 2, device=dev,
                         generator=torch.Generator().manual_seed(0))
        x = torch.from_numpy(np.random.default_rng(3).normal(
            size=(2, 3, n, 4)).astype(np.float32)).to(dev)
        with torch.no_grad():
            outs.append(model(x, ops).cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5)


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
        g, dtype=torch.bfloat16, pack=3) for g in graphs])
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
    assert state.step == 4


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
    assert float(scale.scale) == 128.0 and after["step"] == before["step"]
    for name, p in before["params"].items():
        assert torch.equal(after["params"][name], p), name
    for i, moments in before["opt_state"]["state"].items():
        for key, v in moments.items():
            assert torch.equal(after["opt_state"]["state"][i][key], v), key
    for _ in range(2):
        state, scale, loss = step(state, scale, x, y)
        assert torch.isfinite(loss)
    assert float(scale.scale) == 256.0 and state.step == 3
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
