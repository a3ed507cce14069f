"""Port hygiene: the port imports no JAX, flax, optax or JAX-package module,
and its entry points build on CUDA unless given ``device="cpu"``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu_torch import models
from pytorch_geometric_temporal_tpu_torch.data import ChickenpoxDatasetLoader
from pytorch_geometric_temporal_tpu_torch.models import (
    ChebConv, DCRNNSeq, DConv, GCNConv, GConvGRU)
from pytorch_geometric_temporal_tpu_torch.protocols import RUNS
from pytorch_geometric_temporal_tpu_torch.ops import (
    DiffusionOperators, Graph, prenormalize_cheb, prenormalize_gcn,
    prepare_graph, stack_bcsr_gcn)
from pytorch_geometric_temporal_tpu_torch.signal import (
    StackedSignal, StaticGraphTemporalSignal)
from pytorch_geometric_temporal_tpu_torch.train import (
    BatchTrainer, SnapshotTrainer, ZScoreScaler)

REPO = Path(__file__).parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pytorch_geometric_temporal_tpu")
# the card's machine has neither: a loader imports h5py when it reads a table
NOT_AT_IMPORT = ("h5py", "pandas")

PROBE = """
import json, pkgutil, sys, importlib
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0]))
                 if event == "open" else None)
import pytorch_geometric_temporal_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from pytorch_geometric_temporal_tpu_torch import data
from pytorch_geometric_temporal_tpu_torch.data import _io
data.ChickenpoxDatasetLoader().get_dataset(lags=4, device="cpu")[0]
data.PedalMeDatasetLoader().get_dataset(device="cpu")[0]
data.EnglandCovidDatasetLoader().get_dataset(device="cpu")[0]
data.MontevideoBusDatasetLoader().get_dataset(device="cpu")[0]
for event in ("rg17", "uo17"):
    data.TwitterTennisDatasetLoader(event, N=50).get_dataset(device="cpu")[0]
from pytorch_geometric_temporal_tpu_torch.protocols import RUNS
RUNS["pedalme_tgcn"](1, device="cpu")
from pytorch_geometric_temporal_tpu_torch.protocols import metrla_protocol
metrla_protocol.run(epochs=1, batch_size=8, t_len=60, n=12, device="cpu")
from pytorch_geometric_temporal_tpu_torch.protocols import harness, hetero
harness.main(epochs=2, device="cpu", nan_epochs={1}, log=lambda *a: None)
hetero.main(epochs=1, device="cpu", log=lambda *a: None)
# the top-level star exports, the reference-layout aliases, and the
# parallel package on a group of one, as a spawned rank runs it
from pytorch_geometric_temporal_tpu_torch import *
from pytorch_geometric_temporal_tpu_torch import dataset, nn, parallel
sys.path.insert(0, "tests")
import _torch_parallel_ranks
import numpy as np, torch
mesh = parallel.make_mesh({"graph": -1}, device="cpu")
g = Graph.from_edge_index(np.array([[0, 1, 2], [1, 2, 0]]), device="cpu")
pops = parallel.PartitionedDiffusionOperators.from_graph(g, 1)
seq = parallel.DCRNNPartitionedSeq(2, 3, 2, device="cpu")
xs = pops.p_fwd.shard_features(torch.ones(2, 3, 1, 2), mesh, node_axis=1)
state = train.TrainState.create(seq, lambda ps: torch.optim.SGD(ps, lr=0.1))
step = parallel.make_dp_train_step(
    lambda m, x, y: train.mse(m(x, pops, mesh), y), mesh, "graph")
step(state, xs, torch.zeros(2, 3, 1, 3))
parallel.assert_same_across_hosts(seq)
print(json.dumps({"modules": sorted(sys.modules), "walked": names,
                  "bundled": str(_io._BUNDLED), "opened": opened}))
"""


def test_port_imports_no_jax(tmp_path):
    # an empty data search path: the loader must find its file in the
    # port's own bundle
    env = dict(os.environ, PGT_TPU_DATA=str(tmp_path), HOME=str(tmp_path),
               CKPT_DIR=str(tmp_path / "ckpt"))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    info = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in info["modules"]
           if any(m == f or m.startswith(f + ".")
                  for f in FORBIDDEN + NOT_AT_IMPORT)]
    assert not bad, f"port imported {bad}"
    for sub in ("ops.bcsr", "ops.operators", "csrc", "native",
                "train.trainer", "models.conv", "models.recurrent.dcrnn",
                "models.recurrent.gconv_gru", "signal.base",
                "signal.homogeneous", "signal.snapshot", "signal.split",
                "signal.stacked", "data._io", "data._common",
                "data.chickenpox", "data.pedalme", "data.encovid",
                "data.montevideo_bus", "data.twitter_tennis",
                "models._cells", "models.recurrent.temporalgcn",
                "models.recurrent.attentiontemporalgcn",
                "models.recurrent.gconv_lstm", "models.recurrent.gc_lstm",
                "models.recurrent.lrgcn", "models.recurrent.dygrae",
                "models.recurrent.evolvegcn", "models.recurrent.mpnn_lstm",
                "models.recurrent.agcrn", "protocols.bundled_accuracy",
                "protocols.metrla_protocol", "models.attention.stgcn",
                "models.attention.mstgcn", "models.attention.astgcn",
                "models.attention.gman", "models.attention.mtgnn",
                "models.attention.tsagcn", "models.attention.dnntsp",
                "signal.index_dataset", "data.metr_la", "data.pems_bay",
                "data.pems", "data.wikimath", "data.windmill", "data.mtm",
                "data.synthetic_pde", "models.hetero",
                "models.hetero.heterogclstm", "signal.heterogeneous",
                "train.state", "train.checkpoint", "train.guards",
                "train.precision", "utils", "utils.profiling",
                "protocols.harness", "protocols.hetero", "parallel",
                "parallel.collectives", "parallel.mesh", "parallel.multihost",
                "parallel.data_parallel", "parallel.partition",
                "parallel.partitioned_dcrnn", "nn", "nn.recurrent",
                "nn.attention", "nn.hetero", "dataset"):
        assert f"pytorch_geometric_temporal_tpu_torch.{sub}" in info["walked"]
    pkg = REPO / "pytorch_geometric_temporal_tpu_torch"
    # no file inside the JAX package was opened, the port's bundle was
    for other in ("pytorch_geometric_temporal_tpu", "benchmarks"):
        prefix = str(REPO / other) + os.sep
        assert not [f for f in info["opened"] if f.startswith(prefix)]
    for name in ("chickenpox", "pedalme_london", "england_covid",
                 "montevideo_bus", "twitter_tennis_rg17",
                 "twitter_tennis_uo17"):
        own = pkg / "data" / "bundled" / f"{name}.json.gz"
        assert own.is_file()
        assert str(own) in info["opened"], name
    assert Path(info["bundled"]) == pkg / "data" / "bundled"


def test_port_sources_name_no_jax_module():
    pkg = REPO / "pytorch_geometric_temporal_tpu_torch"
    sources = list(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert {"signal", "data"} <= {p.parent.name for p in sources}
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0].rstrip(",")
                assert mod not in FORBIDDEN, f"{path}: {line}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    ei = np.array([[0, 1, 2], [1, 2, 0]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Graph.from_edge_index(ei)
    g = Graph.from_edge_index(ei, device="cpu")
    feats, targs = np.zeros((2, 3, 2)), np.zeros((2, 3))
    for build in (lambda: DiffusionOperators.from_graph(g),
                  lambda: prenormalize_cheb(g),
                  lambda: prenormalize_gcn(g),
                  lambda: prepare_graph(g),
                  lambda: stack_bcsr_gcn([g]),
                  lambda: DCRNNSeq(2, 4, 2),
                  lambda: DConv(2, 4, 2),
                  lambda: ChebConv(2, 4, 2),
                  lambda: GCNConv(2, 4),
                  lambda: GConvGRU(2, 4, 2),
                  lambda: StaticGraphTemporalSignal(ei, None, feats, targs),
                  lambda: StackedSignal.from_arrays(feats, targs, ei),
                  lambda: ChickenpoxDatasetLoader().get_dataset(),
                  lambda: SnapshotTrainer(GConvGRU(2, 4, 2, device="cpu"),
                                          lambda c, x, y, gr: (x.sum(), c)),
                  lambda: ZScoreScaler.fit(np.ones(3)),
                  lambda: BatchTrainer(DCRNNSeq(2, 4, 2, device="cpu"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    for build in (lambda: models.TGCN(2, 4),
                  lambda: models.A3TGCN(2, 4, 3),
                  lambda: models.GConvLSTM(2, 4, 2),
                  lambda: models.GCLSTM(2, 4, 2),
                  lambda: models.RGCNConv(2, 4, 2),
                  lambda: models.LRGCN(2, 4, 2),
                  lambda: models.split_relations(ei, [0, 1, 0], 2, 3),
                  lambda: models.GatedGraphConv(4, 1),
                  lambda: models.DyGrEncoder(4, 1, "add", 4, 1),
                  lambda: models.EvolveGCNO(4),
                  lambda: models.EvolveGCNH(3, 4),
                  lambda: models.EvolveGCNOSeq(4),
                  lambda: models.EvolveGCNHSeq(3, 4),
                  lambda: models.MPNNLSTM(2, 4, 3, 2),
                  lambda: models.AVWGCN(2, 4, 2, 3),
                  lambda: models.AGCRN(3, 2, 4, 2, 3),
                  *(lambda run=run: run(1) for run in RUNS.values())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    ops = DiffusionOperators.from_graph(g, bcsr=True, device="cpu")
    model = DCRNNSeq(2, 4, 2, device="cpu")
    trainer = BatchTrainer(model, lambda x: model(x, ops), device="cpu")
    loss = trainer.train_step(torch.randn(1, 2, 3, 2), torch.randn(1, 2, 3, 4))
    assert torch.isfinite(loss)


def test_attention_entry_points_raise_without_cuda(no_cuda):
    from pytorch_geometric_temporal_tpu_torch.models import _cells
    from pytorch_geometric_temporal_tpu_torch.models import attention as att
    from pytorch_geometric_temporal_tpu_torch.protocols import metrla_protocol

    ei = np.array([[0, 1, 2], [1, 2, 0]])
    a = np.zeros((3, 3, 3), np.float32)
    relu = torch.relu
    builds = {
        "Conv": lambda **kw: _cells.Conv(2, 4, (1, 3), **kw),
        "LayerNorm": lambda **kw: _cells.LayerNorm(4, **kw),
        "Embed": lambda **kw: _cells.Embed(3, 4, **kw),
        "BatchNorm": lambda **kw: _cells.BatchNorm(4, **kw),
        "TemporalConv": lambda **kw: att.TemporalConv(2, 4, **kw),
        "STConv": lambda **kw: att.STConv(3, 2, 4, 4, 3, 2, **kw),
        "MSTGCNBlock": lambda **kw: att.MSTGCNBlock(2, 2, 4, 4, 1, **kw),
        "MSTGCN": lambda **kw: att.MSTGCN(1, 2, 2, 4, 4, 1, 2, 4, **kw),
        "ChebConvAttention": lambda **kw: att.ChebConvAttention(2, 4, 2,
                                                                **kw),
        "SpatialAttention": lambda **kw: att.SpatialAttention(2, 3, 4, **kw),
        "SpatialAttentionSparse": lambda **kw: att.SpatialAttentionSparse(
            2, 4, **kw),
        "TemporalAttention": lambda **kw: att.TemporalAttention(2, 3, 4,
                                                                **kw),
        "ASTGCNBlock": lambda **kw: att.ASTGCNBlock(2, 2, 4, 4, 1, 3, 4,
                                                    **kw),
        "ASTGCN": lambda **kw: att.ASTGCN(1, 2, 2, 4, 4, 1, 2, 4, 3, **kw),
        "FullyConnected": lambda **kw: att.FullyConnected(2, [4], [relu],
                                                          **kw),
        "SpatioTemporalEmbedding": lambda **kw: att.SpatioTemporalEmbedding(
            4, 0.1, 24, **kw),
        "GatedFusion": lambda **kw: att.GatedFusion(4, 0.1, **kw),
        "SpatioTemporalAttention": lambda **kw: att.SpatioTemporalAttention(
            2, 2, 0.1, True, **kw),
        "TransformAttention": lambda **kw: att.TransformAttention(2, 2, 0.1,
                                                                  **kw),
        "GMAN": lambda **kw: att.GMAN(1, 2, 2, 3, 0.1, 24, **kw),
        "MixProp": lambda **kw: att.MixProp(2, 4, 1, 0.0, 0.05, **kw),
        "DilatedInception": lambda **kw: att.DilatedInception(2, 4, [2, 3],
                                                              1, **kw),
        "GraphConstructor": lambda **kw: att.GraphConstructor(3, 2, 2, 1.0,
                                                              **kw),
        "MTGNNLayer": lambda **kw: att.MTGNNLayer(
            1, 1, 3, 1, 4, 4, 4, [2, 3], 1, True, True, 6, 3, 0.0, 1, 3,
            0.05, **kw),
        "MTGNN": lambda **kw: att.MTGNN(
            True, True, 1, 3, [2, 3], 3, 0.0, 2, 2, 1, 4, 4, 4, 4, 6, 1, 1,
            1, 0.05, 1.0, True, **kw),
        "GraphAAGCN": lambda **kw: att.GraphAAGCN(ei, 3, **kw),
        "UnitTCN": lambda **kw: att.UnitTCN(2, 4, **kw),
        "UnitGCN": lambda **kw: att.UnitGCN(2, 4, a, **kw),
        "AAGCN": lambda **kw: att.AAGCN(2, 4, ei, 3, **kw),
        "MaskedSelfAttention": lambda **kw: att.MaskedSelfAttention(4, 4, 2,
                                                                    **kw),
        "GlobalGatedUpdater": lambda **kw: att.GlobalGatedUpdater(3, **kw),
        "WeightedGCNBlock": lambda **kw: att.WeightedGCNBlock(2, [4], 4,
                                                              **kw),
        "DNNTSP": lambda **kw: att.DNNTSP(3, 4, 2, **kw),
        "metrla run": lambda **kw: metrla_protocol.run(
            epochs=1, batch_size=4, t_len=40, n=12, **kw),
    }
    # every exported class is here but the NamedTuple, which holds tensors
    assert set(att.__all__) - set(builds) == {"EdgeScores"}
    for name, build in builds.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        assert build(device="cpu") is not None, name
    series = metrla_protocol.load_series(t=40, n=12)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        metrla_protocol.train(*series[:5], [np.arange(8)], np.arange(8), 4, 2)


def test_kernel_wrappers_refuse_other_devices():
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    g = Graph.from_edge_index(np.array([[0, 1], [1, 0]]), device="cpu")
    half = bcsr.BCSRMatrix.from_graph(g).fwd
    x = torch.zeros(half.num_cols, 3, device="meta")
    with pytest.raises(ValueError):
        bcsr.tile_spmm(half, x)


def test_fused_wrapper_refuses_other_devices():
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    g = Graph.from_edge_index(np.array([[0, 1], [1, 0]]), device="cpu")
    half = bcsr.BCSRMatrix.from_graph(g).fwd
    with pytest.raises(ValueError):
        bcsr.hybrid_spmm(half, torch.zeros(half.num_cols, 3, device="meta"))


def test_kernel_signatures_match_the_sources():
    """``csrc.SIGNATURES`` names every ``int pgtt_*(...)`` entry point of
    ``csrc/*.cu`` with its arguments' types in order (a pointer as void*,
    int, int64_t, float), and ``bcsr.hybrid_args`` gives the fused kernel
    all of its arguments but the stream: ctypes passes a drifted list
    through unchecked."""
    import ctypes
    import re

    from pytorch_geometric_temporal_tpu_torch import csrc
    from pytorch_geometric_temporal_tpu_torch.ops import bcsr

    def c_type(param):
        if "*" in param:
            return ctypes.c_void_p
        return {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
                "float": ctypes.c_float}[param.split()[0]]

    protos = {}
    for src in csrc.SOURCES:
        for name, params in re.findall(r"^int (pgtt_\w+)\(([^)]*)\)",
                                       src.read_text(), re.M):
            protos[name] = tuple(c_type(p.strip())
                                 for p in params.split(","))
    assert len(protos) == 7
    assert protos == csrc.SIGNATURES

    g = Graph.from_edge_index(np.array([[0, 1, 2], [1, 2, 0]]),
                              device="cpu")
    for dtype in (torch.float32, torch.bfloat16):
        half = bcsr.BCSRMatrix.from_graph(g, dtype=dtype).fwd
        x = torch.zeros(half.num_cols, 3, dtype=dtype)
        out = torch.empty(half.num_rows, 3)
        args = bcsr.hybrid_args(half, x, out)
        assert len(args) == len(csrc.SIGNATURES["pgtt_hybrid_spmm"]) - 1
        assert all(isinstance(a, int) for a in args)


def test_index_batching_raises_without_cuda(no_cuda, tmp_path):
    from pytorch_geometric_temporal_tpu_torch.data import _common
    from pytorch_geometric_temporal_tpu_torch.signal import (
        DeviceWindower, StreamingWindower)

    data = np.zeros((20, 3, 1), np.float32)
    np.save(tmp_path / "s.npy", data)
    stream = StreamingWindower(tmp_path / "s.npy", 2)
    assert stream.host_batch([0, 3]).shape == (2, 4, 3, 1)  # host only
    loader = ChickenpoxDatasetLoader(index=True)
    for build in (lambda: DeviceWindower(data, 2),
                  lambda: stream([0, 3]),
                  lambda: _common.make_index_loaders(data, 2, 4),
                  lambda: loader.get_index_dataset()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    for build in (lambda: DeviceWindower(data, 2, device="cpu"),
                  lambda: StreamingWindower(tmp_path / "s.npy", 2,
                                            device="cpu")([0, 3]),
                  lambda: _common.make_index_loaders(data, 2, 4,
                                                     device="cpu"),
                  lambda: loader.get_index_dataset(device="cpu")):
        assert build() is not None


def test_hetero_and_harness_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from pytorch_geometric_temporal_tpu_torch import signal
    from pytorch_geometric_temporal_tpu_torch.protocols import harness, hetero

    meta = (["a", "b"], [("a", "to", "b")])
    ei = {("a", "to", "b"): np.array([[0, 1], [1, 0]])}
    ew = {("a", "to", "b"): np.ones(2)}
    feats = [{"a": np.zeros((2, 3)), "b": np.zeros((2, 3))}] * 2
    targs = [{"a": np.zeros(2)}] * 2
    batch = {"a": np.zeros(2, int)}
    signals = {
        "StaticHeteroGraphTemporalSignal": (ei, ew, feats, targs),
        "DynamicHeteroGraphTemporalSignal": ([ei] * 2, [ew] * 2, feats,
                                             targs),
        "DynamicHeteroGraphStaticSignal": ([ei] * 2, [ew] * 2, feats[0],
                                           targs),
        "StaticHeteroGraphTemporalSignalBatch": (ei, ew, feats, targs, batch),
        "DynamicHeteroGraphTemporalSignalBatch": ([ei] * 2, [ew] * 2, feats,
                                                  targs, [batch] * 2),
        "DynamicHeteroGraphStaticSignalBatch": ([ei] * 2, [ew] * 2,
                                                feats[0], targs, [batch] * 2),
    }
    builds = [lambda **kw: models.SAGEConv(3, 4, **kw),
              lambda **kw: models.SAGEConv((3, 2), 4, **kw),
              lambda **kw: models.HeteroGCLSTM({"a": 3, "b": 3}, 4, meta,
                                               **kw),
              lambda **kw: hetero.main(1, log=lambda *a: None, **kw),
              lambda **kw: harness.main(1, ckpt_dir=str(tmp_path / str(
                  len(kw))), log=lambda *a: None, **kw)]
    builds += [lambda cls=cls, args=args, **kw: getattr(signal, cls)(
        *args, **kw) for cls, args in signals.items()]
    for build in builds:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        assert build(device="cpu") is not None
    sig = signal.StaticHeteroGraphTemporalSignal(ei, ew, feats, targs,
                                                 device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        signal.StackedHeteroSignal.from_signal(sig, device="cuda")
    assert signal.StackedHeteroSignal.from_signal(sig).snapshot_count == 2


def test_parallel_entry_points_raise_without_cuda(no_cuda):
    """A mesh, the data-parallel step, a node block and the partitioned
    models build on CUDA unless given the CPU (a mesh carries its device
    type); the CPU side runs on a group of one in the audit probe above and
    on four gloo ranks in ``tests/test_torch_parallel.py``."""
    from types import SimpleNamespace

    from pytorch_geometric_temporal_tpu_torch import parallel

    cuda_mesh = SimpleNamespace(device_type="cuda")
    g = Graph.from_edge_index(np.array([[0, 1, 2], [1, 2, 0]]), device="cpu")
    pg = parallel.PartitionedGraph.from_graph(g, 1, by="halo")
    pops = parallel.PartitionedDiffusionOperators.from_graph(g, 1)
    for build in (lambda: parallel.make_mesh({"dp": 1}),
                  lambda: parallel.make_dp_train_step(
                      lambda m, x, y: x.sum(), cuda_mesh),
                  lambda: pg.shard_features(np.ones((3, 2)), cuda_mesh),
                  lambda: pops.shard_features(np.ones((3, 1, 2)), cuda_mesh),
                  lambda: parallel.replicate({"a": np.ones(2)}, cuda_mesh),
                  lambda: parallel.shard_batch(np.ones(2), cuda_mesh),
                  lambda: parallel.initialize_multihost("localhost:1", 2, 0),
                  lambda: parallel.DCRNNPartitioned(2, 4, 2),
                  lambda: parallel.DCRNNPartitionedSeq(2, 4, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert not torch.distributed.is_initialized()
    for build in (lambda: parallel.DCRNNPartitioned(2, 4, 2, device="cpu"),
                  lambda: parallel.DCRNNPartitionedSeq(2, 4, 2,
                                                       device="cpu")):
        assert build() is not None
