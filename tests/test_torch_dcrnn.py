"""Port parity: DConv / DCRNN / DCRNNSeq with transplanted flax parameters.

Inputs are made with numpy from a seed; the flax parameters of the JAX
model are loaded into the torch module with ``params_from_flax``.  Outputs
and input gradients are f32 results of the same arithmetic in another
summation order: tolerance 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu.models import DCRNN as JDCRNN
from pytorch_geometric_temporal_tpu.models import DCRNNSeq as JDCRNNSeq
from pytorch_geometric_temporal_tpu.models import DConv as JDConv
from pytorch_geometric_temporal_tpu.ops import Graph as JGraph
from pytorch_geometric_temporal_tpu.ops.operators import (
    DiffusionOperators as JOps)
from pytorch_geometric_temporal_tpu_torch.models import DCRNN, DCRNNSeq, DConv
from pytorch_geometric_temporal_tpu_torch.ops import DiffusionOperators
from pytorch_geometric_temporal_tpu_torch.ops import Graph as TGraph

ATOL = 1e-5


def graphs(n, e, seed=0, band=None):
    rng = np.random.default_rng(seed)
    if band is None:
        ei = np.unique(rng.integers(0, n, size=(2, e)), axis=1)
    else:
        s = rng.integers(0, n, size=e)
        r = np.clip(s + rng.integers(-band, band + 1, size=e), 0, n - 1)
        s = np.concatenate([s, rng.integers(0, n, size=e // 20)])
        r = np.concatenate([r, rng.integers(0, n, size=e // 20)])
        ei = np.stack([s, r])
    w = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    return (JGraph.from_edge_index(ei, w, num_nodes=n),
            TGraph.from_edge_index(ei, w, num_nodes=n, device="cpu"))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def check(jmodel, tmodel, jgraph, tgraph, shape, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x), jgraph)
    tmodel.params_from_flax(to_numpy(params))
    out_j = jmodel.apply(params, jnp.asarray(x), jgraph)
    cot = rng.normal(size=out_j.shape).astype(np.float32)
    gx_j = jax.grad(lambda x_: jnp.sum(
        jmodel.apply(params, x_, jgraph) * cot))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tmodel(xt, tgraph)
    (gx_t,) = torch.autograd.grad((out_t * torch.from_numpy(cot)).sum(), xt)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=ATOL)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=ATOL)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_dcrnnseq_dense_matches_jax(K):
    jg, tg = graphs(30, 120)
    check(JDCRNNSeq(out_channels=6, K=K), DCRNNSeq(3, 6, K, device="cpu"),
          jg, tg, (2, 4, 30, 3))


@pytest.mark.parametrize("bcsr", [False, True])
def test_dcrnnseq_operators_match_jax(bcsr):
    """Prebuilt DiffusionOperators; ``bcsr=True`` tiles them (f32 tiles,
    a non-empty remainder), which the port runs through the plain versions
    of its kernels on the CPU."""
    n = 700
    jg, tg = graphs(n, 9000, seed=2, band=30)
    jops = JOps.from_graph(jg, bcsr=bcsr)
    tops = DiffusionOperators.from_graph(tg, bcsr=bcsr, device="cpu")
    if bcsr:
        assert tops.p_fwd.fwd.nnzb > 0 and tops.p_fwd.fwd.num_rem > 0
    check(JDCRNNSeq(out_channels=8, K=2), DCRNNSeq(4, 8, 2, device="cpu"),
          jops, tops, (1, 3, n, 4))


def test_dcrnn_cell_and_dconv_match_jax():
    jg, tg = graphs(25, 100, seed=3)
    check(JDCRNN(out_channels=5, K=2), DCRNN(3, 5, 2, device="cpu"),
          jg, tg, (2, 25, 3))
    check(JDConv(out_channels=4, K=3), DConv(3, 4, 3, device="cpu"),
          jg, tg, (25, 3))


@pytest.mark.parametrize("K", [1, 2, 3])
def test_reference_compat_basis_matches_jax(K):
    """``compat='reference'`` on a weighted, unpadded graph: the basis and
    DConv / DCRNN / DCRNNSeq built on it."""
    from pytorch_geometric_temporal_tpu.models.recurrent import dcrnn as jd
    from pytorch_geometric_temporal_tpu_torch.models import (
        diffusion_basis_reference)

    # every node sends and receives (a ring under the random edges): the
    # upstream norms divide by the degrees
    n = 30
    rng = np.random.default_rng(6)
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n])
    ei = np.unique(np.concatenate(
        [ring, rng.integers(0, n, size=(2, 100))], axis=1), axis=1)
    w = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    jg = JGraph.from_edge_index(ei, w, num_nodes=n)
    tg = TGraph.from_edge_index(ei, w, num_nodes=n, device="cpu")
    x = rng.normal(size=(2, n, 3)).astype(np.float32)
    want = jd.diffusion_basis_reference(jg, jnp.asarray(x), K)
    got = diffusion_basis_reference(tg, torch.from_numpy(x), K)
    assert got.shape == (2, n, 2 * K * 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    check(JDCRNNSeq(out_channels=5, K=K, compat="reference"),
          DCRNNSeq(3, 5, K, compat="reference", device="cpu"),
          jg, tg, (2, 3, n, 3))
    check(JDCRNN(out_channels=5, K=K, compat="reference"),
          DCRNN(3, 5, K, compat="reference", device="cpu"), jg, tg,
          (n, 3))
    check(JDConv(out_channels=4, K=K, compat="reference"),
          DConv(3, 4, K, compat="reference", device="cpu"), jg, tg, (n, 3))


def test_reference_compat_refuses_a_padded_graph():
    ei = np.array([[0, 1, 2], [1, 2, 0]])
    tg = TGraph.from_edge_index(ei, num_nodes=3, pad_to=5, device="cpu")
    model = DCRNNSeq(2, 3, 2, compat="reference", device="cpu")
    with pytest.raises(ValueError, match="requires an unpadded edge list "
                                         r"\(edge_pad=5 != num_edges=3\)"):
        model(torch.zeros(1, 2, 3, 2), tg)


def test_bf16_operator_tracks_segment_reference():
    """bf16 tiles (x and remainder values rounded to bf16, f32 sums) stay
    within 2e-2 of the f32 reference over a few recurrent steps — the
    tolerance chip_smoke.py applies to the slice on the card."""
    n = 800
    _, tg = graphs(n, 10000, seed=4, band=40)
    ops16 = DiffusionOperators.from_graph(tg, bcsr=True,
                                          dtype=torch.bfloat16, device="cpu")
    ops32 = DiffusionOperators.from_graph(tg, bcsr=False, device="cpu")
    model = DCRNNSeq(4, 8, 2, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 4, n, 4)).astype(np.float32))
    with torch.no_grad():
        err = (model(x, ops16) - model(x, ops32)).abs().max()
    assert 0 < float(err) < 2e-2


def test_params_from_flax_checks_shapes():
    model = DCRNNSeq(3, 6, 2, device="cpu")
    tree = {"params": {"cell": {
        "w_zr": np.zeros((36, 12)), "b_zr": np.zeros(12),
        "w_h": np.zeros((36, 7)), "b_h": np.zeros(6)}}}
    with pytest.raises(ValueError):
        model.params_from_flax(tree)


def test_seeded_glorot_init_is_reproducible():
    a = DCRNNSeq(3, 6, 2, device="cpu",
                 generator=torch.Generator().manual_seed(7))
    b = DCRNNSeq(3, 6, 2, device="cpu",
                 generator=torch.Generator().manual_seed(7))
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    limit = np.sqrt(6.0 / (36 + 12))
    assert float(a.cell.w_zr.detach().abs().max()) <= limit
