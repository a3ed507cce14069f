"""The BCSR builder's cost models (``ops/bcsr.py``: ``KernelCosts``,
``TPU_V5E``, ``H100``) and the two layout decisions they price.

- ``costs=TPU_V5E`` makes the JAX package's decisions: the same θ, the same
  cost (float equality) and the same ``_reorder_pays_off`` on the banded
  draws of ``test_torch_bcsr.py``, in bf16 and f32 tiles.
- The H100 makespan model: ``fused_kernel_ns`` equals a brute-force walk of
  the fused kernel's persistent loop over its item list (row blocks with
  tiles or nothing, then remainder-only tasks), under and over one wave of
  CTAs;
  the threshold sweep's per-row-block counts equal those of the halves
  built at each θ.
- The H100 default's decisions on the scrambled PeMS stand-in (keep the
  ids) and on the N=20,000 reorder-recovery draw (reorder), at full size on
  the host: the two graphs ``chip_smoke.py`` times these decisions on
  (phases 21 and 22), drawn here from the same seeds.
- ``spmm``'s auto route prices at the width ``bcsr_spmm`` flattens x to,
  and ``bcsr_spmm``'s outputs and gradients agree across the two orders.

Inputs are made with numpy from a seed.  Tolerance for the two orders: the
same f32 products summed in another order, 1e-5 of the output's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_temporal_tpu.ops import Graph as JGraph
from pytorch_geometric_temporal_tpu.ops import bcsr as jb
from pytorch_geometric_temporal_tpu.ops import operators as jops
from pytorch_geometric_temporal_tpu_torch import config_override
from pytorch_geometric_temporal_tpu_torch.native import (
    bandwidth_reduction_order)
from pytorch_geometric_temporal_tpu_torch.ops import Graph as TGraph
from pytorch_geometric_temporal_tpu_torch.ops import bcsr as tb
from pytorch_geometric_temporal_tpu_torch.ops import operators as tops
from pytorch_geometric_temporal_tpu_torch.ops.operators import (
    host_diffusion_norms)
from pytorch_geometric_temporal_tpu_torch.ops.spmm import spmm, spmm_segment
from _torch_jax_native import jax_native  # noqa: F401

# the JAX package's native library, loaded race-free: its RCM order is
# what the port's native layer is compared with (see the module)
pytestmark = pytest.mark.usefixtures("jax_native")


# test_torch_bcsr.py's banded draws: (seed, n, e, band, frac_local,
# scramble)
DRAWS = [(1, 2000, 30000, 40, 0.9, False), (5, 1200, 15000, 40, 0.9, True),
         (2, 900, 12000, 40, 0.9, False), (12, 1100, 14000, 40, 0.9, True),
         (8, 1024, 2048, 8, 1.0, True)]


def banded(seed, n, e, band, frac_local, scramble):
    rng = np.random.default_rng(seed)
    e_loc = int(e * frac_local)
    s = rng.integers(0, n, size=e_loc)
    r = np.clip(s + rng.integers(-band, band + 1, size=e_loc), 0, n - 1)
    s = np.concatenate([s, rng.integers(0, n, size=e - e_loc)])
    r = np.concatenate([r, rng.integers(0, n, size=e - e_loc)])
    if scramble:
        p = rng.permutation(n)
        s, r = p[s], p[r]
    return s.astype(np.int32), r.astype(np.int32)


def relabeled(s, r, n):
    """The edges under the RCM order ``from_graph`` computes."""
    p = bandwidth_reduction_order(s, r, n)
    ip = np.empty_like(p)
    ip[p] = np.arange(n, dtype=np.int32)
    return ip[s], ip[r]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("draw", DRAWS)
def test_v5e_tuner_matches_jax_float_for_float(draw, bf16):
    s, r = banded(*draw)
    n = draw[1]
    for expected_f in (64, 256):
        for fixed in (None, 32):
            got = tb.tune_min_block_edges(
                r, s, n, dtype=torch.bfloat16 if bf16 else None,
                expected_f=expected_f, _return_cost=True, _fixed_theta=fixed,
                costs=tb.TPU_V5E)
            want = jb.tune_min_block_edges(
                r, s, n, dtype=jnp.bfloat16 if bf16 else None,
                expected_f=expected_f, _return_cost=True, _fixed_theta=fixed)
            assert got[0] == want[0] and float(got[1]) == float(want[1])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("draw", DRAWS)
def test_v5e_reorder_decision_matches_jax(draw, bf16):
    s, r = banded(*draw)
    n = draw[1]
    s1, r1 = relabeled(s, r, n)
    for mbe in ("auto", 32):
        got = tb._reorder_pays_off(r, s, r1, s1, n, 128,
                                   torch.bfloat16 if bf16 else None, 64, mbe,
                                   costs=tb.TPU_V5E)
        want = jb._reorder_pays_off(r, s, r1, s1, n, 128,
                                    jnp.bfloat16 if bf16 else None, 64, mbe)
        assert got == want


def test_default_costs_is_h100_and_looked_up_at_call_time(monkeypatch):
    """``costs=None`` means ``DEFAULT_COSTS`` when called: patched to
    TPU_V5E, a build makes the JAX package's θ and permutation."""
    assert tb.DEFAULT_COSTS is tb.H100 and tb.H100.makespan
    assert not tb.TPU_V5E.makespan
    s, r = banded(*DRAWS[1])
    n = DRAWS[1][1]
    w = np.ones(len(s), np.float32)
    monkeypatch.setattr(tb, "DEFAULT_COSTS", tb.TPU_V5E)
    assert tb.tune_min_block_edges(r, s, n) == jb.tune_min_block_edges(
        r, s, n)
    tm = tb.BCSRMatrix.from_graph(
        TGraph.from_edge_index(np.stack([s, r]), w, num_nodes=n,
                               device="cpu"),
        min_block_edges="auto", reorder="auto")
    jm = jb.BCSRMatrix.from_graph(
        JGraph.from_edge_index(np.stack([s, r]), w, num_nodes=n),
        min_block_edges="auto", reorder="auto")
    assert (tm.perm is None) == (jm.perm is None)
    if jm.perm is not None:
        np.testing.assert_array_equal(tm.perm.numpy(), np.asarray(jm.perm))
        np.testing.assert_array_equal(tm.iperm.numpy(),
                                      np.asarray(jm.iperm))
    np.testing.assert_array_equal(tm.fwd.block_cols.numpy(),
                                  jm.fwd._host["block_cols"])


def test_linear_constants_stay_linear():
    """``tile_ns`` / ``edge_ns`` override the TPU v5e model's own and
    belong to no other."""
    s, r = banded(*DRAWS[0])
    n = DRAWS[0][1]
    got = tb.tune_min_block_edges(r, s, n, tile_ns=50.0, edge_ns=9.0,
                                  costs=tb.TPU_V5E, _return_cost=True)
    want = jb.tune_min_block_edges(r, s, n, tile_ns=50.0, edge_ns=9.0,
                                   _return_cost=True)
    assert got == want
    with pytest.raises(ValueError, match="linear"):
        tb.tune_min_block_edges(r, s, n, tile_ns=50.0, costs=tb.H100)


def test_stack_bcsr_gcn_prices_by_the_default_costs(monkeypatch):
    """``stack_bcsr_gcn``'s default ``min_block_edges="auto"`` with
    ``DEFAULT_COSTS`` patched to TPU_V5E builds the JAX package's per-step
    arrays."""
    monkeypatch.setattr(tb, "DEFAULT_COSTS", tb.TPU_V5E)
    rng = np.random.default_rng(4)
    n = 700
    graphs = []
    for _ in range(2):
        s = rng.integers(0, n, 6000)
        r = np.clip(s + rng.integers(-30, 31, 6000), 0, n - 1)
        graphs.append((np.stack([s, r]),
                       rng.uniform(0.1, 1.0, 6000).astype(np.float32)))
    tst = tops.stack_bcsr_gcn(
        [TGraph.from_edge_index(ei, w, num_nodes=n, device="cpu")
         for ei, w in graphs], device="cpu")
    for (ei, w), mat in zip(graphs, tst):
        jmat = jb.BCSRMatrix.from_graph(
            jops.host_gcn_norm(JGraph.from_edge_index(ei, w, num_nodes=n)),
            min_block_edges="auto", pack=2)
        for side in ("fwd", "bwd"):
            th, jhost = getattr(mat, side), getattr(jmat, side)._host
            for key in ("block_rows", "block_cols"):
                np.testing.assert_array_equal(getattr(th, key).numpy(),
                                              jhost[key])
            # the JAX remainder without its chunk padding (val 0; every
            # normalized weight here is positive)
            real = jhost["rem_vals"].reshape(-1) != 0
            np.testing.assert_array_equal(th.rem_cols.numpy(),
                                          jhost["rem_cols"][real])


# ---------------------------------------------------------------------------
# the H100 makespan model
# ---------------------------------------------------------------------------

COSTS = tb.KernelCosts("test", sms=132, bytes_per_ns=3350.0,
                       bf16=(3100.0, 410.0, 2.5, 190.0, 4.0, 350.0, 0.07),
                       f32=(3300.0, 380.0, 1.5, 260.0, 27.0, 430.0, 0.05),
                       gather=(2000.0, 0.5, 2600.0))


def kernel_config(f, bf16):
    """(FT, feature tiles, stages a tile, RE) as ``pgtt_hybrid_spmm`` and
    its ``Cfg`` derive them, transcribed statement by statement (the
    widest f32 feature tile, ``PGTT_F32_MAX_FT``, is 96)."""
    max_ft = 128 if bf16 else 96
    nft = (f + max_ft - 1) // max_ft
    width = (f + nft - 1) // nft
    nt = 16
    for t in (1, 2, 4, 5, 6, 8, 12, 16):
        if t * 8 >= width:
            nt = t
            break
    ft = nt * 8
    size = 2 if bf16 else 4
    kc = 128 // size
    chunks = 128 // kc
    nbox = (ft * size + 128 - 1) // 128
    a_bytes, b_bytes = 128 * 128, nbox * kc * 128
    rrow = (ft * size + 16 - 1) // 16 * 16
    v = (a_bytes + b_bytes) // rrow if (a_bytes + b_bytes) // rrow < 128 \
        else 128
    re = 1
    while 2 * re <= v:
        re *= 2
    return ft, nft, chunks, re


def kernel_items(tiles, rems):
    """The item list of one feature tile as the model prices it, built
    item by item: (kept tiles, remainder edges) of the row blocks walked
    whole (tiles, or nothing at all), in order, then of each remainder-only
    row block's ⌈r / (7/8 · REM_TASK_EDGES)⌉ tasks of equal edges."""
    items = [(t, r) for t, r in zip(tiles, rems) if t > 0 or r == 0]
    for t, r in zip(tiles, rems):
        if t == 0 and r > 0:
            k = -(-int(r) * 8 // (7 * tb.REM_TASK_EDGES))
            items += [(0, r / k)] * k
    return items


def brute_force_ns(costs, tiles, rems, f, bf16):
    """One launch by walking the kernel's loop: CTA b takes items b, b + G,
    ... (``item = blockIdx.x; item += gridDim.x``) over the item list, one
    feature tile after another."""
    launch, a0, a1, b0, b1, r0, r1 = costs.bf16 if bf16 else costs.f32
    ft, nft, chunks, re = kernel_config(f, bf16)
    per_ft = kernel_items(tiles, rems)
    items = len(per_ft) * nft
    grid = min(items, costs.sms)
    worst = 0.0
    for block in range(grid):
        total = 0.0
        for item in range(block, items, grid):
            t, r = per_ft[item % len(per_ft)]
            total += ((a0 + a1 * ft) + (b0 + b1 * ft) * chunks * t
                      + (r0 + r1 * re * ft) * -(-r // re))
        worst = max(worst, total)
    return launch + worst


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("f", [1, 8, 13, 32, 64, 96, 200, 256, 768])
def test_fused_shape_is_the_kernels(f, bf16):
    assert tb._fused_shape(f, bf16) == kernel_config(f, bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("nrb,f", [(5, 64), (40, 256), (131, 96), (132, 32),
                                   (133, 64), (157, 256), (300, 768),
                                   (88, 256)])
def test_makespan_equals_brute_force(nrb, f, bf16):
    """Random (tiles, remainder edges) a row block, several candidate
    layouts at once, under and over one wave of 132 CTAs."""
    rng = np.random.default_rng(nrb * 1000 + f)
    tiles = rng.integers(0, 5, size=(4, nrb))
    rems = rng.integers(0, 5000, size=(4, nrb)) * rng.integers(0, 2, (4, nrb))
    got = tb.fused_kernel_ns(COSTS, tiles, rems, f, bf16)
    want = [brute_force_ns(COSTS, t, r, f, bf16) for t, r in zip(tiles, rems)]
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("draw", DRAWS[:3])
def test_threshold_sweep_counts_equal_the_builds(draw, bf16):
    """The makespan sweep's cost at each θ equals the model on the halves
    ``_build_half`` makes at that θ: per row block, the kept tiles from the
    tile pointers and the remainder edges from the row pointers."""
    s, r = banded(*draw)
    n = draw[1]
    dtype = torch.bfloat16 if bf16 else None
    w = np.ones(len(s), np.float32)
    for theta in (2, 9, 17, 40, 10**6):
        _, cost = tb.tune_min_block_edges(r, s, n, dtype=dtype, expected_f=96,
                                          _return_cost=True,
                                          _fixed_theta=theta, costs=COSTS)
        want = 0.0
        for rows, cols in ((r, s), (s, r)):
            half = tb._build_half(rows, cols, w, n, 128, dtype, theta)
            tiles, rems = half.row_block_layout()
            want += float(tb._half_ns(COSTS, tiles, rems, 96, bf16)[0])
        assert cost == pytest.approx(want, rel=1e-12)


def test_subsampled_candidates_keep_both_ends():
    order = np.arange(1, 1001)
    cands = tb._theta_candidates(order, None, subsample=True)
    assert len(cands) == tb.MAX_THETA_CANDIDATES
    assert cands[0] == 1 and cands[-1] == 1001
    assert len(tb._theta_candidates(order, None, subsample=False)) == 1001


def test_gather_charge():
    """The linear model's two gathers at ``row_ns`` a row; the makespan
    model's four a training hop, x and its gradient in the tiles' dtype,
    the output and its gradient in f32."""
    assert tb._gather_ns(tb.TPU_V5E, 1024, None, 64) == 2.0 * 1024 * 2
    g0, row_ns, bw = COSTS.gather
    want = 4 * (g0 + 1024 * row_ns) + 2 * 1024 * 64 * (2 + 2 + 4 + 4) / bw
    assert tb._gather_ns(COSTS, 1024, torch.bfloat16, 64) == pytest.approx(
        want)


def decision(s, r, n, dtype, f, mbe):
    s1, r1 = relabeled(s, r, n)
    return tb._reorder_pays_off(r, s, r1, s1, n, 128, dtype, f, mbe)


def scrambled_pems_graph():
    """The banded sensor graph of ``examples/index_batching/
    streaming_out_of_core.py``'s stand-in (11,160 sensors, 6 edges a sensor
    within ±8, weights U(0.3, 1), numpy seed 1) with its ids scrambled by
    a permutation of numpy seed 3."""
    n, deg, offset = 11_160, 6, 8
    rng = np.random.default_rng(1)
    s = np.repeat(np.arange(n), deg)
    r = np.clip(s + rng.integers(-offset, offset + 1, size=s.shape[0]), 0,
                n - 1)
    w = rng.uniform(0.3, 1.0, s.shape[0]).astype(np.float32)
    sigma = np.random.default_rng(3).permutation(n)
    return TGraph.from_edge_index(sigma[np.stack([s, r])], w, num_nodes=n,
                                  device="cpu")


def recovery_edges(n=20_000, deg=40, band=96, seed=2):
    """The reorder-recovery draw: ``deg`` edges a node within ±``band``
    under ids scrambled by a permutation, numpy seed ``seed``; (senders,
    receivers)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, size=n * deg)
    r = np.clip(s + rng.integers(-band, band + 1, size=n * deg), 0, n - 1)
    scram = rng.permutation(n)
    return scram[s].astype(np.int32), scram[r].astype(np.int32)


def test_h100_keeps_the_ids_on_scrambled_pems():
    """Scrambled PeMS: both diffusion operators, f32 tiles at the width
    spmm builds them at (64 windows × 2 · 2 features), min_block_edges 32
    — the H100 model keeps the ids, TPU v5e's reorders."""
    g = scrambled_pems_graph()
    n = g.num_nodes
    width = 64 * 2 * 2
    for p in host_diffusion_norms(g):
        s_all, r_all, _ = p.host_edges()
        s = np.asarray(s_all)[:p.num_edges]
        r = np.asarray(r_all)[:p.num_edges]
        assert not decision(s, r, n, None, width, 32)
        s1, r1 = relabeled(s, r, n)
        assert tb._reorder_pays_off(r, s, r1, s1, n, 128, None, width, 32,
                                    costs=tb.TPU_V5E)


def test_h100_reorders_the_recovery_draw():
    """The recovery draw (N=20,000, 40 edges a node within ±96 under
    scrambled ids), bf16 tiles at F=64, min_block_edges="auto": reorder;
    the plain operator's θ spills more than TPU v5e's 17."""
    n, f = 20_000, 64
    s, r = recovery_edges(n)
    assert decision(s, r, n, torch.bfloat16, f, "auto")
    v5e = tb.tune_min_block_edges(r, s, n, dtype=torch.bfloat16,
                                  expected_f=f, costs=tb.TPU_V5E)
    h100 = tb.tune_min_block_edges(r, s, n, dtype=torch.bfloat16,
                                   expected_f=f)
    assert v5e == 17 and h100 > v5e


def test_auto_bcsr_prices_the_flattened_width(monkeypatch):
    """``spmm`` builds the operator with ``expected_f`` = leading dims ×
    features of the building call's x, under the memo key it had."""
    seen = []
    build = tb.BCSRMatrix.from_graph

    def spy(graph, **kw):
        seen.append(kw)
        return build(graph, **kw)

    monkeypatch.setattr(tb.BCSRMatrix, "from_graph", staticmethod(spy))
    s, r = banded(*DRAWS[2])
    n = DRAWS[2][1]
    g = TGraph.from_edge_index(np.stack([s, r]), np.ones(len(s), np.float32),
                               num_nodes=n, device="cpu")
    x = torch.randn(3, n, 5)
    with config_override(spmm_backend="bcsr"):
        out = spmm(g, x)
        spmm(g, torch.randn(n, 7))
    assert [kw["expected_f"] for kw in seen] == [15]
    assert ("bcsr", "None", "auto") in g._op_cache
    torch.testing.assert_close(out, spmm_segment(g, x), rtol=0,
                               atol=1e-5 * float(out.abs().max()))


@pytest.mark.parametrize("batched", [False, True])
def test_bcsr_spmm_agrees_across_the_two_orders(batched):
    """The operator as the ids come and RCM-reordered give the same
    outputs and x-gradients on the plain path."""
    s, r = banded(*DRAWS[3])
    n = DRAWS[3][1]
    w = np.random.default_rng(0).uniform(0.1, 1.0, len(s)).astype(np.float32)
    g = TGraph.from_edge_index(np.stack([s, r]), w, num_nodes=n,
                               device="cpu")
    plain = tb.BCSRMatrix.from_graph(g)
    rcm = tb.BCSRMatrix.from_graph(g, reorder="rcm")
    assert plain.perm is None and rcm.perm is not None
    rng = np.random.default_rng(1)
    shape = (2, n, 6) if batched else (n, 6)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    res = []
    for mat in (plain, rcm):
        xs = x.clone().requires_grad_()
        out = tb.bcsr_spmm(mat, xs)
        (gx,) = torch.autograd.grad((out * cot).sum(), xs)
        res.append((out.detach(), gx))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
