"""Edge-mode ASTGCN on the CPU: hop 1 as an autograd Function
(``_WeightedHop``) against the per-edge message formulation it replaced,
its counter and the model's spans; the card kernel's CSR orders, plan and
loops (``ops/weighted_hop.py``) in float64; and the benchmark's ASTGCN family
(``perfbench/families/astgcn.py``) against its plain reference
(``perfbench/reference/astgcn.py``) at a tiny size."""

import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_geometric_temporal_tpu_torch import _counters
from pytorch_geometric_temporal_tpu_torch.models import ASTGCN
from pytorch_geometric_temporal_tpu_torch.models.attention import astgcn
from pytorch_geometric_temporal_tpu_torch.ops import Graph, weighted_hop

SPANS = ("astgcn.temporal_attention", "astgcn.spatial_attention",
         "astgcn.cheb", "astgcn.hop1", "astgcn.time_conv", "astgcn.hop1_grad")


def _graph(n=30, e=150, seed=0):
    """Random edges, duplicates and self-loops among them."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, e))
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    return Graph.from_edge_index(ei, w, num_nodes=n, device="cpu")


def _rev(g):
    return astgcn._reversed(astgcn._lhat_graph(g, "sym"))


def _message_hop(rev, x, w):
    """Hop 1 as it was before the Function: per-edge messages formed under
    autograd, which keeps each chunk's gathered block for the backward."""
    B, T, _, F = x.shape
    step = max(1, weighted_hop._MESSAGE_CHUNK // max(B * w.shape[1] * F,
                                                     1))
    w = w[:, None, :, None]
    outs = []
    for lo in range(0, T, step):
        xt = x[:, lo:lo + step]
        msgs = xt.index_select(2, rev.senders) * w
        outs.append(xt.new_zeros(xt.shape[:2] + (rev.num_nodes, F))
                    .index_add_(2, rev.receivers, msgs))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _inputs(rev, b=3, t=5, f=4, dtype=torch.float32, seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, rev.num_nodes, f, generator=gen, dtype=dtype)
    w = torch.randn(b, rev.senders.shape[0], generator=gen, dtype=dtype)
    return x.requires_grad_(True), w.requires_grad_(True)


def _value_and_grads(hop, rev, x, w):
    out = hop(rev, x, w)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    gx, gw = torch.autograd.grad(out, (x, w), g)
    return out.detach(), gx, gw


def test_temporal_vector_init_draws_the_same_numbers():
    """"glorot" maps the very numbers "uniform" (PGT's U[0, 1), the
    default) draws onto ±sqrt(6/(length + 1)), so the option changes U1 and
    U3 alone and every other parameter's draw stays as it was."""
    def build(**kw):
        return ASTGCN(2, 2, 3, 4, 4, 1, 3, 6, 30, "sym",
                      attention_mode="edge", device="cpu",
                      generator=torch.Generator().manual_seed(7), **kw)

    default, uni, glo = build(), build(temporal_vector_init="uniform"), \
        build(temporal_vector_init="glorot")
    for (name, d), (_, u), (_, g) in zip(default.named_parameters(),
                                         uni.named_parameters(),
                                         glo.named_parameters()):
        torch.testing.assert_close(d, u, rtol=0, atol=0)
        if name.split(".")[-1] in ("U1", "U3"):
            limit = (6.0 / (d.numel() + 1)) ** 0.5
            torch.testing.assert_close(g, (2.0 * u - 1.0) * limit)
            assert float(g.detach().abs().max()) <= limit
        else:
            torch.testing.assert_close(g, u, rtol=0, atol=0)
    with pytest.raises(ValueError, match="vector_init"):
        build(temporal_vector_init="normal")


@pytest.mark.parametrize("steps_per_chunk", [None, 1, 2])
def test_hop1_function_equals_the_message_formulation(monkeypatch,
                                                      steps_per_chunk):
    """Whole, one time step and two time steps a chunk: the same forward
    to the bit (the same gathers, products and sums in the same order);
    both gradients to f32 round-off (the weights' sums over chunks add up
    in another order)."""
    rev = _rev(_graph())
    x, w = _inputs(rev)
    if steps_per_chunk is not None:
        monkeypatch.setattr(weighted_hop, "_MESSAGE_CHUNK",
                            x.shape[0] * w.shape[1]
                            * x.shape[3] * steps_per_chunk)
    got = _value_and_grads(astgcn._weighted_hop, rev, x, w)
    want = _value_and_grads(_message_hop, rev, x, w)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))


def test_hop1_gradcheck_in_float64(monkeypatch):
    rev = _rev(_graph(n=7, e=20, seed=3))
    x, w = _inputs(rev, b=2, t=3, f=2, dtype=torch.float64)
    monkeypatch.setattr(weighted_hop, "_MESSAGE_CHUNK", 2 * w.shape[1] * 2)

    def hop(x, w):
        return astgcn._WeightedHop.apply(x, w, rev.senders, rev.receivers,
                                         rev.num_nodes)

    assert torch.autograd.gradcheck(hop, (x, w))


@pytest.mark.parametrize("weights_grad", [True, False])
def test_hop1_counter_counts_message_bytes(weights_grad):
    """(calls, bytes): the forward forms one (B, T, E, F) block of f32
    messages; the backward gathers the output's gradient at the edges and,
    where the weights take a gradient, x again."""
    rev = _rev(_graph())
    x, w = _inputs(rev)
    w.requires_grad_(weights_grad)
    block = x.shape[0] * x.shape[1] * w.shape[1] * x.shape[3] * 4
    before = _counters.read()
    out = astgcn._weighted_hop(rev, x, w)
    assert _counters.counted_since(before)["astgcn_hop1"] == (1, block)
    out.sum().backward()
    want = (2, block * (3 if weights_grad else 2))
    assert _counters.counted_since(before)["astgcn_hop1"] == want
    with torch.no_grad():
        astgcn._weighted_hop(rev, x, w)
    assert _counters.counted_since(before)["astgcn_hop1"] == (
        want[0] + 1, want[1] + block)


def test_hop1_keeps_no_messages_for_the_backward():
    """The Function saves x, the weights and the edge index; the message
    formulation also kept the gathered (B, T, E, F) block."""
    rev = _rev(_graph())
    x, w = _inputs(rev)

    def saved_numel(hop):
        sizes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: sizes.append(t.numel()) or t, lambda t: t):
            hop(rev, x, w)
        return sum(sizes)

    edges = rev.senders.shape[0]
    own = x.numel() + w.numel() + 2 * edges
    assert saved_numel(astgcn._weighted_hop) == own
    assert saved_numel(_message_hop) >= x.numel() // rev.num_nodes * edges


def _tiny_astgcn(n=30):
    g = _graph(n=n)
    model = ASTGCN(nb_block=2, in_channels=2, K=3, nb_chev_filter=4,
                   nb_time_filter=4, time_strides=1, num_for_predict=3,
                   len_input=4, num_of_vertices=n, normalization="sym",
                   attention_mode="edge", device="cpu",
                   generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, n, 2, 4, generator=torch.Generator().manual_seed(1))
    return model, g, x


def test_spans_in_a_profiler_session():
    model, g, x = _tiny_astgcn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x, g).square().sum().backward()
    p = _counters.SPAN_PREFIX
    spans = [(e.name[len(p):], e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith(p + "astgcn.")]
    names = [s[0] for s in spans]
    # each of the two blocks, forward and hop 1's backward
    assert {name: names.count(name) for name in SPANS} == dict.fromkeys(
        SPANS, 2)
    cheb = [s for s in spans if s[0] == "astgcn.cheb"]
    for _, a, b in (s for s in spans if s[0] == "astgcn.hop1"):
        assert any(c[1] <= a and b <= c[2] for c in cheb)


def test_no_span_without_a_session(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler on")

    model, g, x = _tiny_astgcn()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    model(x, g).square().sum().backward()
    assert _counters.span("astgcn.hop1") is _counters.span("astgcn.cheb")


# -- the card's hop 1 (ops/weighted_hop.py, csrc/weighted_hop.cu): its CSR
# -- orders, its plan and a transcription of its loops -----------------------

def _edge_lists(kind, n=12, seed=4):
    """(senders, receivers, num_rows): duplicates and self-loops among
    random entries, padding entries (0 -> 0, the layout L̂ pads with),
    isolated nodes, and a hub row."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        s, r = rng.integers(0, n, 40), rng.integers(0, n, 40)
        s[:3], r[:3] = 5, 5            # a self-loop, twice
        s[3:6], r[3:6] = 2, 7          # a duplicate edge, three times
    elif kind == "padded":
        s = np.concatenate([rng.integers(1, n, 30), np.zeros(10, int)])
        r = np.concatenate([rng.integers(1, n, 30), np.zeros(10, int)])
    elif kind == "isolated":
        # nodes 0, 3 and the last three have no entry either way
        live = np.array([1, 2, 4, 5, 6, 7, 8])
        s, r = rng.choice(live, 25), rng.choice(live, 25)
    elif kind == "hub":
        s = np.concatenate([rng.integers(0, n, 80), rng.integers(0, n, 10)])
        r = np.concatenate([np.full(80, 3), rng.integers(0, n, 10)])
        perm = rng.permutation(90)
        s, r = s[perm], r[perm]
    else:
        raise ValueError(kind)
    return torch.from_numpy(s), torch.from_numpy(r), n


@pytest.mark.parametrize("by", ["receiver", "sender"])
@pytest.mark.parametrize("kind", ["random", "padded", "isolated", "hub"])
def test_hop_csr_orders(kind, by):
    """Each row's entries, in the edge list's order, with their other end
    and their index: every entry once, rows without entries empty."""
    s, r, n = _edge_lists(kind)
    rows, others = (r, s) if by == "receiver" else (s, r)
    csr = weighted_hop.hop_csr(rows, others, n)
    assert all(t.dtype == torch.int32 for t in csr)
    order = np.argsort(rows.numpy(), kind="stable")
    np.testing.assert_array_equal(csr.entry.numpy(), order)
    np.testing.assert_array_equal(csr.other.numpy(), others.numpy()[order])
    counts = np.bincount(rows.numpy(), minlength=n)
    np.testing.assert_array_equal(csr.ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))
    for i in range(n):
        seg = csr.entry[csr.ptr[i]:csr.ptr[i + 1]].long()
        assert (rows[seg] == i).all() and (seg.diff() > 0).all()
    if kind == "isolated":
        assert (counts[[0, 3, n - 3, n - 2, n - 1]] == 0).all()
    if kind == "hub" and by == "receiver":
        assert int(csr.ptr[4] - csr.ptr[3]) >= 80


@pytest.mark.parametrize("p", [1, 3, 24, 35, 768, 1000, 1028, 2100, 3000,
                               4096])
@pytest.mark.parametrize("aligned", [True, False])
def test_hop_plan_covers_each_row_once(p, aligned):
    """The chunks cover a row's p values once each, in order, each fits a
    warp's registers with as few units a lane as the kernel is built for;
    16-byte units only where the rows lie on the 16-byte grid, and then
    every chunk starts and ends on it."""
    aligned = aligned and p % 4 == 0
    vec, units, chunk, chunks = weighted_hop.hop_plan(p, aligned)
    built = weighted_hop._UNITS[vec]
    assert vec == (4 if aligned else 1) and units in built
    assert chunk <= 32 * vec * units and chunk % vec == 0
    smaller = [u for u in built if u < units]
    assert not smaller or chunk > 32 * vec * smaller[-1]
    spans = list(_chunks(p, chunk))
    assert len(spans) == chunks
    at = 0
    for start, length in spans:
        assert start == at and 0 < length <= chunk
        assert start % vec == 0 and length % vec == 0
        at += length
    assert at == p


def _flat(t):
    """The buffer under ``t`` (a permutation of a dense buffer), in
    memory order."""
    return torch.as_strided(t, (t.numel(),), (1,))


def _chunks(p, chunk):
    """(start, length) of each chunk of a row of p values, in turn."""
    for start in range(0, p, chunk):
        yield start, min(chunk, p - start)


def _kernel_forward(x, w, csr, num_nodes, chunk):
    """``weighted_hop_fwd_kernel`` transcribed: a (batch, receiver) row at
    a time, its chunks in turn, the sender rows gathered and summed in the
    CSR's order, written once."""
    x = weighted_hop.as_rows(x)
    out = weighted_hop.empty_rows(x, num_nodes)
    p = x.shape[1] * x.shape[3]
    xf, of = _flat(x), _flat(out)
    (xsb, xsn), (osb, osn) = (weighted_hop._row_strides(t) for t in (x, out))
    ptr, col, ent = (t.tolist() for t in csr)
    for b in range(x.shape[0]):
        for r in range(num_nodes):
            for start, length in _chunks(p, chunk):
                at = torch.arange(start, start + length)
                acc = x.new_zeros(length)
                for e in range(ptr[r], ptr[r + 1]):
                    acc = acc + w[b, ent[e]] * xf[b * xsb + col[e] * xsn + at]
                of[b * osb + r * osn + at] = acc
    return out


def _kernel_backward(g, x, w, csr, chunk):
    """``weighted_hop_bwd_kernel`` transcribed: a (batch, sender) row at a
    time, its chunks in turn, the receivers' g rows gathered in the CSR's
    order, g_x written once, g_w summed over the chunks."""
    g, x = weighted_hop.as_rows(g), weighted_hop.as_rows(x)
    gx = weighted_hop.empty_rows(g, x.shape[2])
    gw = w.new_empty(w.shape)
    p = g.shape[1] * g.shape[3]
    gf, xf, gxf = _flat(g), _flat(x), _flat(gx)
    (gsb, gsn), (xsb, xsn), (gxsb, gxsn) = (
        weighted_hop._row_strides(t) for t in (g, x, gx))
    ptr, col, ent = (t.tolist() for t in csr)
    for b in range(x.shape[0]):
        for u in range(x.shape[2]):
            for c, (start, length) in enumerate(_chunks(p, chunk)):
                at = torch.arange(start, start + length)
                xv = xf[b * xsb + u * xsn + at]
                acc = x.new_zeros(length)
                for e in range(ptr[u], ptr[u + 1]):
                    gv = gf[b * gsb + col[e] * gsn + at]
                    acc = acc + w[b, ent[e]] * gv
                    d = (gv * xv).sum()
                    gw[b, ent[e]] = d if c == 0 else gw[b, ent[e]] + d
                gxf[b * gxsb + u * gxsn + at] = acc
    return gx, gw


def _laid_out(t, layout):
    """``t`` (B, T, N, F) with its values laid out as ``layout`` names
    the buffer's axes."""
    perm = ["BTNF".index(a) for a in layout]
    back = [layout.index(a) for a in "BTNF"]
    return t.permute(*perm).contiguous().permute(*back)


@pytest.mark.parametrize("chunk", [10 ** 6, 8, 3])
@pytest.mark.parametrize("x_layout,g_layout", [
    ("BFNT", "NBTF"),   # block 2's T_0, copied; g as the consumers give it
    ("BTNF", "NBTF"),   # T_0 from contiguous windows, copied
    ("BNFT", "NBTF"),   # rows t fastest, copied
    ("NBTF", "BTNF"),   # x's rows dense, g's copied
    ("BTFN", "BFTN"),   # neither axis contiguous: both copied
    ("BNTF", "NBTF"),   # both dense: read where they lie
])
def test_kernel_transcription_matches_the_chunked_path(x_layout, g_layout,
                                                       chunk):
    """The kernel's loops in segment order, in float64, against
    ``_WeightedHop``'s chunked path: the value, g_x and g_w.  ``chunk``
    cuts a row of T·F = 32 values: whole, into 4 chunks, into 11 (the
    last shorter)."""
    s, r, n = _edge_lists("hub", n=10)
    w = torch.randn(2, s.shape[0], dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    w[:, :5] = 0.0                       # entries weighted 0, as padding
    gen = torch.Generator().manual_seed(6)
    x = _laid_out(torch.randn(2, 4, n, 8, dtype=torch.float64,
                              generator=gen), x_layout)
    g = _laid_out(torch.randn(2, 4, n, 8, dtype=torch.float64,
                              generator=gen), g_layout)
    by_r, by_s = weighted_hop.hop_csr(r, s, n), weighted_hop.hop_csr(s, r, n)

    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want = astgcn._WeightedHop.apply(xr, wr, s, r, n)
    want_gx, want_gw = torch.autograd.grad(want, (xr, wr), g)

    out = _kernel_forward(x, w, by_r, n, chunk)
    assert weighted_hop.dense_rows(out) and out.shape == want.shape
    assert out.permute(2, 0, 1, 3).is_contiguous()
    gx, gw = _kernel_backward(g, x, w, by_s, chunk)
    for got, ref in ((out, want), (gx, want_gx), (gw, want_gw)):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape,layout,dense", [
    ((2, 4, 3, 8), "NBTF", True),     # the kernel's own output
    ((2, 4, 3, 8), "BNTF", True),
    ((2, 4, 3, 8), "BTNF", False),    # block 1's T_0: runs of F, gaps
    ((2, 4, 3, 8), "BFNT", False),    # block 2's T_0: runs of T, gaps
    ((2, 4, 3, 8), "BNFT", False),    # t fastest, no gaps
    ((2, 4, 3, 8), "NTBF", False),
    ((2, 4, 3, 8), "BTFN", False),    # neither t nor f contiguous
    ((2, 1, 3, 8), "BTNF", True),     # one time step: f contiguous
    ((2, 4, 3, 1), "BFNT", True),     # one feature: t contiguous
])
def test_rows_are_copied_unless_dense(shape, layout, dense):
    """A row is read where it lies only as T·F contiguous values, t-major;
    anything else is copied once into rows of an (N, B, T, F) buffer, and
    the bytes are counted."""
    t = _laid_out(torch.randn(shape, generator=torch.Generator()
                              .manual_seed(0)), layout)
    assert weighted_hop.dense_rows(t) == dense
    before = weighted_hop.weighted_hop_counts()[2]
    rows = weighted_hop.as_rows(t)
    assert (rows is t) == dense
    assert weighted_hop.weighted_hop_counts()[2] - before == (
        0 if dense else t.numel() * 4)
    assert weighted_hop.dense_rows(rows) and torch.equal(rows, t)
    if not dense:
        assert rows.permute(2, 0, 1, 3).is_contiguous()


def test_a_tensor_off_the_cpu_never_reaches_the_message_path():
    """Anything but a CPU tensor goes to the kernel, which takes f32 on
    an NVIDIA card alone and raises otherwise; the message path forms no
    message for it."""
    rev = _rev(_graph())
    x, w = _inputs(rev)
    before = _counters.read()
    with pytest.raises(ValueError, match="no kernel"):
        astgcn._weighted_hop(rev, x.detach().to("meta"),
                             w.detach().to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        weighted_hop.weighted_hop_forward(
            x.detach(), w.detach(),
            weighted_hop.hop_csr(rev.receivers, rev.senders, 30), 30)
    with pytest.raises(TypeError, match="f32"):
        weighted_hop.weighted_hop_forward(x.detach().double(), w.detach(),
                                          None, 30)
    assert _counters.counted_since(before)["astgcn_hop1"][1] == 0
    assert _counters.counted_since(before)["weighted_hop"] == (0, 0, 0)


# the profiler's names of the hop-1 kernels and of the fused kernel (an
# H100's trace)
HOP_KERNEL_NAMES = (
    "void (anonymous namespace)::weighted_hop_fwd_kernel<4, 6>(float "
    "const*, long, long, float const*, long, long, int const*, int const*, "
    "int const*, float*, long, long, int, int, int, int)",
    "void (anonymous namespace)::weighted_hop_bwd_kernel<4, 1>(float "
    "const*, long, long, float const*, long, long, float const*, long, "
    "long, int const*, int const*, int const*, float*, long, long, float*, "
    "long, int, int, int, int)")
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
    ({HOP_KERNEL_NAMES[0]: [0.004, 4], HOP_KERNEL_NAMES[1]: [0.006, 4],
      SPMM_KERNEL_NAME: [0.5, 8]}, [("train", 32)] * 2, 5.0),
    ({SPMM_KERNEL_NAME: [0.5, 8]}, [("train", 32)] * 2, None),
    ({HOP_KERNEL_NAMES[0]: [0.004, 4]}, [], None),
    (None, [("train", 32)], None),
])
def test_hop1_ms_per_step_reads_the_kernels_by_name(kernels, kinds, want):
    """``perfbench/metrics/hop1_ms_per_step.py``: the hop-1 kernels' device
    ms a train step, silent where none ran (the parent's program) or no
    train step was traced; the kernels' names are apart from the
    aggregation kernels that ``spmm_ms_per_step`` reads."""
    from perfbench import manifest
    from perfbench.metrics import _common

    metric = manifest.load_metric("hop1_ms_per_step")
    got = metric.read(_Run(kernels, kinds))
    assert got == (None if want is None else pytest.approx(want))
    assert all(metric.KERNELS.search(k) for k in HOP_KERNEL_NAMES)
    assert not any(_common.SPMM_KERNELS.search(k) for k in HOP_KERNEL_NAMES)
    assert not metric.KERNELS.search(SPMM_KERNEL_NAME)


# -- the benchmark's family against its plain reference ----------------------

def _family(num_nodes, batch, seed=0):
    from perfbench import harness, traffic
    from perfbench.tests._tiny import tiny_cell

    cell = tiny_cell("pems-astgcn-edge", num_nodes=num_nodes)
    cell.config["recipe"]["batch_size"] = batch
    inputs = traffic.make(cell.config, cell.traffic, seed, "cpu")
    prog = harness.build_program(cell.family, cell.config, inputs, seed,
                                 "cpu")
    ref = cell.family.REFERENCE
    series = torch.from_numpy(inputs.series)
    lags = int(cell.config["recipe"]["seq_len"])
    starts = inputs.starts[0]
    batches = [ref.windows(series, starts[i * batch:(i + 1) * batch], lags)
               for i in range(3)]
    ops = ref.Operators(inputs.senders, inputs.receivers, inputs.weights,
                        inputs.num_nodes, "cpu")
    return cell, inputs, prog, ref, ops, batches


def _float64_ops(ref, inputs):
    """The reference's operators with L̂'s values in float64."""
    ops = ref.Operators(inputs.senders, inputs.receivers, inputs.weights,
                        inputs.num_nodes, "cpu")
    ops.lhat = ops.lhat.double()
    vals = torch.zeros(ops.nnz, dtype=torch.float64).index_add_(
        0, ops.slot, ops.lhat)
    ops.mat, ops.mat_t = ops.csr(vals), ops.csr_t(vals)
    return ops


@pytest.mark.parametrize("num_nodes,batch", [(48, 4), (4200, 2)])
def test_family_matches_the_reference(num_nodes, batch):
    """48 sensors take the port's dense route for the hops past T_1 on the
    CPU, 4,200 its segment path (above the dense threshold); hop 1 is the
    Function in both.  Both sides sum the same f32 products in other
    orders (a sparse product against gathers and index_add; a convolution
    against a product over shifted copies; LayerNorm's variance as
    E[x²] − E[x]² against E[(x − μ)²]) and build L̂ in f32 against
    float64 rounded to f32.  Both pass through LayerNorm's 1/σ, large
    where a node's few channels nearly agree: the forward's largest gap
    reads 3.4e-7 and 6.0e-7 of its scale (48 and 4,200 sensors), against
    a limit of 1e-4; the loss, a mean, 3.0e-8 and 1.0e-7, limit 1e-5.
    The gradients also pass through the attention's sigmoids, sums that
    nearly cancel: a leaf's largest gap reads 4.8e-7 and 3.1e-5 of the
    larger of its largest entry and the median leaf's, so the limit is
    4e-4.  The parameters' change over three Adam steps is measured as
    the benchmark's ``step`` reading (``check.norm_gap`` over the leaves
    whose gradient is above round-off): Adam moves an entry whose gradient
    is round-off by up to lr either way, so single entries are not
    compared; it reads 5.1e-8 and 4.4e-7, against a limit of 1e-4.

    That comparison means something only where the three steps are well
    conditioned: on some draws an entry's gradient in step 2 or 3 is a
    sum that cancels to a few ulps, Adam turns it into a move of lr, and
    the rounding of the start alone decides the change (at 4,200 sensors
    seed 3 reads 0.137 between two float64 runs whose starts differ by
    f32's rounding, and 0.024 between program and reference).  So the
    test first takes the reference in float64 from the start and from the
    start moved by up to 2⁻²⁴ of each entry: the two must agree to the
    step's limit (they read 2.2e-8 and 1.1e-7 here)."""
    from perfbench import check

    cell, inputs, prog, ref, ops, batches = _family(num_nodes, batch)
    model, trainer = cell.config["model"], prog.trainer
    names = prog.names
    params0 = {names[n]: p.detach().clone()
               for n, p in prog.model.named_parameters()}
    means = torch.from_numpy(inputs.means)
    stds = torch.from_numpy(inputs.stds)
    x, y = batches[0]

    out = trainer.apply_fn(x)
    want = ref.forward(params0, ops, x, model)
    assert out.shape == want.shape == (batch, 12, num_nodes, 1)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))

    loss = trainer.loss_fn(out, y)
    grads = dict(zip((names[n] for n, _ in prog.model.named_parameters()),
                     torch.autograd.grad(loss, list(
                         prog.model.parameters()))))
    r_loss, r_grads = ref.loss_and_grads(params0, ops, x, y, means, stds,
                                         model, block=1)
    assert r_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    assert set(grads) == set(r_grads)
    med = statistics.median(float(v.abs().max()) for v in r_grads.values())
    for k, g in grads.items():
        scale = max(float(r_grads[k].abs().max()), med)
        assert float((g - r_grads[k]).abs().max()) <= 4e-4 * scale, k

    lr = float(cell.config["recipe"]["lr"])
    for bx, by in batches:
        trainer.train_step(bx, by)
    _, first, want3 = ref.train(params0, ops, batches, means, stds, model,
                                lr, block=1)
    norms = {k: float(v.norm()) for k, v in first.items()}
    med = statistics.median(norms.values())
    moved = {k for k in norms if norms[k] >= 1e-3 * med}
    assert len(moved) > len(norms) // 2
    ops64 = _float64_ops(ref, inputs)
    batches64 = [(bx.double(), by.double()) for bx, by in batches]
    p64 = {k: v.double() for k, v in params0.items()}
    u = torch.Generator().manual_seed(0)
    moved64 = {k: v * (1 + (2 * torch.rand(v.shape, generator=u,
                                           dtype=torch.float64) - 1)
                       * 2.0 ** -24) for k, v in p64.items()}
    ends = [ref.train(start, ops64, batches64, means.double(),
                      stds.double(), model, lr, block=1)[2]
            for start in (p64, moved64)]
    witness = check.norm_gap({k: ends[1][k] - moved64[k] for k in p64},
                             {k: ends[0][k] - p64[k] for k in p64},
                             keep=moved)
    assert witness <= 1e-4
    got3 = {names[n]: p.detach() for n, p in prog.model.named_parameters()}
    gap = check.norm_gap({k: got3[k] - params0[k] for k in params0},
                         {k: want3[k] - params0[k] for k in params0},
                         keep=moved)
    assert gap <= 1e-4
