"""The ``astgcn`` family (``families/astgcn.py``): found by its name, its
work a step and its operator pinned at the tiny and the full size, both
counted by hand on small cases.  (Its tiny dry runs, faults and control
run with every cell's in ``test_bench_dry_run.py`` and
``test_bench_faults.py``.)"""

import collections

import pytest

from perfbench import costs, manifest, traffic
from perfbench.tests._tiny import tiny_cell

CELL = "pems-astgcn-edge"
# (size, train): GEMM operations, {(operator, gradient's, width): hops}
WORK = {
    ("tiny", True): (60235776, {
        ("lhat_rev", False, 384): 1, ("lhat_rev", True, 384): 1,
        ("lhat_rev", False, 1536): 1, ("lhat_rev", True, 1536): 1}),
    ("tiny", False): (20348928, {
        ("lhat_rev", False, 384): 1, ("lhat_rev", False, 1536): 1}),
    ("full", True): (1129865490432, {
        ("lhat_rev", False, 768): 1, ("lhat_rev", True, 768): 1,
        ("lhat_rev", False, 24576): 1, ("lhat_rev", True, 24576): 1}),
    ("full", False): (377067515904, {
        ("lhat_rev", False, 768): 1, ("lhat_rev", False, 24576): 1}),
}


def test_the_family_loads_by_its_name():
    cell = manifest.load_cell(CELL)
    family = manifest.load_family("astgcn")
    assert cell.family.__file__ == family.__file__
    for name in ("build", "REFERENCE", "work", "operators", "tiny"):
        assert hasattr(family, name), name
    assert family.REFERENCE.__file__ == str(
        manifest.HERE / "reference" / "astgcn.py")
    assert cell.config["model"]["family"] == "astgcn"


def test_the_configuration_keeps_the_published_widths():
    m = manifest.load_cell(CELL).config["model"]
    assert (m["nb_block"], m["K"], m["nb_chev_filter"], m["nb_time_filter"],
            m["time_strides"], m["len_input"], m["num_for_predict"]) == (
                2, 3, 64, 64, 1, 12, 12)
    assert m["attention_mode"] == "edge" and m["normalization"] == "sym"


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_work_a_step(size, train):
    cell = tiny_cell(CELL) if size == "tiny" else manifest.load_cell(CELL)
    batch = int(cell.config["recipe"]["batch_size"])
    flops, hops = cell.family.work(cell.config, batch, train)
    assert (flops, dict(collections.Counter(hops))) == WORK[size, train]


def test_operators_at_the_tiny_size():
    cell = tiny_cell(CELL)
    inputs = traffic.make(cell.config, cell.traffic, 0, "cpu")
    ops = cell.family.operators(inputs)
    assert ops == {"lhat_rev": {"nnz": 220, "shape": (48, 48),
                                "x_rows": (48, 48)}}
    _, hops = cell.family.work(cell.config, 16, True)
    assert costs.hops_flops(ops, hops) == 2 * 220 * 2 * (384 + 1536)


def test_lhat_stats_by_hand():
    """Edges 0->1, 0->2, a duplicate 0->1 and a self-loop 2->2: L̂ has the
    nonzeros (0, 1) and (0, 2) (the loop is removed, the diagonal is 0);
    a product reads x at columns {1, 2}, its gradient at row {0}."""
    family = manifest.load_family("astgcn")
    st = family.lhat_stats([0, 0, 0, 2], [1, 2, 1, 2], 3)
    assert st == {"nnz": 2, "shape": (3, 3), "x_rows": (2, 1)}


def test_astgcn_work_by_hand():
    """One block, 1 feature and filter, K = 2, T = 1, batch 1, N = 2, one
    edge: each product's operations forward, and for a train step once
    more for each operand that takes a gradient (the data takes none)."""
    family = manifest.load_family("astgcn")
    model = {"nb_block": 1, "in_channels": 1, "K": 2, "nb_chev_filter": 1,
             "nb_time_filter": 1, "num_for_predict": 1}
    # (forward operations, operands taking a gradient)
    terms = {"X·U1": (4, 1), "·U2": (4, 2), "U3·X": (4, 1),
             "lhs·rhs": (4, 2), "Ve·σ": (2, 2), "X·E": (4, 1),
             "X̃·W1, ·W2, W3·X̃": (12, 2), "scores": (6, 2),
             "T_k·Θ_k": (8, 2), "hop 1 (E + 2N = 5 entries)": (10, 2),
             "time conv": (12, 2), "residual": (4, 1), "head": (4, 2)}
    fwd = sum(ops for ops, _ in terms.values())
    train = sum(ops * (1 + g) for ops, g in terms.values())
    assert family.astgcn_work(model, 1, 1, 2, 1, False) == (fwd, [])
    assert family.astgcn_work(model, 1, 1, 2, 1, True) == (train, [])
    # K = 3: one product with L̂ a block past T_1, and its gradient's
    _, hops = family.astgcn_work(dict(model, K=3), 1, 1, 2, 1, True)
    assert hops == [("lhat_rev", False, 1), ("lhat_rev", True, 1)]
