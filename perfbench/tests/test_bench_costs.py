"""The yardstick's counters against hand counts on a 3-node graph."""

import pytest

from perfbench import costs

# edges 0->1, 1->2, 2->0, 0->2 and a duplicate 0->1
SENDERS = [0, 1, 2, 0, 0]
RECEIVERS = [1, 2, 0, 2, 1]


def test_operator_stats_by_hand():
    s = costs.operator_stats(SENDERS, RECEIVERS, 3)
    # distinct (s, r): (0,1) (0,2) (1,2) (2,0)
    assert s["nnz"] == 4 and s["num_nodes"] == 3
    # P_fwd reads x rows at its columns {1, 2, 0}; its gradient at its
    # rows {0, 1, 2}
    assert s["fwd"] == (3, 3) and s["bwd"] == (3, 3)
    one = costs.operator_stats([0, 0], [1, 1], 3)
    assert one["nnz"] == 1 and one["fwd"] == (1, 1) and one["bwd"] == (1, 1)


def test_need_bound_by_hand():
    # nnz 4, f32: 4 * 8 + 4 * 4 (row pointers) + 3 rows * 5 * 4 + 3 * 5 * 4
    n_bytes = 32 + 16 + 60 + 60
    ops = 2 * 4 * 5
    want = max(n_bytes / 3.35e12, ops / 67e12)
    assert costs.need_bound_s(4, 3, 3, 5) == pytest.approx(want, rel=1e-12)
    assert n_bytes / 3.35e12 > ops / 67e12       # bytes bind


@pytest.mark.parametrize("train", [False, True])
def test_dcrnn_work_by_hand(train):
    # F=1 input, C=2 units, K=2 (one hop a direction), a readout to 1,
    # T=2 steps, batch 3 on 3 nodes: rows 9, basis width 2*2*3 = 12
    model = {"input_dim": 1, "rnn_units": 2, "basis_terms": 2,
             "output_dim": 1}
    flops, hops = costs.dcrnn_work(model, 2, 3, 3, train)
    rows, width = 9, 12
    gates = 2 * rows * width * 4 + 2 * rows * width * 2    # zr and candidate
    readout = 2 * rows * 2 * 1
    want = 2 * (gates + readout)
    # forward: per step 2 gates x 2 directions x 1 hop at batch*(F+C) = 9
    want_hops = [("fwd", False, 9), ("fwd", False, 9),
                 ("bwd", False, 9), ("bwd", False, 9)] * 2
    if train:
        # step 0: the zero state takes no gradient, nor does r through
        # r·0, so only the weights' gradients (as much as forward) and the
        # readout's; no input-gradient product, no backward hop
        want += gates + 2 * readout
        # step 1: the weights' and both bases' inputs' gradients, and a
        # backward hop a basis and direction
        want += 2 * gates + 2 * readout
        want_hops += [("fwd", True, 9)] * 2 + [("bwd", True, 9)] * 2
    assert flops == want
    assert sorted(hops) == sorted(want_hops)
    ops = {d: {"nnz": 4, "shape": (3, 3), "x_rows": (3, 3)}
           for d in ("fwd", "bwd")}
    assert costs.hops_flops(ops, hops) == 2 * 4 * 9 * len(want_hops)


def test_one_step_train_has_no_backward_hop():
    """T=1: the state is zero throughout; nothing upstream of a basis
    takes a gradient."""
    model = {"input_dim": 2, "rnn_units": 4, "basis_terms": 3}
    _, fwd = costs.dcrnn_work(model, 1, 2, 5, False)
    _, train = costs.dcrnn_work(model, 1, 2, 5, True)
    assert train == fwd and len(fwd) == 2 * 2 * 2


@pytest.mark.parametrize("k, train, want", [(2, True, 92), (2, False, 48),
                                            (3, True, 184), (3, False, 96)])
def test_pems_step_hops(k, train, want):
    """The hops the mathematics demands at T=12: 2·2·(K−1) a step forward,
    as many backward from t = 1 on.  The program launches two more a
    train step at K=2 (94, the count its card tests read: the backward
    through the candidate basis at t = 0)."""
    model = {"input_dim": 2, "rnn_units": 2, "basis_terms": k}
    assert len(costs.dcrnn_work(model, 12, 64, 11160, train)[1]) == want


def test_hops_bound_on_a_rectangular_operator():
    """A hop's gradient is the transpose's product: it writes a row for
    each of the operator's columns and reads the rows of x it counts
    second."""
    ops = {"a": {"nnz": 4, "shape": (3, 5), "x_rows": (2, 3)}}
    hops = [("a", False, 7), ("a", True, 7)]
    want = costs.need_bound_s(4, 2, 3, 7) + costs.need_bound_s(4, 3, 5, 7)
    assert costs.hops_bound_s(ops, hops) == pytest.approx(want, rel=1e-12)
    assert costs.hops_flops(ops, hops) == 2 * 2 * 4 * 7
