"""DCRNN through its family (``families/dcrnn.py``) reads what the harness
read before the model became the family's: the same initial parameters
bit for bit, the same work a step and the same operator counts.  Every
pinned value was computed by the harness at the commit before families."""

import collections
import hashlib

import pytest
import torch

from perfbench import costs, harness, manifest, traffic
from perfbench.tests._tiny import tiny_cell

CELLS = {"dcrnn-pgti-pems": "pems-pgti", "dcrnn-li2018-pems": "pems-dcrnn64"}
DIGEST = {
    "dcrnn-pgti-pems":
        "e6839403696bc3a3af9b1c44cafdffa4233eea540d020674f18a29e6702bc7c0",
    "dcrnn-li2018-pems":
        "d0730f2c38b7f0762f216b811c5adb10f284eb6603a516ca532603e1a6dbdbe3",
}
NAMES = {"seq.cell.w_zr": "w_zr", "seq.cell.b_zr": "b_zr",
         "seq.cell.w_h": "w_h", "seq.cell.b_h": "b_h"}
READOUT = {"readout.kernel": "w_out", "readout.bias": "b_out"}
# (config, size, train): GEMM operations, {(operator, gradient's, width):
# hops}
WORK = {
    ("dcrnn-pgti-pems", "tiny", True): (5160960, {
        ("fwd", False, 64): 24, ("bwd", False, 64): 24,
        ("fwd", True, 64): 22, ("bwd", True, 64): 22}),
    ("dcrnn-pgti-pems", "tiny", False): (1769472, {
        ("fwd", False, 64): 24, ("bwd", False, 64): 24}),
    ("dcrnn-pgti-pems", "full", True): (4799692800, {
        ("fwd", False, 256): 24, ("bwd", False, 256): 24,
        ("fwd", True, 256): 22, ("bwd", True, 256): 22}),
    ("dcrnn-pgti-pems", "full", False): (1645608960, {
        ("fwd", False, 256): 24, ("bwd", False, 256): 24}),
    ("dcrnn-li2018-pems", "tiny", True): (77856768, {
        ("fwd", False, 160): 48, ("bwd", False, 160): 48,
        ("fwd", True, 160): 44, ("bwd", True, 160): 44}),
    ("dcrnn-li2018-pems", "tiny", False): (26689536, {
        ("fwd", False, 160): 48, ("bwd", False, 160): 48}),
    ("dcrnn-li2018-pems", "full", True): (3804647915520, {
        ("fwd", False, 4224): 48, ("bwd", False, 4224): 48,
        ("fwd", True, 4224): 44, ("bwd", True, 4224): 44}),
    ("dcrnn-li2018-pems", "full", False): (1304419368960, {
        ("fwd", False, 4224): 48, ("bwd", False, 4224): 48}),
}
# (config, train) at the tiny size, seed 0: GEMM and hop operations, and
# Σ need_bound of the hops (s), as step_mfu and spmm_roofline sum them
TOTALS = {
    ("dcrnn-pgti-pems", True): (7904768, 7.314961194029843e-07),
    ("dcrnn-pgti-pems", False): (3201024, 3.8165014925373104e-07),
    ("dcrnn-li2018-pems", True): (91575808, 3.487761194029861e-06),
    ("dcrnn-li2018-pems", False): (33847296, 1.8197014925373167e-06),
}


def _tiny(config):
    cell = tiny_cell(CELLS[config])
    return cell, traffic.make(cell.config, cell.traffic, 0, "cpu")


def _digest(model) -> str:
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        t = p.detach().cpu().contiguous()
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(CELLS))
def test_the_same_initial_parameters(config):
    cell, inputs = _tiny(config)
    prog = harness.build_program(cell.family, cell.config, inputs, 0, "cpu")
    assert _digest(prog.model) == DIGEST[config]
    want = dict(NAMES, **READOUT) if "li2018" in config else NAMES
    assert prog.names == want


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("config", sorted(CELLS))
def test_the_same_work_a_step(config, size, train):
    if size == "tiny":
        cell = tiny_cell(CELLS[config])
    else:
        cell = manifest.load_cell(CELLS[config])
    batch = int(cell.config["recipe"]["batch_size"])
    flops, hops = cell.family.work(cell.config, batch, train)
    assert (flops, dict(collections.Counter(hops))) == WORK[config, size,
                                                            train]


@pytest.mark.parametrize("config", sorted(CELLS))
def test_the_same_operators(config):
    cell, inputs = _tiny(config)
    ops = cell.family.operators(inputs)
    want = {"nnz": 233, "shape": (48, 48), "x_rows": (48, 48)}
    assert ops == {"fwd": want, "bwd": want}
    for train in (True, False):
        gemm, hops = cell.family.work(cell.config, 16, train)
        total = gemm + costs.hops_flops(ops, hops)
        assert (total, costs.hops_bound_s(ops, hops)) == TOTALS[config, train]


def test_the_reference_is_the_familys_and_runs_with_tf32_off(monkeypatch):
    from perfbench import check

    cell, inputs = _tiny("dcrnn-pgti-pems")
    ref = cell.family.REFERENCE
    assert ref.__file__ == str(manifest.HERE / "reference" / "dcrnn.py")
    seen, train = [], ref.train

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return train(*args)

    monkeypatch.setattr(ref, "train", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    prog = harness.build_program(cell.family, cell.config, inputs, 0, "cpu")
    params0 = {prog.names[n]: p.detach().clone()
               for n, p in prog.model.named_parameters()}
    check.reference_run(cell, inputs, [inputs.starts[0][:4]], params0, "cpu")
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
