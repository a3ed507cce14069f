"""A CPU dry run of each cell at a tiny size: the harness drives the whole
run (set-up, window, trace, the reference's comparison) past its look for
a card, and prints one last line with the contract's keys."""

import json
import sys

import pytest

from perfbench import manifest, run
from perfbench.tests._tiny import tiny_cell

CELLS = [w["name"] for w in manifest.load_benchmark()["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_dry_run_prints_one_result_line(name, trace, capsys):
    cell = tiny_cell(name)
    assert run.report(cell, 2**31 + 7, 0.2, bool(trace), "cpu") == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[-1])
    assert KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert res["device"]["count"] == cell.chips
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    assert set(res["metrics"]) <= set(units)
    for name_, m in res["metrics"].items():
        assert m["unit"] == units[name_]
    if not trace:
        assert set(res["metrics"]) == set(units)
    # the numbers compared, each beside its limit, end standard error
    err = out.err.strip().splitlines()
    assert [line.split()[1] for line in err[-4:]] == list(res["checks"])


def test_dry_run_on_the_segment_path():
    """Above the port's dense threshold (4,096 sensors) the CPU takes the
    segment path, the reference's counterpart of the card's kernel."""
    cell = tiny_cell("pems-pgti-scrambled", num_nodes=4200)
    cell.config["recipe"]["batch_size"] = 8
    from perfbench import harness
    res = harness.run_cell(cell, 3, 0.1, False, "cpu")
    assert res["correct"] is True, res["checks"]


def test_the_command_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "pems-pgti", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    """Module names are compared whole: the port's name begins with the
    JAX package's and does not count; a loaded ``jax`` does."""
    import types

    import pytorch_geometric_temporal_tpu_torch  # noqa: F401

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax"))
    rc = run.report(tiny_cell("pems-pgti"), 1, 0.1, False, "cpu")
    assert rc == 3
    out = capsys.readouterr()
    assert out.out == "" and "['jax']" in out.err
