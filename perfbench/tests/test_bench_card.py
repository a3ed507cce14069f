"""On the card: the command itself, a short run of each one-card cell
(run with ``-m cuda``; skipped without a card)."""

import json

import pytest

from perfbench import manifest, run

CELLS = [w["name"] for w in manifest.load_benchmark()["workloads"]
         if w["chips"] == 1]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_the_card(card, name, capsys):
    rc = run.main(["--workload", name, "--seed", str(2**31 + 3),
                   "--seconds", "2", "--trace", "1"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    for m in ("spmm_roofline", "step_mfu"):
        assert 0 < res["metrics"][m]["value"] <= 100
