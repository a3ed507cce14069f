#!/usr/bin/env python3
"""Where edge-mode ASTGCN's two aggregation paths part, on one NVIDIA card.

    python3 tools/astgcn_edge_noise.py [seeds] [repeats]

Runs the sequence of ``tests/test_torch_cuda.py::
test_edge_mode_astgcn_tiles_the_reversed_lhat_once`` (N=5000, 63,000
banded edges, two blocks of K=3, 8/8 filters, 6 steps in, B=2, weights
from seed 0; a fresh graph, so the first forward tiles the operator; that
forward through the fused kernel with autograd on, its backward, a second
forward, then one with ``spmm_backend="segment"``) on inputs drawn from
``torch.Generator().manual_seed(s)``, ``repeats`` times for each seed,
first with cuDNN's TF32 convolutions allowed (PyTorch's default) and then
with them off (as ``chip_smoke.py`` runs).  Each run's largest difference
between the first forward and the segment path is set beside the test's
limit (1e-4 of the segment output's largest entry).

For every run it also counts the inputs of the blocks' two convolutions
(time and residual) whose TF32 roundings differ between the two paths:
values that the paths' different sum orders (~1e-7 relative) push across a
rounding step of TF32's 10-bit mantissa (2^-11 relative).  At the element
that misses by most it prints that node's LayerNorm gains (1/sqrt(var +
eps) of each block's LayerNorm input at each step), the other candidate
amplifier.  The last line is one JSON object with the readings.  Needs a
card; prints the card's name and power limit first.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def banded(n, e, seed=0, band=40):
    """``tests/test_torch_cuda.py``'s graph."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, size=e)
    r = np.clip(s + rng.integers(-band, band + 1, size=e), 0, n - 1)
    s = np.concatenate([s, rng.integers(0, n, size=e // 20)])
    r = np.concatenate([r, rng.integers(0, n, size=e // 20)])
    return np.stack([s, r]), rng.uniform(0.1, 1.0, s.size).astype(np.float32)


def tf32(torch, v):
    """f32 values rounded to TF32 (10 mantissa bits, nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``), as int32 bit patterns."""
    bits = v.contiguous().view(torch.int32)
    return (bits + 0x1000) & ~0x1FFF


def main(seeds=4, repeats=5):
    import torch

    from pytorch_geometric_temporal_tpu_torch import config_override
    from pytorch_geometric_temporal_tpu_torch.models import ASTGCN
    from pytorch_geometric_temporal_tpu_torch.ops import Graph

    if not torch.cuda.is_available():
        print("astgcn_edge_noise: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    n = 5000
    ei, w = banded(n, 60_000, seed=12)
    cfg = dict(nb_block=2, in_channels=2, K=3, nb_chev_filter=8,
               nb_time_filter=8, time_strides=1, num_for_predict=3,
               len_input=6, num_of_vertices=n, attention_mode="edge")
    model = ASTGCN(**cfg, normalization="sym",
                   generator=torch.Generator().manual_seed(0))
    blocks = [model.block_0, model.block_1]
    seen = {}

    def keep(tag):
        def hook(module, inputs, output):
            seen[tag] = inputs[0].detach().clone()
        return hook

    for i, b in enumerate(blocks):
        b.time_convolution.register_forward_hook(keep(f"time{i}"))
        b.residual_convolution.register_forward_hook(keep(f"res{i}"))
        b.layer_norm.register_forward_hook(keep(f"ln{i}"))

    def sequence(x):
        """The test's sequence: (first fused forward, its hooks, segment
        forward, its hooks)."""
        g = Graph.from_edge_index(ei, w, num_nodes=n, device=cuda)
        out = model(x, g)
        fused = dict(seen)
        out.square().sum().backward()
        model.zero_grad(set_to_none=True)
        model(x, g)
        with config_override(spmm_backend="segment"):
            want = model(x, g)
        return out.detach(), fused, want.detach(), dict(seen)

    report = {}
    for mode, allow in (("tf32_on", True), ("tf32_off", False)):
        torch.backends.cudnn.allow_tf32 = allow
        runs, worst = [], None
        for seed in range(seeds):
            x = torch.randn(2, n, 2, 6, generator=torch.Generator()
                            .manual_seed(seed)).to(cuda)
            for rep in range(repeats):
                out, fused, want, seg = sequence(x)
                diff = (out - want).abs()
                limit = 1e-4 * float(want.abs().max())
                err = float(diff.max())
                flips = sum(int((tf32(torch, fused[k]) != tf32(torch, seg[k]))
                                .sum()) for k in fused if k[:2] != "ln")
                runs.append({"seed": seed, "repeat": rep, "max_err": err,
                             "over": err / limit, "tf32_flips": flips,
                             "elements_over": int((diff > limit).sum())})
                if worst is None or err / limit > worst[0]:
                    idx = np.unravel_index(int(diff.argmax()), diff.shape)
                    worst = (err / limit, seed, rep, idx, seg)
        over, seed, rep, (b, node, p), seg = worst
        gains = []
        for i in range(len(blocks)):
            var = seg[f"ln{i}"][b, node].var(dim=-1, unbiased=False)
            gains.append([round(float(v), 3)
                          for v in 1 / torch.sqrt(var + 1e-6)])
        errs = [r["max_err"] for r in runs]
        report[mode] = {
            "runs": len(runs),
            "runs_over_limit": sum(r["over"] > 1 for r in runs),
            "max_err": max(errs), "median_max_err": statistics.median(errs),
            "median_tf32_flips": statistics.median(r["tf32_flips"]
                                                   for r in runs),
            "worst": {"seed": seed, "repeat": rep, "over": over,
                      "index": [int(b), int(node), int(p)],
                      "ln_gain_by_step": gains},
        }
        for r in runs:
            print(f"{mode} seed {r['seed']} repeat {r['repeat']}: max err "
                  f"{r['max_err']:.3e} ({r['over']:.3f} of the limit, "
                  f"{r['elements_over']} elements over), conv inputs "
                  f"rounded apart in TF32: {r['tf32_flips']}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    sys.exit(main(*args))
