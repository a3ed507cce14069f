"""The readings that a cell's limits are set from; not run by the
benchmark's runs.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 ... \
        [--controls 3]

For each seed, in one process: the program's set-up as a run makes it
(its first three train steps through the window's own loop), then, with
the program freed, the reference; the four numbers of ``check.py`` for

- ``program``: the program against the reference (the lower readings);

and on the first ``--controls`` seeds, each in the program's place:

- ``control``: the reference computed in TF32, the step below the
  configurations' f32;
- ``half_batch``: the reference with each step's loss over the first half
  of its batch (a planted fault);
- ``unchanged``: the parameters left as they were (a step that returns
  its state unchanged; ``step`` reads 1 by construction).

One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings_for(cell, seed: int, device, controls: bool) -> dict:
    import torch

    from perfbench import check, harness

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["recipe"]["tf32"])
    inputs, prog, loop, record, starts = harness.set_up(cell, seed, device)
    del prog, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    p0 = record["params0"]
    want = check.reference_run(cell, inputs, starts, p0, device)
    out = {"seed": seed,
           "program": check.readings(record, want, p0, inputs, starts)}
    if controls:
        for name, kw in (("control", {"precision": "tf32"}),
                         ("half_batch", {"batch_fraction": 0.5})):
            got = check.reference_run(cell, inputs, starts, p0, device, **kw)
            out[name] = check.readings(got, want, p0, inputs, starts)
        same = dict(want, params3=p0)
        out["unchanged"] = check.readings(same, want, p0, inputs, starts)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import run
    run.set_caches()
    import torch

    from perfbench import manifest

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings_for(cell, seed, "cuda",
                                      i < args.controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
