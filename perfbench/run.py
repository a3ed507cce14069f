"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout, on the machine that holds the cards the
cell asks for; prints the result as one JSON object, the last line of
standard output, and each number that decides ``correct`` beside its limit
as the last lines of standard error.  Exits with another code than 0, and
prints no result, without a CUDA card (or with fewer than the cell asks
for), when the port cannot be imported, or when JAX or the JAX package was
loaded.  See ``perfbench/README.md``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of the program at a fixed path inside the checkout, set
# before torch is imported
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv", "TORCHINDUCTOR_CACHE_DIR":
          "inductor"}


def set_caches(root: Path = HERE) -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(root / ".cache" / sub)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0:
        raise SystemExit("--seed must be a whole number >= 0")
    set_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import manifest

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and has no "
              "CPU fallback", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    return report(cell, args.seed, args.seconds, bool(args.trace), "cuda")


def report(cell, seed: int, seconds: float, trace: bool, device) -> int:
    """Run ``cell`` on ``device`` and print its result line; 3, and no
    line, if JAX or the JAX package was loaded."""
    from perfbench import harness

    out = harness.run_cell(cell, seed, seconds, trace, device)
    held = harness.forbidden_modules()
    if held:
        print(f"modules of JAX or of the JAX package loaded: {held}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
