"""Helpers the per-layer readers share: the traced sub-window's steps and
the kernels that carry the aggregation, matched by name."""

from __future__ import annotations

import re

# the kernels that carry the aggregation: the fused kernel and the two it
# replaced (csrc/hybrid_spmm.cu, csrc/bcsr_kernels.cu)
SPMM_KERNELS = re.compile(r"hybrid_spmm|tile_spmm_(f32|mma)_kernel|"
                          r"rem_scatter_kernel")


def train_steps(run) -> int:
    return sum(1 for kind, _ in run.sub_kinds if kind == "train")


def spmm_seconds(run) -> float:
    return sum(s for name, (s, _) in run.summary.kernels.items()
               if SPMM_KERNELS.search(name))


def all_seconds(run) -> float:
    return sum(s for s, _ in run.summary.kernels.values())


def work(run):
    """(GEMM operations, hops) of every step in the traced sub-window, by
    the configuration's family."""
    flops, hops = 0, []
    for kind, batch in run.sub_kinds:
        f, h = run.family.work(run.config, batch, kind == "train")
        flops += f
        hops += h
    return flops, hops
