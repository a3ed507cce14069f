"""PyTorch / CUDA port of ``pytorch_geometric_temporal_tpu``.

The module layout mirrors the JAX package so that each counterpart is easy
to find; the JAX package is the reference the port is tested against.  This
package imports torch and numpy only — never JAX, flax, optax or the JAX
package.  Entry points build on CUDA unless given ``device="cpu"``.

Sub-packages: ``ops`` (graphs, normalizations, spmm, BCSR operators),
``models`` (the convolutions and the recurrent cells), ``signal`` (snapshot
iterators, the stacked signal and index batching), ``data`` (the loaders:
five datasets bundled with the package, twelve read from staged files),
``train`` (snapshot and batch trainers) and ``protocols`` (the accuracy
protocols).  The hybrid block-sparse aggregation (``ops/bcsr.py``) runs
through a CUDA kernel written for Hopper (``csrc/hybrid_spmm.cu``),
compiled with nvcc at first use.
"""

from .config import Config, config_override, get_config

__all__ = ["Config", "config_override", "get_config"]
