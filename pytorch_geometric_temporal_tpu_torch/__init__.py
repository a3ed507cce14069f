"""PyTorch / CUDA port of ``pytorch_geometric_temporal_tpu``.

The module layout mirrors the JAX package so that each counterpart is easy
to find; the JAX package is the reference the port is tested against.  This
package imports torch and numpy only — never JAX, flax, optax or the JAX
package.  Entry points build on CUDA unless given ``device="cpu"``.

The hybrid block-sparse aggregation (``ops/bcsr.py``) runs through two CUDA
kernels written for Hopper (``csrc/bcsr_kernels.cu``), compiled with nvcc
at first use.
"""

from .config import Config, config_override, get_config

__all__ = ["Config", "config_override", "get_config"]
