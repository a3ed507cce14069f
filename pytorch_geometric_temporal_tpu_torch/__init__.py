"""PyTorch / CUDA port of ``pytorch_geometric_temporal_tpu``.

The module layout mirrors the JAX package so that each counterpart is easy
to find; the JAX package is the reference the port is tested against.  This
package imports torch and numpy only — never JAX, flax, optax or the JAX
package.  Entry points build on CUDA unless given ``device="cpu"``.

Sub-packages: ``ops`` (graphs, normalizations, spmm, BCSR operators),
``models`` (the convolutions, the recurrent, attention and heterogeneous
models), ``signal`` (snapshot iterators, the stacked signals and index
batching), ``data`` (the loaders: five datasets bundled with the package,
twelve read from staged files), ``train`` (trainers, training state,
checkpoints, guards, mixed precision), ``utils`` (profiling) and
``protocols`` (the accuracy protocols, the training harness, the
heterogeneous run) and ``parallel`` (meshes over process groups, the
data-parallel step, node-partitioned graphs and DCRNN); ``nn`` and
``dataset`` are the reference's names for ``models`` and ``data``.  The
hybrid block-sparse aggregation (``ops/bcsr.py``) runs through a CUDA kernel
written for Hopper (``csrc/hybrid_spmm.cu``), compiled with nvcc at first
use: importing the package builds nothing.

Typical usage::

    import pytorch_geometric_temporal_tpu_torch as pgtt
    model = pgtt.DCRNNSeq(2, 32, K=2)
"""

__version__ = "0.1.0"

from . import data, models, ops, parallel, signal, train  # noqa: F401
from . import dataset, nn  # noqa: F401  (reference-layout aliases)
from .config import Config, config_override, get_config  # noqa: F401
from .data import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .ops import Graph  # noqa: F401
from .signal import *  # noqa: F401,F403
