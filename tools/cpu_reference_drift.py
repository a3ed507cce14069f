"""pytest plugin: does the CPU reference of a card test drift within a run?

    PYTHONPATH=tools python -m pytest --noconftest -p no:cacheprovider \
        -p cpu_reference_drift tests/test_torch_cuda.py -m cuda -q -s

Just before ``tests/test_torch_cuda.py::test_model_on_card_matches_cpu``
runs in the full card-test session, it runs that test's computation
(DCRNNSeq(4, 8, K=2) over f32 BCSR diffusion operators of a 900-node banded
graph, two batches of three steps) once on the CPU, four times on the card
and once more on the CPU, and prints the precision flags, the thread count,
each card run's largest difference from the first CPU run (and how many
outputs differ by more than the test's 1e-5), and the two CPU runs'
largest difference from each other.  The lines start with ``DRIFT``.
"""

import numpy as np
import torch


def _outputs(dev, banded):
    from pytorch_geometric_temporal_tpu_torch.models import DCRNNSeq
    from pytorch_geometric_temporal_tpu_torch.ops import (
        DiffusionOperators, Graph)

    n = 900
    ei, w = banded(n, 12000, seed=2)
    g = Graph.from_edge_index(ei, w, num_nodes=n, device=dev)
    ops = DiffusionOperators.from_graph(g, bcsr=True, device=dev)
    model = DCRNNSeq(4, 8, 2, device=dev,
                     generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, n, 4)).astype(np.float32)).to(dev)
    with torch.no_grad():
        return model(x, ops).cpu()


def pytest_runtest_call(item):
    if item.name != "test_model_on_card_matches_cpu":
        return
    banded = item.module.banded
    print(f"\nDRIFT matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}"
          f", cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, float32 "
          f"matmul precision {torch.get_float32_matmul_precision()}, CPU "
          f"threads {torch.get_num_threads()}", flush=True)
    cpu = _outputs("cpu", banded)
    for i in range(4):
        d = (_outputs("cuda", banded) - cpu).abs()
        print(f"DRIFT card run {i} against the first CPU run: largest "
              f"{float(d.max()):.3e}, {int((d > 1e-5).sum())} outputs over "
              f"1e-5", flush=True)
    again = _outputs("cpu", banded)
    print(f"DRIFT the two CPU runs: largest difference "
          f"{float((again - cpu).abs().max()):.3e}", flush=True)
