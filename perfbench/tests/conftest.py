"""The benchmark's CPU tests run thousands of small ops: with several
workers a thread pool only spins, so each worker keeps to one thread."""

import torch

torch.set_num_threads(1)
