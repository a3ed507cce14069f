"""Model families: ``<family>.py`` beside this file and its plain reference
``reference/<family>.py``, found by a configuration's ``model.family``
(``manifest.load_family``).  A family module gives

- ``build(config, inputs, graph, device, generator) -> Model``: the program's
  model on the cell's inputs and the port's ``Graph`` of them, its
  parameters drawn from ``generator``;
- ``REFERENCE``: the reference module (``manifest.load_reference``), with
  ``Operators``, ``windows`` and ``train`` as ``check.reference_run`` calls
  them;
- ``work(config, batch, train) -> (GEMM operations, hops)`` of one step; a
  hop is (operator name, is the gradient's product, width);
- ``operators(inputs) -> {name: {"nnz", "shape", "x_rows"}}`` for each
  operator a hop names: its nonzeros, (rows, columns), and the x rows a
  product with it reads (forward, gradient);
- ``tiny(config)``: shrinks the configuration's model in place to what the
  CPU tests run in seconds.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Model(NamedTuple):
    module: torch.nn.Module
    forward: Callable           # a batch's inputs -> the prediction
    loss: Callable              # scaler -> BatchTrainer's loss_fn, or None
    names: dict                 # program parameter name -> reference name
