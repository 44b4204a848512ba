"""Faults planted under the timed path, to show that ``correct`` catches them.

Each function patches the program in this process (``harness.run(...,
patch="benchmark.faults:<name>")`` calls it before the run builds anything)
and is never called by a real run. They are the faults a cell can have:

- ``state_unchanged``: the training step returns its state unchanged (SGD
  writes nothing);
- ``half_batch``: the loss is the mean over the first half of the batch;
- ``answer_altered``: every answer of the serving forward has its best
  point raised by 1 in log-probability where it is produced.
"""

from __future__ import annotations

import numpy as np


def state_unchanged() -> None:
    from deepgo_tpu_torch.training import optimizers

    real = optimizers.sgd

    def sgd(*args, **kw):
        opt = real(*args, **kw)
        return opt._replace(apply=lambda names, params, grads, state: state,
                            update=lambda model, grads, state: state)

    optimizers.sgd = sgd


def half_batch() -> None:
    from deepgo_tpu_torch.training import steps

    real = steps.nll_from_logits

    def nll(logits, targets):
        half = logits.shape[0] // 2
        return real(logits[:half], targets[:half])

    steps.nll_from_logits = nll


def answer_altered() -> None:
    from deepgo_tpu_torch.models import serving

    real = serving.stage_d2h

    def stage(tensor):
        out = real(tensor)
        out[np.arange(len(out)), out.argmax(axis=1)] += 1.0
        return out

    serving.stage_d2h = stage
