"""The explicit-collective data-parallel train step.

The port of ``deepgo_tpu/parallel/shard_map_step.py``. In the JAX package
this is the second formulation beside the SPMD one: per-device code with an
explicit ``pmean`` of the gradients and the loss over "data". In the port
the explicit all-reduce *is* the data-parallel path
(``training/steps.py``), so this is that step over a mesh, kept under the
JAX package's name; there is one implementation, not two.
"""

from __future__ import annotations

from ..models import policy_cnn
from ..training.optimizers import Optimizer
from ..training.steps import make_train_step
from .mesh import Mesh


def make_shard_map_train_step(cfg: policy_cnn.ModelConfig,
                              optimizer: Optimizer, mesh: Mesh,
                              expand_backend: str = "xla"):
    """step(model, opt_state, batch) with a hand-written gradient mean:
    each data rank computes loss and gradients on its rows of the batch,
    then all-reduces both by mean over "data"."""
    return make_train_step(cfg, optimizer, expand_backend=expand_backend,
                           mesh=mesh)
