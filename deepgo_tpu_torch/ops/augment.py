"""Dihedral-group data augmentation for board positions, in PyTorch.

The port of ``deepgo_tpu/ops/augment.py``. Go is symmetric under the 8 board
symmetries and every packed channel is a spatial map, so augmentation is a
pure position permutation applied to both the packed record and the move
target. The (8, 361) tables come from the port's ``utils/digest.py``:
``transformed_flat[p] = flat[PERM[k, p]]`` and the target moves with
``TARGET_MAP[k, target]``. The tables are frozen read-only numpy arrays;
each caller uploads the rows it needs to its own device.
"""

from __future__ import annotations

import torch

from .. import NUM_POINTS
from ..utils import digest as _digest

_PERM_NP, _TARGET_MAP_NP = _digest.PERMS, _digest.INV_PERMS
NUM_SYMMETRIES = _digest.NUM_SYMMETRIES


def table(rows, device) -> torch.Tensor:
    """A frozen numpy table (or its first rows) as an int64 tensor on
    ``device``, the index type ``torch.gather`` and indexing take."""
    return torch.tensor(rows, dtype=torch.int64, device=device)


def augment_batch(packed: torch.Tensor, target: torch.Tensor,
                  sym: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply per-sample board symmetries on the inputs' device.

    packed (B, 9, 19, 19) uint8, target (B,) int32, sym (B,) int in [0, 8)
    -> (packed', target') with identical semantics under Go's symmetry
    group."""
    b = packed.shape[0]
    sym = sym.long()
    perm = table(_PERM_NP, packed.device)[sym]  # (B, 361)
    flat = packed.reshape(b, packed.shape[1], NUM_POINTS)
    out = torch.gather(flat, 2, perm[:, None, :].expand_as(flat))
    new_target = torch.gather(table(_TARGET_MAP_NP, packed.device)[sym], 1,
                              target.long()[:, None])[:, 0]
    return out.reshape(packed.shape), new_target.to(target.dtype)
