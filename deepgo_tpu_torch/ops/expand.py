"""Plain PyTorch expansion of packed records into the 37 model input planes.

The port of ``deepgo_tpu/ops/expand.py``, plus ``expand_planes_sym``, the
expansion of the dihedral views stacked on the batch axis. Both are the CPU
path and the references the CUDA kernels (``csrc/expand.cu``) are held
against on the card; on the card the serving path never calls them.
Semantics match ``deepgo_tpu_torch.features.expand_planes_np`` for players
1/2 and ranks 1..9, and the JAX ``expand_planes`` for any uint8 record and
any int32 player / rank: the uint8 channels are compared as int32, so
``3 - player`` and out-of-range values behave identically, a rank outside
1..9 sets no rank plane, and a channel value of 255 fires no ``== i``
plane.

Layout: returns NHWC (batch, 19, 19, 37), the JAX package's public layout.
Seen as (batch, 37, 19, 19) through ``permute(0, 3, 1, 2)`` it has the
``torch.channels_last`` strides the conv stack consumes.
"""

from __future__ import annotations

import torch

from .. import NUM_POINTS
from ..features import NUM_PLANES
from .augment import _PERM_NP, NUM_SYMMETRIES, table


def expand_planes(packed: torch.Tensor, player: torch.Tensor,
                  rank: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """packed: (B, 9, 19, 19) uint8; player, rank: (B,) int32.

    Returns (B, 19, 19, 37) binary planes in ``dtype`` from the to-move
    player's perspective.
    """
    packed = packed.to(torch.int32)
    p3 = player.to(torch.int32)[:, None, None]  # broadcast over the board
    stones = packed[:, 0]
    libs = packed[:, 1]
    age = packed[:, 6]
    # per-player packed channels, selected by the player to move
    is_black = p3 == 1
    lib_after = torch.where(is_black, packed[:, 2], packed[:, 3])
    kills = torch.where(is_black, packed[:, 4], packed[:, 5])
    ladder = torch.where(is_black, packed[:, 7], packed[:, 8])

    empty = stones == 0
    planes = [empty, stones == p3, stones == (3 - p3)]
    planes += [libs == i for i in (1, 2, 3)] + [libs >= 4]
    planes += [empty & (lib_after == 0)]
    planes += [lib_after == i for i in range(1, 6)] + [lib_after >= 6]
    planes += [kills == i for i in range(1, 7)] + [kills >= 7]
    planes += [age == i for i in range(1, 6)]
    planes += [ladder >= 1]
    planes += [torch.zeros_like(empty)]  # reference's dead RANK base plane
    r3 = rank.to(torch.int32)[:, None, None]
    planes += [(r3 == i).expand_as(empty) for i in range(1, 10)]
    out = torch.stack(planes, dim=-1).to(dtype)
    assert out.shape[-1] == NUM_PLANES
    return out


def expand_planes_sym(packed: torch.Tensor, player: torch.Tensor,
                      rank: torch.Tensor, symmetries: int = NUM_SYMMETRIES,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """packed (B, 9, 19, 19) uint8; player, rank (B,) int32 ->
    (S*B, 19, 19, 37) planes of the first S dihedral views of every board,
    symmetry-major: view k of board i is row ``k*B + i``.

    The XLA branch of ``deepgo_tpu.models.quant.make_fused_sym_policy_fn``
    written out: gather the views by ``PERMS[:S]``, stack them on the batch
    axis, tile player and rank S times (``[v, v, ...]``, as ``jnp.tile``),
    and expand. It is the CPU path of the fused forward and the reference
    the sym kernel (``csrc/expand.cu``) is held against on the card."""
    if not 1 <= symmetries <= NUM_SYMMETRIES:
        raise ValueError(f"symmetries must be in [1, {NUM_SYMMETRIES}], "
                         f"got {symmetries!r}")
    b, ch = packed.shape[0], packed.shape[1]
    perm = table(_PERM_NP[:symmetries], packed.device)  # (S, 361)
    views = packed.reshape(b, ch, NUM_POINTS)[:, :, perm]  # (B, C, S, 361)
    views = views.permute(2, 0, 1, 3).reshape(symmetries * b, ch,
                                              *packed.shape[2:])
    return expand_planes(views, player.repeat(symmetries),
                         rank.repeat(symmetries), dtype=dtype)
