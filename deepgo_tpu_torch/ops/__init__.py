"""Device-side ops: packed-record expansion, plain and as a CUDA kernel."""

from __future__ import annotations

import torch

from . import expand as _plain
from .cuda_expand import expand_planes_cuda


def expand_planes(packed: torch.Tensor, player: torch.Tensor,
                  rank: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """packed (B, 9, 19, 19) uint8, player / rank (B,) int32 ->
    (B, 19, 19, 37) planes in ``dtype``.

    The port of ``deepgo_tpu.ops.get_expand_fn``'s choice, made from where
    the tensor lies: a CPU tensor goes to the plain PyTorch version, a CUDA
    tensor to the hand-written kernel (which raises on what it cannot
    take). There is no fallback from the kernel to the plain version."""
    if packed.device.type == "cuda":
        return expand_planes_cuda(packed, player, rank, dtype=dtype)
    if packed.device.type == "cpu":
        return _plain.expand_planes(packed, player, rank, dtype=dtype)
    raise ValueError(f"no expansion for tensors on {packed.device}")
