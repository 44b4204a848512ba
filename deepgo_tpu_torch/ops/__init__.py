"""Device-side ops: packed-record expansion and the convolution epilogue,
plain and as CUDA kernels.

Each op picks its implementation from where the tensor lies, as the port of
``deepgo_tpu.ops.get_expand_fn``'s choice: a CPU tensor goes to the plain
PyTorch version, a CUDA tensor to the hand-written kernel (which raises on
what it cannot take). There is no fallback from a kernel to the plain
version."""

from __future__ import annotations

import torch

from . import epilogue as _plain_epilogue
from . import expand as _plain
from .augment import NUM_SYMMETRIES
from .cuda_epilogue import BiasReLU, bias_relu_cuda
from .cuda_expand import expand_planes_cuda, expand_planes_sym_cuda


def expand_planes(packed: torch.Tensor, player: torch.Tensor,
                  rank: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """packed (B, 9, 19, 19) uint8, player / rank (B,) int32 ->
    (B, 19, 19, 37) planes in ``dtype``."""
    if packed.device.type == "cuda":
        return expand_planes_cuda(packed, player, rank, dtype=dtype)
    if packed.device.type == "cpu":
        return _plain.expand_planes(packed, player, rank, dtype=dtype)
    raise ValueError(f"no expansion for tensors on {packed.device}")


def expand_planes_sym(packed: torch.Tensor, player: torch.Tensor,
                      rank: torch.Tensor, symmetries: int = NUM_SYMMETRIES,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """packed (B, 9, 19, 19) uint8, player / rank (B,) int32 ->
    (S*B, 19, 19, 37) planes of the first ``symmetries`` = S dihedral
    views, symmetry-major (view k of board i at row ``k*B + i``)."""
    if packed.device.type == "cuda":
        return expand_planes_sym_cuda(packed, player, rank,
                                      symmetries=symmetries, dtype=dtype)
    if packed.device.type == "cpu":
        return _plain.expand_planes_sym(packed, player, rank,
                                        symmetries=symmetries, dtype=dtype)
    raise ValueError(f"no expansion for tensors on {packed.device}")


def bias_relu(x: torch.Tensor, bias: torch.Tensor, relu: bool = True
              ) -> torch.Tensor:
    """x (B, C, 19, 19) channels-last, bias (C, 19, 19) float32 ->
    ``relu(x + bias.to(x.dtype))`` (``relu=False``: the sum alone). On the
    card, with a gradient to take, one autograd node over the forward and
    backward kernels; without one (``inference_mode``, ``no_grad``, nothing
    requiring grad) the forward kernel alone, with no autograd node's host
    cost."""
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and (x.requires_grad
                                        or bias.requires_grad):
            return BiasReLU.apply(x, bias, relu)
        return bias_relu_cuda(x, bias, relu)
    if x.device.type == "cpu":
        return _plain_epilogue.bias_relu(x, bias, relu)
    raise ValueError(f"no epilogue for tensors on {x.device}")
