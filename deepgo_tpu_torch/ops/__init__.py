"""Device-side ops: packed-record expansion, the convolution epilogue and
the residual network's BN epilogue, plain and as CUDA kernels.

Each op picks its implementation from where the tensor lies, as the port of
``deepgo_tpu.ops.get_expand_fn``'s choice: a CPU tensor goes to the plain
PyTorch version, a CUDA tensor to the hand-written kernel (which raises on
what it cannot take). There is no fallback from a kernel to the plain
version."""

from __future__ import annotations

import torch

from . import bn_epilogue as _plain_bn_epilogue
from . import epilogue as _plain_epilogue
from . import expand as _plain
from .augment import NUM_SYMMETRIES
from .cuda_bn_epilogue import BNReLU, bn_relu_cuda
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


def bn_relu(x: torch.Tensor, bn, skip: torch.Tensor | None = None
            ) -> torch.Tensor:
    """x (B, C, 19, 19) channels-last, ``bn`` a ``models.resnet.BatchNorm``,
    ``skip`` None or as x -> ``relu(batch_norm(x) + skip)`` in x's dtype,
    BN in the module's mode (train mode moves its running statistics). On
    the card, with a gradient to take, one autograd node over the train
    mode's forward and backward kernels; without one (``inference_mode``,
    ``no_grad``, nothing requiring grad) the forward kernels alone. The
    card's kernels take no gradient in eval mode."""
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and (
                x.requires_grad or bn.weight.requires_grad
                or bn.bias.requires_grad
                or (skip is not None and skip.requires_grad)):
            if not bn.training:
                raise ValueError("the BN epilogue kernels have no eval-mode "
                                 "backward: run an eval-mode forward under "
                                 "torch.no_grad()")
            return BNReLU.apply(x, bn.weight, bn.bias, skip, bn)
        return bn_relu_cuda(x, bn, skip)[0]
    if x.device.type == "cpu":
        return _plain_bn_epilogue.bn_relu(x, bn, skip)
    raise ValueError(f"no BN epilogue for tensors on {x.device}")
