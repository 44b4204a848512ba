"""Plain PyTorch version of the convolution epilogue: a bias per channel and
board point, then ReLU.

The CPU path of ``ops.bias_relu``, and the reference the CUDA kernels
(``csrc/epilogue.cu``) are held against on the card: the same expression
``PositionBiasConv`` evaluated before the kernels, so the CPU numbers and
gradients are those of the JAX package's parity tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bias_relu(x: torch.Tensor, bias: torch.Tensor, relu: bool = True
              ) -> torch.Tensor:
    """x (B, C, 19, 19), bias (C, 19, 19) float32 -> ``relu(x + bias)`` in
    x's dtype (``relu=False``: ``x + bias``), the bias rounded to x's dtype
    first."""
    x = x + bias.to(x.dtype)[None]
    return F.relu(x) if relu else x
