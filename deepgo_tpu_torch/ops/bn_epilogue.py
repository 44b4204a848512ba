"""Plain PyTorch version of the residual network's batch-normalisation
epilogue: BN, the block's input added where there is one, then ReLU.

The CPU path of ``ops.bn_relu``, and the reference the CUDA kernels
(``csrc/bn_epilogue.cu``) are held against on the card: the same expression
``models/resnet.py`` evaluated before the kernels, so the CPU numbers,
gradients and running statistics are those of the reference comparisons.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bn_relu(x: torch.Tensor, bn, skip: torch.Tensor | None = None
            ) -> torch.Tensor:
    """x (B, C, 19, 19); ``bn`` a ``models.resnet.BatchNorm`` (float32
    scale, shift and running statistics; in train mode the batch's
    statistics, which move the running ones); ``skip`` None or as x ->
    ``relu(batch_norm(x) + skip)`` in x's dtype."""
    x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     bn.training, bn.momentum, bn.eps)
    if skip is not None:
        x = x + skip
    return F.relu(x)
