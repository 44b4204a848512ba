"""Convolutional value network: position -> P(side to move wins), in PyTorch.

The port of ``deepgo_tpu/models/value_cnn.py``: the policy net's SAME-padded
conv trunk (5x5 then 3x3 convolutions, per-position biases, ReLU) over the
same 37 input planes, then a 1x1 convolution to one channel with its own
per-position bias and ReLU, a dense layer from the 361 board values to
``head_hidden`` units with ReLU, and a dense layer to one logit.

Parameters are float32; the forward casts them and the planes to
``cfg.compute_dtype``, as the JAX package does, and returns float32 logits.
Convolution weights are OIHW and biases (C, 19, 19), as in ``PolicyCNN``;
the dense layers are ``nn.Linear`` (weight (out, in)), computed by
``torch.matmul`` as the JAX package leaves them to XLA outside any Pallas
kernel. ``models/convert.py`` maps the module to and from the JAX tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import NUM_POINTS, resolve_device
from ..features import NUM_PLANES
from .policy_cnn import COMPUTE_DTYPES, PositionBiasConv


@dataclass(frozen=True)
class ValueConfig:
    """The same fields and defaults as the JAX package's ``ValueConfig``.
    ``num_layers`` counts the trunk convolutions (all hidden; the head's
    1x1 conv is separate, unlike the policy net where the final conv IS
    the output)."""

    num_layers: int = 3
    channels: int = 64
    first_kernel: int = 5
    kernel: int = 3
    input_planes: int = NUM_PLANES
    head_hidden: int = 64
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} is not supported; "
                f"use one of {sorted(COMPUTE_DTYPES)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute_dtype]

    def layer_shapes(self):
        """[(kernel, c_in, c_out)] for each trunk conv layer."""
        shapes = []
        c_in = self.input_planes
        for i in range(self.num_layers):
            k = self.first_kernel if i == 0 else self.kernel
            shapes.append((k, c_in, self.channels))
            c_in = self.channels
        return shapes


class ValueCNN(nn.Module):
    """The value network of one ``ValueConfig``; zero-initialised (see
    ``init`` for He-normal weights)."""

    def __init__(self, cfg: ValueConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            PositionBiasConv(k, c_in, c_out)
            for k, c_in, c_out in cfg.layer_shapes())
        self.head_conv = PositionBiasConv(1, cfg.channels, 1)
        self.dense1 = nn.utils.skip_init(nn.Linear, NUM_POINTS,
                                         cfg.head_hidden)
        self.dense2 = nn.utils.skip_init(nn.Linear, cfg.head_hidden, 1)
        with torch.no_grad():
            for dense in (self.dense1, self.dense2):
                dense.weight.zero_()
                dense.bias.zero_()

    def forward(self, planes: torch.Tensor) -> torch.Tensor:
        """planes: (B, 19, 19, 37) NHWC -> win logits (B,) float32. The
        1-channel head map flattens row-major, point (x, y) at ``19*x +
        y``, as the JAX package's NHWC reshape does."""
        dtype = self.cfg.torch_dtype
        x = planes.permute(0, 3, 1, 2).to(dtype)
        for layer in self.layers:
            x = layer(x, relu=True)
        x = self.head_conv(x, relu=True)
        x = x.reshape(x.shape[0], NUM_POINTS)
        x = F.relu(F.linear(x, self.dense1.weight.to(dtype),
                            self.dense1.bias.to(dtype)))
        logit = F.linear(x, self.dense2.weight.to(dtype),
                         self.dense2.bias.to(dtype))
        return logit[:, 0].float()


def init(generator: torch.Generator, cfg: ValueConfig,
         device="cuda") -> ValueCNN:
    """He-normal conv and dense weights, zero biases, drawn on the CPU from
    ``generator`` (one seed gives the same weights on every device) and
    moved to ``device``. The numbers differ from ``jax.random``'s: parity
    tests share weights through ``models/convert.py``."""
    device = resolve_device(device)
    model = ValueCNN(cfg)
    with torch.no_grad():
        for conv in (*model.layers, model.head_conv):
            _, c_in, k, _ = conv.weight.shape
            w = torch.randn(conv.weight.shape, generator=generator)
            conv.weight.copy_(w * math.sqrt(2.0 / (k * k * c_in)))
        for dense in (model.dense1, model.dense2):
            fan_in = dense.weight.shape[1]
            w = torch.randn(dense.weight.shape, generator=generator)
            dense.weight.copy_(w * math.sqrt(2.0 / fan_in))
    return model.to(device)
