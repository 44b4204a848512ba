"""AlphaGo Zero's dual-head residual network, in PyTorch.

Silver et al. 2017, "Mastering the game of Go without human knowledge"
(Nature 550:354), Methods, "Neural network architecture":

- a convolutional block: conv 3x3 of ``channels`` filters, batch
  normalisation, ReLU;
- ``blocks - 1`` residual blocks: conv 3x3, BN, ReLU, conv 3x3, BN, the
  block's input added, ReLU;
- a policy head: conv 1x1 of 2 filters, BN, ReLU, a dense layer to the move
  logits;
- a value head: conv 1x1 of 1 filter, BN, ReLU, a dense layer of
  ``value_hidden``, ReLU, a dense layer to one output, tanh.

Convolutions carry no bias (BN's shift takes its place). ``blocks`` counts
the convolutional block, so 40 is the paper's 1 + 39 residual blocks.

Two departures of the input and output format, not of the network: the
input is the repository's 37 feature planes (AlphaGo Zero reads 17
history planes), and the policy has 361 outputs, one per board point
(AlphaGo Zero adds a pass move; the repository's data has no pass
targets).

As ``PolicyCNN``: parameters are float32, the forward casts the planes and
the weights to ``cfg.compute_dtype`` and runs channels-last; the outputs
are float32. BN keeps float32 scale, shift and running statistics, uses
the batch's statistics and updates the running ones in train mode, and
the running ones in eval mode. Every BN, with the skip add and the ReLU
after it, is one ``ops.bn_relu``: on the card one hand-written kernel set
each way. Planes come in NHWC (B, 19, 19, 37); the logits' point
``19*x + y``.

While a profiler capture runs, the trunk and each head open a range
(``resnet.trunk``, ``resnet.policy_head``, ``resnet.value_head``), so a
capture names their kernels; outside one the ranges cost nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import NUM_POINTS, ops, resolve_device
from ..analysis.cudacheck import place
from ..features import NUM_PLANES
from ..obs.spans import hot_range
from .policy_cnn import COMPUTE_DTYPES

# c of the paper's loss: l = (z - v)^2 - pi^T log p + c ||theta||^2
L2_WEIGHT = 1e-4
POLICY_FILTERS = 2
VALUE_FILTERS = 1


@dataclass(frozen=True)
class ResNetConfig:
    """``blocks`` counts the convolutional block and the residual blocks;
    ``bn_eps`` and ``bn_momentum`` are PyTorch's defaults, the paper gives
    none."""

    blocks: int = 3
    channels: int = 64
    input_planes: int = NUM_PLANES
    value_hidden: int = 256
    compute_dtype: str = "bfloat16"
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} is not supported; "
                f"use one of {sorted(COMPUTE_DTYPES)}")
        if self.blocks < 1:
            raise ValueError(f"blocks must be at least 1, got {self.blocks}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute_dtype]


CONFIGS = {
    "agz20": ResNetConfig(blocks=20, channels=256),
    "agz40": ResNetConfig(blocks=40, channels=256),
}


class BatchNorm(nn.Module):
    """Batch normalisation over the channels of NCHW activations: scale
    ``weight`` and shift ``bias``, ``running_mean`` and ``running_var``
    (the unbiased variance) updated by ``momentum`` in train mode.
    ``nn.BatchNorm2d``'s parameters and buffers without its step counter,
    which costs a launch a layer a step and which nothing here reads; its
    arithmetic is ``ops.bn_relu``'s, which takes the module whole."""

    def __init__(self, c: int, eps: float, momentum: float):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class ConvBN(nn.Module):
    """A SAME-padded convolution without bias, then batch normalisation and
    ReLU: ``weight`` (c_out, c_in, k, k) and ``bn``."""

    def __init__(self, k: int, c_in: int, c_out: int, cfg: ResNetConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k))
        self.bn = BatchNorm(c_out, cfg.bn_eps, cfg.bn_momentum)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype),
                        padding=self.weight.shape[-1] // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.bn_relu(self._conv(x), self.bn)

    def residual(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """The convolution and BN, ``skip`` added before the ReLU: a
        residual block's second layer."""
        return ops.bn_relu(self._conv(x), self.bn, skip)


class ResidualBlock(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.conv1 = ConvBN(3, cfg.channels, cfg.channels, cfg)
        self.conv2 = ConvBN(3, cfg.channels, cfg.channels, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2.residual(self.conv1(x), x)


class Dense(nn.Module):
    """A dense layer: ``weight`` (c_out, c_in) and ``bias`` (c_out,)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class DualResNet(nn.Module):
    """The network of one ``ResNetConfig``; zero-initialised (see ``init``
    for He-normal weights)."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.stem = ConvBN(3, cfg.input_planes, c, cfg)
        self.blocks = nn.ModuleList(ResidualBlock(cfg)
                                    for _ in range(cfg.blocks - 1))
        self.policy_conv = ConvBN(1, c, POLICY_FILTERS, cfg)
        self.policy_fc = Dense(POLICY_FILTERS * NUM_POINTS, NUM_POINTS)
        self.value_conv = ConvBN(1, c, VALUE_FILTERS, cfg)
        self.value_fc1 = Dense(VALUE_FILTERS * NUM_POINTS, cfg.value_hidden)
        self.value_fc2 = Dense(cfg.value_hidden, 1)

    def forward(self, planes: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """planes: (B, 19, 19, 37) NHWC -> (logits (B, 361) float32, value
        (B,) float32 in [-1, 1]).

        The NHWC planes seen as NCHW are channels-last; each head's map
        flattens in (channel, x, y) order."""
        x = planes.permute(0, 3, 1, 2).to(self.cfg.torch_dtype)
        with hot_range("resnet.trunk"):
            x = self.stem(x)
            for block in self.blocks:
                x = block(x)
        with hot_range("resnet.policy_head"):
            p = self.policy_conv(x).reshape(x.shape[0], -1)
            logits = self.policy_fc(p).float()
        with hot_range("resnet.value_head"):
            v = self.value_conv(x).reshape(x.shape[0], -1)
            v = F.relu(self.value_fc1(v))
            value = torch.tanh(self.value_fc2(v).float())[:, 0]
        return logits, value

    def l2_weights(self) -> list[torch.Tensor]:
        """The parameters the loss's L2 term covers: every convolution's
        and dense layer's weight (not BN's scale and shift, nor the dense
        biases)."""
        return [m.weight for m in self.modules()
                if isinstance(m, (ConvBN, Dense))]


def init(generator: torch.Generator, cfg: ResNetConfig,
         device="cuda") -> DualResNet:
    """He-normal convolution and dense weights (std sqrt(2 / fan_in)),
    drawn on the CPU from ``generator`` and moved to ``device``; dense
    biases 0, BN scale 1 and shift 0."""
    device = resolve_device(device)
    model = DualResNet(cfg)
    with torch.no_grad():
        for w in model.l2_weights():
            w.copy_(torch.randn(w.shape, generator=generator)
                    * math.sqrt(2.0 / w[0].numel()))
    return place(model, device)
