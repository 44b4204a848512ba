"""Convolutional policy network for Go move prediction, in PyTorch.

The port of ``deepgo_tpu/models/policy_cnn.py`` (Maddison et al. 2014,
arXiv:1412.6564): ``num_layers`` SAME-padded convolutions — 5x5 on the 37
input planes first, then 3x3 — each followed by a per-position,
per-channel bias and ReLU; the last convolution emits 1 channel whose 361
values feed a log-softmax. ``final_relu=True`` applies ReLU to that last
convolution too, as the original Torch7 model did.

Parameters are float32; the forward casts them and the planes to
``cfg.compute_dtype`` (bfloat16 on the serving path), as the JAX package
does, and returns float32 logits. Weights are held in PyTorch's OIHW layout
and biases as (C, 19, 19); ``models/convert.py`` maps them to and from the
JAX package's HWIO / (19, 19, C) pytree. The public functions keep the JAX
layout for planes: NHWC (B, 19, 19, 37) in, (B, 361) out, with point
``19*x + y``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import BOARD_SIZE, NUM_POINTS, resolve_device
from ..features import NUM_PLANES

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ModelConfig:
    """The same fields as the JAX package's ``ModelConfig``.

    ``num_layers`` counts every convolution including the final 1-channel
    one. ``channels`` is one width for every hidden conv or a tuple of
    ``num_layers - 1`` widths. ``remat`` recomputes each layer's
    activations in the backward pass instead of keeping them (activation
    memory for compute, as ``jax.checkpoint`` per layer in the JAX
    package); a forward without gradients is unchanged by it."""

    num_layers: int = 3
    channels: int | tuple[int, ...] = 64
    first_kernel: int = 5
    kernel: int = 3
    input_planes: int = NUM_PLANES
    final_relu: bool = False  # True = bit-parity with the reference head
    compute_dtype: str = "bfloat16"
    remat: bool = False

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} is not supported; "
                f"use one of {sorted(COMPUTE_DTYPES)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute_dtype]

    def hidden_channels(self) -> tuple[int, ...]:
        """Per-hidden-layer output widths (everything but the final conv)."""
        if isinstance(self.channels, int):
            return (self.channels,) * (self.num_layers - 1)
        if len(self.channels) != self.num_layers - 1:
            raise ValueError(
                f"channels tuple has {len(self.channels)} entries; "
                f"num_layers={self.num_layers} needs {self.num_layers - 1}"
            )
        return tuple(self.channels)

    def layer_shapes(self):
        """[(kernel, c_in, c_out)] for each conv layer."""
        widths = self.hidden_channels() + (1,)
        shapes = []
        c_in = self.input_planes
        for i, c_out in enumerate(widths):
            k = self.first_kernel if i == 0 else self.kernel
            shapes.append((k, c_in, c_out))
            c_in = c_out
        return shapes


# Named flagship configurations, as in the JAX package.
CONFIGS = {
    "small": ModelConfig(num_layers=3, channels=64),
    "medium": ModelConfig(num_layers=6, channels=64),
    "full": ModelConfig(num_layers=12, channels=128),  # Maddison et al. scale
    "large": ModelConfig(num_layers=13, channels=256),  # AlphaGo SL-policy scale
}


class PositionBiasConv(nn.Module):
    """A SAME-padded convolution without bias, then a bias per output
    channel and board point: ``weight`` (c_out, c_in, k, k), ``bias``
    (c_out, 19, 19)."""

    def __init__(self, k: int, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out, BOARD_SIZE, BOARD_SIZE))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.weight.to(x.dtype),
                     padding=self.weight.shape[-1] // 2)
        return x + self.bias.to(x.dtype)[None]


class PolicyCNN(nn.Module):
    """The policy network of one ``ModelConfig``; zero-initialised (see
    ``init`` for He-normal weights). ``layer_type`` builds each conv layer;
    the int8 network (``models/quant.QuantPolicyCNN``) swaps it and keeps
    this forward."""

    layer_type = PositionBiasConv

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            self.layer_type(k, c_in, c_out)
            for k, c_in, c_out in cfg.layer_shapes())

    def forward(self, planes: torch.Tensor) -> torch.Tensor:
        """planes: (B, 19, 19, 37) NHWC -> logits (B, 361) float32.

        The NHWC planes seen as NCHW are channels-last, the layout the
        convolutions run in; the final 1-channel map flattens row-major, so
        point (x, y) is logit ``19*x + y``."""
        x = planes.permute(0, 3, 1, 2).to(self.cfg.torch_dtype)
        last = len(self.layers) - 1
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            relu = i < last or self.cfg.final_relu
            if remat:
                x = checkpoint(_conv_layer, layer, x, relu,
                               use_reentrant=False)
            else:
                x = _conv_layer(layer, x, relu)
        return x.reshape(x.shape[0], NUM_POINTS).float()


def _conv_layer(layer: nn.Module, x: torch.Tensor, relu: bool
                ) -> torch.Tensor:
    x = layer(x)
    return F.relu(x) if relu else x


def init(generator: torch.Generator, cfg: ModelConfig,
         device="cuda") -> PolicyCNN:
    """He-normal conv weights, zero per-position biases, drawn on the CPU
    from ``generator`` (so one seed gives the same weights on every device)
    and moved to ``device``. The numbers differ from ``jax.random``'s:
    parity tests share weights through ``models/convert.py``."""
    device = resolve_device(device)
    model = PolicyCNN(cfg)
    with torch.no_grad():
        for layer in model.layers:
            c_out, c_in, k, _ = layer.weight.shape
            w = torch.randn(layer.weight.shape, generator=generator)
            layer.weight.copy_(w * math.sqrt(2.0 / (k * k * c_in)))
    return model.to(device)


def apply(model: PolicyCNN, planes: torch.Tensor) -> torch.Tensor:
    """planes: (B, 19, 19, 37) -> logits (B, 361) float32."""
    return model(planes)


def log_policy(model: PolicyCNN, planes: torch.Tensor) -> torch.Tensor:
    """Log-probabilities over the 361 board points; the logits are float32
    before the log-softmax, as in the JAX package."""
    return F.log_softmax(model(planes), dim=-1)
