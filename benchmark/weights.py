"""The network's weights, made on the device from the run's seed.

One ``torch.randn`` on a generator of the device fills a single float32
buffer; each layer's weight is its He-normal view (std sqrt(2 / fan_in)),
each per-position bias a view at ``bias_std``. The benchmark owns these
tensors: it copies them into the program's network and hands the same
tensors, never the program's, to the reference.
"""

from __future__ import annotations

import math

import torch

from . import cost


def make(cfg: dict, seed: int, device
         ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """[(w (c_out, c_in, k, k), b (c_out, 19, 19))] float32 on ``device``."""
    shapes = cost.layer_shapes(cfg)
    sizes = []
    for k, c_in, c_out in shapes:
        sizes += [c_out * c_in * k * k, c_out * cost.POINTS]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    parts = iter(flat.split(sizes))
    out = []
    for k, c_in, c_out in shapes:
        w = next(parts).view(c_out, c_in, k, k)
        w.mul_(math.sqrt(2.0 / (k * k * c_in)))
        b = next(parts).view(c_out, cost.BOARD, cost.BOARD)
        b.mul_(cfg["bias_std"])
        out.append((w, b))
    return out


def load_into(model: torch.nn.Module, weights) -> None:
    """Copy the benchmark's weights into the program's network (its
    ``layers[i].weight`` / ``.bias``)."""
    with torch.no_grad():
        for layer, (w, b) in zip(model.layers, weights):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
