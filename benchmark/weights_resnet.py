"""AlphaGo Zero's network's leaves, made on the device from the run's seed.

One ``torch.randn`` on a generator of the device fills a single float32
buffer; each convolution and dense weight is its He-normal view (std
sqrt(2 / fan_in)), each BN scale 1 + N(0, std^2), each BN shift and dense
bias N(0, std^2), ``std`` the configuration's ``init_std``, so that the
comparison covers them (the program's own init leaves them at 1 and 0).
The leaves are named and ordered as ``reference/agz.leaf_shapes`` gives
them. The benchmark owns these tensors: it copies them into the program's
network and hands the same tensors, never the program's, to the reference.
"""

from __future__ import annotations

import math

import torch

from .reference import agz


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    shapes = agz.leaf_shapes(cfg["blocks"], cfg["channels"],
                             cfg["input_planes"], cfg["value_hidden"])
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(shapes, flat.split(sizes)):
        t = part.view(shape)
        if name.endswith(".bn.weight"):
            t.mul_(cfg["init_std"]).add_(1.0)
        elif name.endswith(".weight"):
            t.mul_(math.sqrt(2.0 / math.prod(shape[1:])))
        else:
            t.mul_(cfg["init_std"])
        out[name] = t
    return out


def load_into(model: torch.nn.Module, leaves: dict) -> None:
    """Copy the benchmark's leaves into the program's network, by name; the
    two must name the same parameters."""
    named = dict(model.named_parameters())
    if list(named) != list(leaves):
        raise ValueError("the program's parameters are not the reference's "
                         f"leaves: {sorted(set(named) ^ set(leaves))[:4]}")
    with torch.no_grad():
        for name, t in leaves.items():
            named[name].copy_(t)
