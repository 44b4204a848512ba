"""Optimizers as init / update pairs over a ``PolicyCNN``'s parameters.

The port of ``deepgo_tpu/training/optimizers.py``: SGD whose rate decays
multiplicatively every step (the reference's optimizer.lua:16-27), with
optional classical momentum, and the RMS-accumulator Adagrad.

The state is a dict of tensors with the JAX state's keys: ``rate`` is a
0-d float32 tensor on the parameters' device (so ``rate * (1 - decay)``
rounds to float32 every step, as in JAX), and ``velocity`` / ``accum`` map
each parameter name (``layers.{i}.weight`` / ``layers.{i}.bias``) to a
tensor shaped like it. ``models/convert.py`` maps a state to and from the
JAX pytree. ``update`` writes the new parameters into the model in place,
under ``torch.no_grad()``, and returns the new state.

The arithmetic is the JAX package's, in float32, in the form XLA compiles
it to: XLA contracts ``p - r * g``, ``momentum * v + g`` and Adagrad's
``decay * a + ...`` into fused multiply-adds (one rounding), so the port
writes them as ``addcmul`` and ``add(..., alpha=)``, whose CPU kernels fuse
the same way; on the CPU one SGD or momentum update is bitwise equal to
the JAX update under ``jax.jit``. Adagrad's ``r * g / sqrt(a + eps)`` stays
a correctly rounded square root and division: XLA:CPU rewrites it to a
product with its own approximate ``rsqrt``, which no PyTorch op
reproduces. Against a float64 step from the same float32 accumulator, the
port's parameters stay within 3.5 ulps of |step| plus half an ulp of |p'|
by construction (measured at most 2.29 ulps of |step| over 101 gradient
draws on a 3 x 16 net), JAX's within 1.74 measured; the two packages
differ by up to 3 ulps of |p| + |p'| (tests/test_torch_training.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn


class Optimizer(NamedTuple):
    init: Callable[[nn.Module], dict]
    # (model, grads in model.parameters() order, state) -> new state
    update: Callable[[nn.Module, list, dict], dict]


def _named(model: nn.Module) -> tuple[list[str], list[torch.Tensor]]:
    names, params = zip(*model.named_parameters())
    return list(names), list(params)


def _rate(rate: float, model: nn.Module) -> torch.Tensor:
    device = next(model.parameters()).device
    return torch.tensor(rate, dtype=torch.float32, device=device)


def sgd(rate: float, rate_decay: float = 0.0, momentum: float = 0.0
        ) -> Optimizer:
    """params -= rate * grads; rate *= (1 - rate_decay) each step.
    With momentum: velocity = momentum * velocity + grads, params -= rate *
    velocity."""

    def init(model):
        state = {"rate": _rate(rate, model)}
        if momentum:
            state["velocity"] = {n: torch.zeros_like(p)
                                 for n, p in model.named_parameters()}
        return state

    @torch.no_grad()
    def update(model, grads, state):
        names, params = _named(model)
        r = state["rate"]
        new_state = {"rate": r * (1.0 - rate_decay)}
        if momentum:
            # fma(momentum, v, g)
            grads = torch._foreach_add(
                grads, [state["velocity"][n] for n in names], alpha=momentum)
            new_state["velocity"] = dict(zip(names, grads))
        for p, g in zip(params, grads):
            p.addcmul_(r, g, value=-1.0)  # fma(-r, g, p)
        return new_state

    return Optimizer(init, update)


def adagrad(rate: float, decay: float = 0.95, eps: float = 1e-10
            ) -> Optimizer:
    """accum = decay * accum + (1 - decay) * g^2;
    params -= rate * g / sqrt(accum + eps)."""

    def init(model):
        return {"rate": _rate(rate, model),
                "accum": {n: torch.ones_like(p)
                          for n, p in model.named_parameters()}}

    @torch.no_grad()
    def update(model, grads, state):
        names, params = _named(model)
        r = state["rate"]
        # fma(decay, a, (1 - decay) * g * g), the product left to right
        accum = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, 1.0 - decay), grads),
            [state["accum"][n] for n in names], alpha=decay)
        step = torch._foreach_div(torch._foreach_mul(grads, r),
                                  torch._foreach_sqrt(
                                      torch._foreach_add(accum, eps)))
        torch._foreach_sub_(params, step)
        return {"rate": r, "accum": dict(zip(names, accum))}

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "adagrad": adagrad}
