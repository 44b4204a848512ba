"""Policy weights between the JAX package's pytree and the port's module.

The JAX package keeps ``{"layers": [{"w": (k, k, c_in, c_out) HWIO,
"b": (19, 19, c_out)}, ...]}``; ``PolicyCNN`` keeps per layer ``weight``
(c_out, c_in, k, k) OIHW and ``bias`` (c_out, 19, 19). Both directions are
transposes only, so a round trip is bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .policy_cnn import ModelConfig, PolicyCNN


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A JAX-layout policy tree (numpy arrays, or anything ``np.asarray``
    takes) -> a ``PolicyCNN`` state dict of float32 CPU tensors."""
    state = {}
    for i, layer in enumerate(tree["layers"]):
        w = np.asarray(layer["w"], dtype=np.float32)
        b = np.asarray(layer["b"], dtype=np.float32)
        state[f"layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        state[f"layers.{i}.bias"] = torch.from_numpy(
            np.ascontiguousarray(b.transpose(2, 0, 1)))
    return state


def params_to_jax(model: PolicyCNN) -> dict:
    """A ``PolicyCNN`` -> the JAX-layout tree of float32 numpy arrays."""
    layers = []
    for layer in model.layers:
        w = layer.weight.detach().cpu().numpy()
        b = layer.bias.detach().cpu().numpy()
        layers.append({"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                       "b": np.ascontiguousarray(b.transpose(1, 2, 0))})
    return {"layers": layers}


def model_from_jax(tree, cfg: ModelConfig, device="cuda") -> PolicyCNN:
    """A ``PolicyCNN`` of ``cfg`` holding the JAX tree's weights, on
    ``device``. Raises when the tree's shapes do not fit ``cfg``."""
    device = resolve_device(device)
    model = PolicyCNN(cfg)
    model.load_state_dict(params_from_jax(tree))
    return model.to(device)
