"""Policy weights between the JAX package's pytree and the port's module.

The JAX package keeps ``{"layers": [{"w": (k, k, c_in, c_out) HWIO,
"b": (19, 19, c_out)}, ...]}``; ``PolicyCNN`` keeps per layer ``weight``
(c_out, c_in, k, k) OIHW and ``bias`` (c_out, 19, 19). The quantized tree
(``{"w_q", "w_scale", "b"}`` per layer) maps to ``QuantPolicyCNN``'s
``w_q`` / ``w_scale`` / ``bias`` buffers the same way. An optimizer state
(``training/optimizers.py``) maps its ``velocity`` / ``accum`` trees through
the same transposes and its ``rate`` as a float32 scalar. The value net's
tree (``models/value_cnn.py``) adds ``head_conv`` (a conv like the
policy's) and the dense layers ``dense1`` / ``dense2``, whose (in, out)
weights become ``nn.Linear``'s (out, in); an optimizer state over it maps
through ``value_opt_state_to_jax``. Both directions are transposes
only, so a round trip is bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..analysis.cudacheck import place, stage_d2h
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


def named_to_jax(named: dict[str, torch.Tensor]) -> dict:
    """``{"layers.{i}.weight": OIHW, "layers.{i}.bias": (C, 19, 19)}`` ->
    the JAX-layout tree of float32 numpy arrays."""
    layers = []
    for i in range(len(named) // 2):
        w = stage_d2h(named[f"layers.{i}.weight"].detach())
        b = stage_d2h(named[f"layers.{i}.bias"].detach())
        layers.append({"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                       "b": np.ascontiguousarray(b.transpose(1, 2, 0))})
    return {"layers": layers}


def params_to_jax(model: PolicyCNN) -> dict:
    """A ``PolicyCNN`` -> the JAX-layout tree of float32 numpy arrays."""
    return named_to_jax(dict(model.named_parameters()))


_OPT_TREES = ("velocity", "accum")


def opt_state_from_jax(tree, device="cuda") -> dict:
    """A JAX optimizer state (``{"rate": scalar, "velocity" | "accum":
    policy tree}``) -> the port's state on ``device``: ``rate`` a 0-d
    float32 tensor, each tree a dict from parameter name to tensor."""
    device = resolve_device(device)
    state = {"rate": place(np.array(tree["rate"], dtype=np.float32),
                           device)}
    for key in _OPT_TREES:
        if key in tree:
            state[key] = {n: place(t, device)
                          for n, t in params_from_jax(tree[key]).items()}
    return state


def opt_state_to_jax(state: dict) -> dict:
    """The port's optimizer state -> the JAX layout, numpy arrays."""
    tree = {"rate": stage_d2h(state["rate"].detach())}
    for key in _OPT_TREES:
        if key in state:
            tree[key] = named_to_jax(state[key])
    return tree


def qparams_from_jax(qtree) -> dict[str, torch.Tensor]:
    """A JAX-layout quantized tree ``{"layers": [{"w_q": (k, k, c_in,
    c_out) int8 HWIO, "w_scale": (c_out,) f32, "b": (19, 19, c_out) f32},
    ...]}`` -> a ``QuantPolicyCNN`` state dict of CPU tensors."""
    state = {}
    for i, layer in enumerate(qtree["layers"]):
        w_q = np.asarray(layer["w_q"], dtype=np.int8)
        b = np.asarray(layer["b"], dtype=np.float32)
        state[f"layers.{i}.w_q"] = torch.from_numpy(
            np.ascontiguousarray(w_q.transpose(3, 2, 0, 1)))
        state[f"layers.{i}.w_scale"] = torch.from_numpy(
            np.array(layer["w_scale"], dtype=np.float32))
        state[f"layers.{i}.bias"] = torch.from_numpy(
            np.ascontiguousarray(b.transpose(2, 0, 1)))
    return state


def qparams_to_jax(qmodel) -> dict:
    """A ``QuantPolicyCNN`` -> the JAX-layout quantized tree of numpy
    arrays (int8 ``w_q`` HWIO, float32 ``w_scale`` and ``b``)."""
    layers = []
    for layer in qmodel.layers:
        w_q = layer.w_q.detach().cpu().numpy()
        b = layer.bias.detach().cpu().numpy()
        layers.append({"w_q": np.ascontiguousarray(w_q.transpose(2, 3, 1, 0)),
                       "w_scale": layer.w_scale.detach().cpu().numpy(),
                       "b": np.ascontiguousarray(b.transpose(1, 2, 0))})
    return {"layers": layers}


def value_from_jax(tree) -> dict[str, torch.Tensor]:
    """A JAX-layout value tree (``{"layers": [{"w", "b"}, ...],
    "head_conv": {"w", "b"}, "dense1": {"w" (in, out), "b"}, "dense2":
    ...}``) -> a ``ValueCNN`` state dict of float32 CPU tensors: the convs
    as the policy net's, the dense weights transposed to (out, in)."""
    state = params_from_jax(tree)
    head = params_from_jax({"layers": [tree["head_conv"]]})
    state["head_conv.weight"] = head["layers.0.weight"]
    state["head_conv.bias"] = head["layers.0.bias"]
    for name in ("dense1", "dense2"):
        w = np.asarray(tree[name]["w"], dtype=np.float32)
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        state[f"{name}.bias"] = torch.from_numpy(
            np.array(tree[name]["b"], dtype=np.float32))
    return state


def value_to_jax(model) -> dict:
    """A ``ValueCNN`` -> the JAX-layout value tree of float32 numpy
    arrays."""
    return _value_named_to_jax(dict(model.named_parameters()))


def value_opt_state_to_jax(state: dict) -> dict:
    """An optimizer state over a ``ValueCNN``'s parameters -> the JAX
    layout, numpy arrays."""
    tree = {"rate": state["rate"].detach().cpu().numpy()}
    for key in _OPT_TREES:
        if key in state:
            tree[key] = _value_named_to_jax(state[key])
    return tree


def _value_named_to_jax(named: dict[str, torch.Tensor]) -> dict:
    tree = named_to_jax({k: v for k, v in named.items()
                         if k.startswith("layers.")})
    tree["head_conv"] = named_to_jax({
        "layers.0.weight": named["head_conv.weight"],
        "layers.0.bias": named["head_conv.bias"]})["layers"][0]
    for name in ("dense1", "dense2"):
        tree[name] = {
            "w": np.ascontiguousarray(
                named[f"{name}.weight"].detach().cpu().numpy().T),
            "b": named[f"{name}.bias"].detach().cpu().numpy()}
    return tree


def model_from_jax(tree, cfg: ModelConfig, device="cuda") -> PolicyCNN:
    """A ``PolicyCNN`` of ``cfg`` holding the JAX tree's weights, on
    ``device``. Raises when the tree's shapes do not fit ``cfg``."""
    device = resolve_device(device)
    model = PolicyCNN(cfg)
    model.load_state_dict(params_from_jax(tree))
    return model.to(device)
