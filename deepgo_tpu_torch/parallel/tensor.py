"""Tensor parallelism: channel-sharded convolutions over the "model" axis.

The port of ``deepgo_tpu/parallel/tensor.py``. The placement rule is the
JAX package's: a layer whose ``c_out`` divides over the M model ranks
shards its weight's out-channels and its (C, 19, 19) per-position bias
over "model"; any other layer (the 1-channel head, an odd
``channel_schedule`` width) stays replicated. Specs are stated in the JAX
layout (HWIO weights, (19, 19, C) biases), so the checkpoint manifest reads
as the JAX package's; ``port_dim`` maps a JAX dimension to the port's OIHW
/ (C, 19, 19) one.

Where XLA's partitioner derives the collectives from the placement, the
port's tensor-parallel forward spells them out as the Megatron pair of
autograd functions around each sharded convolution:

  * before it, ``copy``: identity forward, all-reduce (sum) of the input
    gradient over "model" backward — every model rank holds the whole
    input, and each contributes its shard's part of the input gradient;
  * after it, ``gather``: all-gather of the channel shards forward, each
    rank's own slice of the gradient backward. The replicated head's input
    gradient is already whole on every model rank; summing it instead of
    slicing would count it M times.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..models import policy_cnn
from .mesh import Mesh

# the port dimension of each JAX-layout dimension: HWIO -> OIHW weights,
# (19, 19, C) -> (C, 19, 19) biases
_PORT_DIMS = {"weight": (2, 3, 1, 0), "bias": (1, 2, 0)}


def _kind(name: str) -> str:
    return name.rsplit(".", 1)[1]


def jax_shape(name: str, shape) -> tuple:
    """A parameter's shape in the JAX layout, from its port shape."""
    return tuple(shape[d] for d in _PORT_DIMS[_kind(name)])


def port_dim(name: str, spec: tuple, axis: str) -> int | None:
    """The port dimension that ``spec`` (JAX layout) places on ``axis``."""
    for j, a in enumerate(spec):
        if a == axis:
            return _PORT_DIMS[_kind(name)][j]
    return None


def param_shapes(cfg: policy_cnn.ModelConfig) -> dict[str, tuple]:
    """Every parameter's full port shape, in ``named_parameters`` order."""
    shapes = {}
    for i, (k, c_in, c_out) in enumerate(cfg.layer_shapes()):
        shapes[f"layers.{i}.weight"] = (c_out, c_in, k, k)
        shapes[f"layers.{i}.bias"] = (c_out, policy_cnn.BOARD_SIZE,
                                      policy_cnn.BOARD_SIZE)
    return shapes


def param_shardings(shapes: dict[str, tuple], mesh: Mesh) -> dict[str, tuple]:
    """Each parameter's spec (JAX layout, a tuple of axis names or None):
    out-channels on "model" where they divide, else replicated (``()``)."""
    m = mesh.shape["model"]
    specs = {}
    for name, shape in shapes.items():
        jshape = jax_shape(name, shape)
        if jshape[-1] % m != 0:  # e.g. the 1-channel head
            specs[name] = ()
        else:
            specs[name] = (None,) * (len(jshape) - 1) + ("model",)
    return specs


class _Copy(torch.autograd.Function):
    """Identity forward; all-reduce (sum) of the gradient over "model"."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather of the channel shards forward; this rank's slice of the
    gradient backward. Activations are NCHW seen as channels-last: the
    gather runs on the NHWC view, whose channels are innermost, so the
    result keeps the layout the convolutions run in."""

    @staticmethod
    def forward(ctx, y, group, index, parts):
        ctx.index, ctx.width = index, y.shape[1]
        nhwc = y.permute(0, 2, 3, 1).contiguous()
        out = [torch.empty_like(nhwc) for _ in range(parts)]
        dist.all_gather(out, nhwc, group=group)
        return torch.cat(out, dim=3).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(1, ctx.index * ctx.width, ctx.width),
                None, None, None)


class TensorParallelPolicyCNN(policy_cnn.PolicyCNN):
    """A ``PolicyCNN`` holding this model rank's shard of every sharded
    layer (``weight`` (c_out / M, c_in, k, k), ``bias`` (c_out / M, 19,
    19)) and the whole of every replicated one. Its forward gives the
    single-device network's logits on every model rank."""

    def __init__(self, cfg: policy_cnn.ModelConfig, mesh: Mesh):
        super().__init__(cfg)
        self.mesh = mesh
        m = mesh.shape["model"]
        specs = param_shardings(param_shapes(cfg), mesh)
        self.sharded = {i for i in range(len(self.layers))
                        if specs[f"layers.{i}.weight"]}
        for i in self.sharded:
            layer = self.layers[i]
            c_out = layer.weight.shape[0] // m
            layer.weight = nn.Parameter(layer.weight[:c_out].clone())
            layer.bias = nn.Parameter(layer.bias[:c_out].clone())

    def apply_layer(self, i, x, relu, remat):
        if i not in self.sharded:
            return super().apply_layer(i, x, relu, remat)
        group = self.mesh.group("model")
        x = _Copy.apply(x, group)
        y = super().apply_layer(i, x, relu, remat)
        return _Gather.apply(y, group, self.mesh.local_index("model"),
                             self.mesh.shape["model"])


def local_slice(tensor: torch.Tensor, dim: int | None, index: int,
                parts: int) -> torch.Tensor:
    """Part ``index`` of ``parts`` equal parts of ``tensor`` along
    ``dim`` (a view); the whole tensor for ``dim=None``."""
    if dim is None:
        return tensor
    n = tensor.shape[dim] // parts
    return tensor.narrow(dim, index * n, n)


def shard_params(model: policy_cnn.PolicyCNN, mesh: Mesh
                 ) -> policy_cnn.PolicyCNN:
    """The network this rank holds: ``model`` itself when "model" has one
    rank, else a ``TensorParallelPolicyCNN`` with this rank's shards of
    ``model``'s parameters, on ``model``'s device."""
    if mesh.shape["model"] == 1:
        return model
    device = next(model.parameters()).device
    tp = TensorParallelPolicyCNN(model.cfg, mesh).to(device)
    specs = param_shardings(param_shapes(model.cfg), mesh)
    index = mesh.local_index("model")
    full = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in tp.named_parameters():
            dim = port_dim(name, specs[name], "model")
            p.copy_(local_slice(full[name], dim, index,
                                mesh.shape["model"]))
    return tp
