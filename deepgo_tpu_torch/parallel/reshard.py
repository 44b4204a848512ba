"""Resharding checkpoint layer: restore a training state under another
layout than the one that saved it.

The port of ``deepgo_tpu/parallel/reshard.py``. Checkpoints hold full,
gathered arrays in the JAX layout, so a checkpoint is layout-free; this
module owns the contract around it:

  * **placement** — ``Placement`` states where every leaf of a state
    lives under one D x M (x ZeRO) layout: parameters channel-sharded over
    "model" when ``tensor_parallel > 1`` (``parallel/tensor.py``), the
    optimizer state on its parameter's placement plus, with ``zero_opt``,
    "data" on its first free divisible dimension (``parallel/zero.py``).
    ``composed_shardings`` and ``place_state`` build it and put a full
    state there.
  * **manifest** — the ``mesh`` block of a checkpoint's meta: the grid
    that wrote it, whether ZeRO was on, and each leaf's partition spec,
    with the JAX package's strings for the same layout. One difference is
    recorded, not hidden: under tensor parallelism without ZeRO the JAX
    package replicates the optimizer state, and the port keeps it on its
    parameter's "model" shard and says so.
  * **gather / scatter** — the two halves of a reshard: ``gather_to_host``
    all-gathers every shard into full host arrays (the save path),
    ``scatter`` cuts this rank's shards out of full arrays (every rank
    reads the checkpoint). Both are ``DEEPGO_FAULTS`` sites
    (``reshard_gather`` / ``reshard_scatter``, and ``reshard_collective``
    for the group barrier that ends a scatter) under bounded full-jitter
    retry, timed by histograms. A reshard moves values, never changes
    them: it is bitwise.
  * **restore** — a scatter followed by the port's own placement check:
    each local shard's shape against the shape its declared spec gives.
    Mismatches are returned as findings (empty in parity).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..experiments.checkpoint import MANIFEST_VERSION, tree_leaves
from ..models import policy_cnn
from ..models.convert import (named_to_jax, opt_state_from_jax,
                              opt_state_to_jax, params_from_jax)
from ..utils import faults
from ..utils.retry import retry_with_backoff
from .mesh import Mesh
from .tensor import (jax_shape, local_slice, param_shapes, param_shardings,
                     port_dim)
from .zero import zero_sharding


def _registry():
    from ..obs import get_registry

    return get_registry()


def composed_shardings(shapes: dict, mesh: Mesh, *, tensor_parallel: int
                       ) -> dict:
    """The parameters' specs: channel-sharded over "model" when tensor
    parallelism is on, replicated (``()``) otherwise."""
    if tensor_parallel > 1:
        return param_shardings(shapes, mesh)
    return {name: () for name in shapes}


@dataclass
class Placement:
    """Where each leaf of a (model, optimizer state) pair lives under one
    layout. ``shapes`` are the full port shapes; specs are JAX-layout
    tuples, the optimizer state's for each of its per-parameter trees."""

    mesh: Mesh
    tensor_parallel: int
    zero_opt: bool
    shapes: dict
    param_specs: dict = field(init=False)
    opt_specs: dict = field(init=False)

    def __post_init__(self):
        self.param_specs = composed_shardings(
            self.shapes, self.mesh, tensor_parallel=self.tensor_parallel)
        # the optimizer state sits on its parameter's placement, plus
        # "data" under ZeRO
        self.opt_specs = dict(self.param_specs)
        if self.zero_opt:
            jshapes = {n: jax_shape(n, s) for n, s in self.shapes.items()}
            self.opt_specs = zero_sharding(self.param_specs, jshapes,
                                           self.mesh.shape["data"])

    @classmethod
    def for_model(cls, cfg: policy_cnn.ModelConfig, mesh: Mesh, *,
                  tensor_parallel: int, zero_opt: bool) -> "Placement":
        return cls(mesh, tensor_parallel, zero_opt, param_shapes(cfg))

    def model_dim(self, name: str) -> int | None:
        return port_dim(name, self.param_specs[name], "model")

    def data_dim(self, name: str) -> int | None:
        return port_dim(name, self.opt_specs[name], "data")

    def _index(self, axis: str) -> tuple[int, int]:
        return self.mesh.local_index(axis), self.mesh.shape[axis]

    def local_param(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full parameter (a view)."""
        return local_slice(full, self.model_dim(name), *self._index("model"))

    def local_opt(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full optimizer-state leaf (a view)."""
        leaf = local_slice(full, self.model_dim(name), *self._index("model"))
        return local_slice(leaf, self.data_dim(name), *self._index("data"))

    def local_shape(self, name: str, spec: tuple) -> tuple:
        """The shape a leaf of spec ``spec`` has on one rank."""
        shape = list(self.shapes[name])
        for axis in ("model", "data"):
            dim = port_dim(name, spec, axis)
            if dim is not None:
                shape[dim] //= self.mesh.shape[axis]
        return tuple(shape)


def _spec_str(spec: tuple) -> str:
    """A spec as the JAX package prints its ``PartitionSpec``."""
    return "PartitionSpec" + repr(tuple(spec))


def _jax_named(params) -> dict:
    """``{port name: port shape}`` of a JAX-layout policy tree."""
    shapes = {}
    for i, layer in enumerate(params["layers"]):
        k, _, c_in, c_out = np.shape(layer["w"])
        h, w, _ = np.shape(layer["b"])
        shapes[f"layers.{i}.weight"] = (c_out, c_in, k, k)
        shapes[f"layers.{i}.bias"] = (c_out, h, w)
    return shapes


def _spec_tree(params, specs: dict):
    """A tree shaped like the JAX-layout ``params`` holding spec strings."""
    return {"layers": [{"b": _spec_str(specs[f"layers.{i}.bias"]),
                        "w": _spec_str(specs[f"layers.{i}.weight"])}
                       for i in range(len(params["layers"]))]}


def manifest(mesh: Mesh, params, opt_state, *, zero_opt: bool,
             tensor_parallel: int = 1) -> dict:
    """The mesh manifest a checkpoint's meta carries, from the layout and
    the leaves' shapes alone (``params`` and ``opt_state`` are JAX-layout
    trees of arrays or anything with a shape). Restore does not replay
    these specs (the target layout derives its own); they make a layout
    change auditable and structurally verifiable
    (``checkpoint.validate_manifest``)."""
    placement = Placement(mesh, tensor_parallel, zero_opt, _jax_named(params))
    state = {"rate": _spec_str(())}
    for key in opt_state:
        if key != "rate":
            state[key] = _spec_tree(opt_state[key], placement.opt_specs)
    return {
        "version": MANIFEST_VERSION,
        "data": int(mesh.shape["data"]),
        "model": int(mesh.shape["model"]),
        "devices": int(mesh.size),
        "zero_opt": bool(zero_opt),
        "params": tree_leaves(_spec_tree(params, placement.param_specs)),
        "opt_state": tree_leaves(state),
    }


def full_templates(placement: Placement, opt_state: dict | None):
    """JAX-layout trees of the full shapes (zero-stride arrays) of the
    parameters and of an optimizer state with ``opt_state``'s trees: the
    templates a checkpoint's flat leaves unflatten into."""
    params = {"layers": []}
    for i in range(len(placement.shapes) // 2):
        w = placement.shapes[f"layers.{i}.weight"]
        b = placement.shapes[f"layers.{i}.bias"]
        params["layers"].append({
            "b": np.broadcast_to(np.float32(0), jax_shape("x.bias", b)),
            "w": np.broadcast_to(np.float32(0), jax_shape("x.weight", w))})
    if opt_state is None:
        return params, None
    state = {"rate": np.float32(0)}
    for key, value in opt_state.items():
        if isinstance(value, dict):
            state[key] = params
    return params, state


def place_state(model: policy_cnn.PolicyCNN, opt_state: dict | None,
                placement: Placement):
    """A full (single-device) model and optimizer state -> this rank's
    network (``parallel/tensor.shard_params``) and state shards (copies).
    ``opt_state`` may be None: the caller then creates it from the placed
    network, as ``optimizer.init`` inherits its shapes."""
    from .tensor import shard_params

    local = shard_params(model, placement.mesh)
    if opt_state is None:
        return local, None
    state = {k: ({n: placement.local_opt(n, t).clone() for n, t in v.items()}
                 if isinstance(v, dict) else v)
             for k, v in opt_state.items()}
    return local, state


def _gather_dim(local: torch.Tensor, dim: int | None, mesh: Mesh,
                axis: str) -> torch.Tensor:
    """The full tensor from every rank's part along ``dim`` over ``axis``."""
    if dim is None or mesh.shape[axis] == 1:
        return local
    part = local.contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, part, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def gather_state(model, opt_state: dict, placement: Placement):
    """Every rank's shards gathered into full port tensors: (named params,
    optimizer state), on every rank of the mesh (a collective)."""
    mesh = placement.mesh
    params = {n: _gather_dim(p.detach(), placement.model_dim(n), mesh,
                             "model")
              for n, p in model.named_parameters()}
    state = {}
    for key, value in opt_state.items():
        if not isinstance(value, dict):
            state[key] = value
            continue
        state[key] = {}
        for n, leaf in value.items():
            leaf = _gather_dim(leaf, placement.data_dim(n), mesh, "data")
            state[key][n] = _gather_dim(leaf, placement.model_dim(n), mesh,
                                        "model")
    return params, state


def gather_to_host(model, opt_state: dict, placement: Placement):
    """The gather half of a reshard: full JAX-layout host trees of the
    parameters and optimizer state. A ``DEEPGO_FAULTS`` site with bounded
    full-jitter retry: transient faults are absorbed, hard ones surface."""

    def gather():
        faults.check("reshard_gather")
        faults.maybe_slow("reshard_gather")
        params, state = gather_state(model, opt_state, placement)
        return named_to_jax(params), opt_state_to_jax(state)

    t0 = time.monotonic()
    out = retry_with_backoff(gather, attempts=4, base_delay=0.05,
                             jitter=True)
    _registry().histogram(
        "deepgo_reshard_gather_seconds",
        "host-gather time of one reshard (params + optimizer state)",
    ).observe(time.monotonic() - t0)
    return out


def scatter(params, opt_state, placement: Placement, device):
    """The scatter half of a reshard: this rank's shards of full
    JAX-layout host trees, as (named params, optimizer state) on
    ``device``. Same fault-site and retry contract as the gather; the
    ``reshard_collective`` site covers the group barrier that ends it (a
    slow@MS spec emulates a collective timeout without killing anything)."""

    def place():
        faults.check("reshard_scatter")
        faults.check("reshard_collective")
        faults.maybe_slow("reshard_scatter")
        faults.maybe_slow("reshard_collective")
        named = {n: placement.local_param(n, t).contiguous().to(device)
                 for n, t in params_from_jax(params).items()}
        state = None
        if opt_state is not None:
            full = opt_state_from_jax(opt_state, "cpu")
            state = {k: ({n: placement.local_opt(n, t).contiguous().to(device)
                          for n, t in v.items()}
                         if isinstance(v, dict) else v.to(device))
                     for k, v in full.items()}
        if placement.mesh.device_mesh is not None:
            dist.barrier()
        return named, state

    t0 = time.monotonic()
    out = retry_with_backoff(place, attempts=4, base_delay=0.05,
                             jitter=True)
    _registry().histogram(
        "deepgo_reshard_scatter_seconds",
        "device re-scatter time of one reshard under the target mesh",
    ).observe(time.monotonic() - t0)
    return out


def check_placement(label: str, named: dict, specs: dict,
                    placement: Placement) -> list[dict]:
    """Each local shard's shape against the shape its declared spec
    gives; a finding per mismatch."""
    findings = []
    for name, tensor in named.items():
        want = placement.local_shape(name, specs[name])
        if tuple(tensor.shape) != want:
            findings.append({"check": label, "leaf": name,
                             "spec": _spec_str(specs[name]),
                             "shape": tuple(tensor.shape), "want": want})
    return findings


def restore(params, opt_state, placement: Placement, device) -> tuple:
    """One full reshard of host trees into ``placement``: returns (named
    params, optimizer state, findings), the findings from the placement
    check of every leaf (empty in parity)."""
    named, state = scatter(params, opt_state, placement, device)
    findings = check_placement("reshard.params", named,
                               placement.param_specs, placement)
    for key, value in (state or {}).items():
        if isinstance(value, dict):
            findings += check_placement(f"reshard.opt_state.{key}", value,
                                        placement.opt_specs, placement)
    _registry().counter(
        "deepgo_reshard_restores_total",
        "training states re-scattered under a (possibly different) mesh",
    ).inc()
    return named, state, findings
