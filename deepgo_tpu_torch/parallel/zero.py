"""Cross-replica optimizer-state sharding — ZeRO stage 1.

The port of ``deepgo_tpu/parallel/zero.py`` (arXiv:2004.13336). Plain data
parallelism keeps the whole optimizer state on every data rank and every
rank applies the same update; here each data rank keeps 1/D of each
state leaf, updates only the matching chunk of the parameters, and the
fresh chunks are all-gathered over "data" (one flat buffer a step).

Where each leaf splits is the JAX package's rule (``_leaf_spec``), applied
in the JAX layout: "data" goes on the first dimension that carries no
axis yet and whose size divides over D. Under tensor parallelism a leaf
keeps its "model" dimension and gains "data" on another one (a hidden
(3, 3, C, C) momentum at D = 2 splits its in-channels). Scalars (the
rate) and leaves with no such dimension stay replicated. The update is
elementwise, so ZeRO changes where it runs, never its result: the port's
ZeRO runs equal its replicated runs bitwise.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..training.optimizers import Optimizer
from .tensor import local_slice


def _leaf_spec(shape: tuple, base: tuple, n_data: int) -> tuple:
    """Merge "data" into a leaf's spec (JAX layout) on the first free,
    divisible dimension; scalars and indivisible shapes keep ``base``."""
    spec = list(base) + [None] * (len(shape) - len(base))
    if "data" not in spec:
        for axis, size in enumerate(shape):
            if spec[axis] is None and size % n_data == 0 and size >= n_data:
                spec[axis] = "data"
                break
    return tuple(spec)


def zero_sharding(param_specs: dict, jax_shapes: dict, n_data: int) -> dict:
    """The ZeRO spec of each parameter's optimizer-state leaf: its
    parameter's spec (the tensor-parallel placement it inherits) with
    "data" merged in."""
    return {name: _leaf_spec(jax_shapes[name], spec, n_data)
            for name, spec in param_specs.items()}


def _trees(state: dict) -> list[str]:
    """The state's per-parameter trees (``velocity`` / ``accum``)."""
    return [k for k, v in state.items() if isinstance(v, dict)]


def shard_opt_state(state: dict, placement) -> dict:
    """This data rank's chunk (a copy) of every per-parameter leaf of a
    state whose leaves already have this rank's tensor-parallel shape.

    Verified against the declared map when ``DEEPGO_XLACHECK=1``
    (``analysis/cudacheck.check_sharding``): a ZeRO leaf that silently
    stayed whole is a recorded sharding-claim finding."""
    from ..analysis import cudacheck

    d, index = placement.mesh.shape["data"], placement.mesh.local_index("data")
    out = {k: ({n: local_slice(t, placement.data_dim(n), index, d).clone()
                for n, t in v.items()} if isinstance(v, dict) else v)
           for k, v in state.items()}
    for tree in _trees(out):
        cudacheck.check_sharding("zero.opt_state", out[tree],
                                 placement.opt_specs, placement)
    return out


def shard_optimizer(optimizer: Optimizer, placement) -> Optimizer:
    """``optimizer`` with ZeRO-1 state: ``init`` keeps this data rank's
    chunks, ``update`` steps the chunks of the parameters they cover and
    all-gathers the fresh chunks over "data". A state with no
    per-parameter leaf (plain SGD) has nothing to shard, and every rank
    updates the whole parameters, as in the JAX package."""
    mesh = placement.mesh
    d = mesh.shape["data"]

    def init(model):
        return shard_opt_state(optimizer.init(model), placement)

    def apply(names, params, grads, state):
        if not _trees(state):
            return optimizer.apply(names, params, grads, state)
        index = mesh.local_index("data")
        dims = [placement.data_dim(n) for n in names]
        new_state = optimizer.apply(
            names,
            [local_slice(p, dim, index, d) for p, dim in zip(params, dims)],
            [local_slice(g, dim, index, d) for g, dim in zip(grads, dims)],
            state)
        if d > 1:
            _gather_chunks([(p, dim) for p, dim in zip(params, dims)
                            if dim is not None], mesh)
        return new_state

    def update(model, grads, state):
        names, params = zip(*model.named_parameters())
        return apply(list(names), list(params), grads, state)

    return Optimizer(init, update, apply)


@torch.no_grad()
def _gather_chunks(leaves: list, mesh) -> None:
    """All-gather every rank's chunk of ``leaves`` ((param, data dim)
    pairs) over "data" in one flat buffer, into the params in place."""
    d, index = mesh.shape["data"], mesh.local_index("data")
    own = [local_slice(p, dim, index, d) for p, dim in leaves]
    flat = torch.cat([c.reshape(-1) for c in own])
    parts = [torch.empty_like(flat) for _ in range(d)]
    dist.all_gather(parts, flat, group=mesh.group("data"))
    sizes = [c.numel() for c in own]
    for r, part in enumerate(parts):
        if r == index:
            continue
        for (p, dim), chunk, c in zip(leaves, part.split(sizes), own):
            local_slice(p, dim, r, d).copy_(chunk.view(c.shape))


def sharded_fraction(placement, opt_state: dict) -> float:
    """Diagnostic: the fraction of ``opt_state``'s elements (counted at
    their full sizes) that ``placement`` shards rather than replicates;
    the rate is one replicated element."""
    total, sharded = 1, 0
    for name, shape in placement.shapes.items():
        n = math.prod(shape) * len(_trees(opt_state))
        total += n
        if any(a is not None and placement.mesh.shape[a] > 1
               for a in placement.opt_specs[name]):
            sharded += n
    return sharded / total
