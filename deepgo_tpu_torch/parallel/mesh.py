"""A ("data", "model") grid of ranks and which batch rows each rank holds.

The port of ``deepgo_tpu/parallel/mesh.py``. One rank is one process
driving one device (a CUDA card under NCCL, the CPU under gloo). A mesh of
shape (D, M) lays the ranks of the default process group out data-major:
rank ``d * M + m`` sits at data index d and model index m. Batches split
their rows over "data" (every model rank of one data index holds the same
rows); parameters are replicated over "data" and, under tensor
parallelism, channel-sharded over "model" (``parallel/tensor.py``).

Over a live process group the mesh holds a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names=("data",
"model")`` and hands out its per-axis groups. Without a group the only mesh
is the degenerate 1 x 1 one, and a mesh over explicit ``devices`` (objects
with ``process_index`` and ``id``, as ``hybrid_mesh`` takes for a layout
it only describes) has no groups at all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch.distributed as dist

AXES = ("data", "model")


class RankDevice(NamedTuple):
    """One rank of the default group as a mesh device: each rank is its
    own process, so its process index is its rank."""

    process_index: int
    id: int


def live_devices() -> list[RankDevice]:
    """A device per rank of the default group; one without a group."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return [RankDevice(r, r) for r in range(n)]


class Mesh:
    """``devices``: a (D, M) grid of devices; ``device_mesh``: the live
    ``DeviceMesh`` over the same ranks, or None."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, device_mesh=None):
        self.devices = devices
        self.device_mesh = device_mesh
        self.shape = {"data": int(devices.shape[0]),
                      "model": int(devices.shape[1])}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def local_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 without a live mesh)."""
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        """The process group along ``axis``; None for an axis of size 1
        without a live mesh (nothing to exchange). An axis wider than one
        rank without a live mesh raises: its collectives have no group."""
        if self.device_mesh is not None:
            return self.device_mesh.get_group(axis)
        if self.shape[axis] > 1:
            raise RuntimeError(
                f"mesh {self.shape['data']}x{self.shape['model']} has no "
                f"process group: its {axis!r} axis cannot exchange data")
        return None

    def __repr__(self) -> str:
        live = "live" if self.device_mesh is not None else "layout only"
        return f"Mesh({self.shape['data']}x{self.shape['model']}, {live})"


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """A ("data", "model") mesh. Defaults to every rank of the default
    group on the data axis; ``make_mesh(1, 1)`` without a group is the
    degenerate single-device mesh. Over the live ranks the mesh must use
    every one of them (a process group cannot leave a rank out);
    ``devices`` gives a layout-only mesh over those objects."""
    from .liveness import ConfigError

    live = devices is None
    devices = list(live_devices() if live else devices)
    if n_data is None:
        n_data = len(devices) // n_model
    used = n_data * n_model
    if n_data < 1 or n_model < 1:
        raise ConfigError(f"mesh {n_data}x{n_model} has an empty axis")
    if used > len(devices):  # typed, not assert: must fail under python -O
        raise ConfigError(
            f"mesh {n_data}x{n_model} needs {used} devices, have "
            f"{len(devices)}")
    grid = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(devices[:used]):
        grid[i // n_model, i % n_model] = d
    if not (live and dist.is_initialized()):
        return Mesh(grid)
    if used != len(devices):
        raise ConfigError(
            f"mesh {n_data}x{n_model} uses {used} of the group's "
            f"{len(devices)} ranks; every rank of the group must be in it")
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = np.array([[d.id for d in row] for row in grid])
    return Mesh(grid, DeviceMesh(device_type, ranks.tolist(),
                                 mesh_dim_names=AXES))


@dataclass(frozen=True)
class RowSharding:
    """Which rows of a batch this rank holds: ``dim`` of each array splits
    over the mesh's "data" axis (None: every rank holds all of it)."""

    mesh: Mesh
    dim: int | None

    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row dimension."""
        if self.dim is None:
            return slice(0, n)
        d = self.mesh.shape["data"]
        if n % d:
            from .liveness import ConfigError

            raise ConfigError(f"{n} rows do not divide over {d} data ranks")
        per = n // d
        lo = self.mesh.local_index("data") * per
        return slice(lo, lo + per)

    def take(self, array):
        """This rank's part of ``array`` (numpy or torch), a view."""
        if self.dim is None:
            return array
        index = (slice(None),) * self.dim + (self.rows(array.shape[self.dim]),)
        return array[index]


def data_sharding(mesh: Mesh) -> RowSharding:
    """Batch-axis sharding: dim 0 split over "data", rest replicated."""
    return RowSharding(mesh, 0)


def superbatch_sharding(mesh: Mesh) -> RowSharding:
    """Stacked (K, B, ...) superbatches: the steps dimension is whole, the
    batch dimension splits over "data" as in ``data_sharding``."""
    return RowSharding(mesh, 1)


def replicated_sharding(mesh: Mesh) -> RowSharding:
    return RowSharding(mesh, None)
