"""Multi-process setup over ``torch.distributed``.

The port of ``deepgo_tpu/parallel/distributed.py``: the process-group
bootstrap, a hybrid mesh ordered hosts-major with a survivors filter, the
per-process batch arithmetic, and this rank's rows of a global batch.

A CUDA rank joins an NCCL group after ``torch.cuda.set_device(local_rank)``;
a CPU rank joins a gloo group. Nothing falls back: a CUDA rank whose NCCL
bootstrap fails raises, it never drops to gloo, the CPU or one device.
Single-process runs (no coordinator) stay the no-op they are in the JAX
package. ``deadlines.initialize_with_deadline`` wraps ``initialize`` in
bounded full-jitter retry and the external watchdog.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils import faults
from .liveness import ConfigError
from .mesh import Mesh, data_sharding, live_devices, make_mesh


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda") -> None:
    """Join (or skip, when single-process) the default process group.

    ``coordinator`` is the rendezvous: ``tcp://host:port``, ``host:port``
    or ``file:///shared/path``. A CUDA rank (``device="cuda"``) binds its
    local card, ``process_id`` modulo the cards this host sees, and joins
    over NCCL; ``device="cpu"`` joins over gloo. The
    ``dist_init`` fault site fires first, before the single-process
    short-circuit, so the chaos grammar reaches the bootstrap anywhere."""
    faults.check("dist_init")
    if coordinator is None and num_processes in (None, 1):
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ConfigError(
            f"a process group needs a coordinator, num_processes and "
            f"process_id; got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ConfigError(f"process_id {process_id} outside "
                          f"num_processes {num_processes}")
    device = resolve_device(device)
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Processes in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device() -> torch.device:
    """The device this rank drives: ``cuda:{current card}`` in an NCCL
    group, the CPU in a gloo group. Without a group, raises."""
    if not dist.is_initialized():
        raise ConfigError("no process group: the caller picks the device")
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def hybrid_mesh(n_model: int = 1, devices=None, processes=None) -> Mesh:
    """("data", "model") mesh over every device of every process, the
    data axis ordered hosts-major (by process index, then device id).

    ``processes`` restricts the mesh to a set of process indices: the
    re-mesh after a host loss. ``devices`` overrides discovery (objects
    with ``process_index`` and ``id``; the default is one device per rank
    of the default group)."""
    devices = list(devices if devices is not None else live_devices())
    if processes is not None:
        processes = set(processes)
        devices = [d for d in devices if d.process_index in processes]
        if not devices:
            raise ConfigError(
                f"re-mesh over processes {sorted(processes)} matches no "
                f"devices — every surviving host must own at least one")
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    if n_model < 1 or len(devices) % n_model != 0:
        raise ConfigError(
            f"hybrid mesh: {len(devices)} devices do not divide over "
            f"n_model={n_model}")
    n_data = len(devices) // n_model
    if devices == live_devices():
        return make_mesh(n_data, n_model)
    return make_mesh(n_data, n_model, devices=devices)


def per_host_batch(global_batch: int, process_count: int | None = None) -> int:
    """How many samples this process contributes per step.
    ``process_count`` defaults to the group's size; the elastic recovery
    passes the surviving count."""
    n = world_size() if process_count is None else process_count
    if n < 1:
        raise ConfigError(f"process_count must be >= 1, got {n}")
    if global_batch % n != 0:
        raise ConfigError(
            f"global batch {global_batch} does not divide over {n} "
            f"processes ({global_batch} % {n} = {global_batch % n}); pick a "
            f"global batch that is a multiple of the process count")
    return global_batch // n


def local_rows(mesh: Mesh, global_batch: dict) -> dict:
    """This rank's rows of a global (host) batch: the counterpart of the
    JAX package's ``global_array_from_local``, where each rank feeds only
    its own shard. The ``dist_collective`` fault site fires at this
    boundary and the time feeds ``deepgo_collective_seconds``."""
    from ..obs import get_registry

    faults.check("dist_collective")
    sharding = data_sharding(mesh)
    t0 = time.monotonic()
    out = {k: np.ascontiguousarray(sharding.take(np.asarray(v)))
           for k, v in global_batch.items()}
    get_registry().histogram(
        "deepgo_collective_seconds",
        "host-side cross-host array assembly").observe(
            time.monotonic() - t0)
    return out
