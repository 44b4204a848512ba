"""Entry points of the port: one-card forward check + multi-rank dry run.

The port's counterpart of the repo's ``__graft_entry__.py``:

* ``entry(device="cuda")`` returns ``(fn, example_args)``: the flagship
  model's (``full``, 12 layers x 128 filters, bf16) forward from packed
  records to log-probs, through the expansion kernel on the card, with
  example arguments at B = 128 drawn as ``__graft_entry__._entry`` draws
  them (numpy ``default_rng(0)``). The weights are a He-normal init from
  ``torch.Generator`` seed 0.
* ``dryrun_multichip(n, device="cuda")`` runs one dp x tp training step
  (and five more on the same batch, whose loss must fall) over ``n`` ranks
  of a ``torch.distributed`` group at tiny shapes: NCCL ranks on ``n``
  cards, or gloo ranks on the CPU when the caller passes ``device="cpu"``. Each rank is a process of
  its own (``python -m deepgo_tpu_torch.graft_entry --rank R ...``).

Both run under the external-process watchdog (``utils/watchdog.py``),
which SIGKILLs a process still blocked after ``WATCHDOG_S`` seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import resolve_device
from .models import policy_cnn
from .ops import expand_planes
from .utils import watchdog

ENTRY_BATCH = 128
DRYRUN_CONFIG = policy_cnn.ModelConfig(num_layers=3, channels=16)
DRYRUN_STEPS = 5  # more steps on the dry run's batch; the loss must fall
DRYRUN_TIMEOUT_S = 300.0  # the ranks' own deadline, under the watchdog's
WATCHDOG_S = 600.0  # far above a healthy call, far below a driver's limit


@contextlib.contextmanager
def _watchdog(label: str):
    wd = watchdog.arm(label, WATCHDOG_S)
    try:
        yield
    finally:
        wd.disarm()


def entry(device="cuda"):
    """(fn, example_args) for the flagship model's forward on ``device``:
    ``fn(model, packed, player, rank)`` -> (128, 361) float32 log-probs."""
    with _watchdog("entry"):
        return make_entry(policy_cnn.CONFIGS["full"], device)


def make_entry(cfg: policy_cnn.ModelConfig, device="cuda",
               batch: int = ENTRY_BATCH):
    """``entry``'s forward and arguments for any model config (the tests
    run it in float32 too)."""
    device = resolve_device(device)
    model = policy_cnn.init(torch.Generator().manual_seed(0), cfg,
                            device=device)

    def forward(params, packed, player, rank):
        planes = expand_planes(packed, player, rank, dtype=cfg.torch_dtype)
        return policy_cnn.log_policy(params, planes)

    rng = np.random.default_rng(0)
    example_args = (
        model,
        torch.from_numpy(rng.integers(0, 3, size=(batch, 9, 19, 19),
                                      dtype=np.uint8)).to(device),
        torch.from_numpy(rng.integers(1, 3, size=batch,
                                      dtype=np.int32)).to(device),
        torch.from_numpy(rng.integers(1, 10, size=batch,
                                      dtype=np.int32)).to(device),
    )
    return forward, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> list[dict]:
    """One dp x tp training step over ``n_devices`` ranks (tp = 2 when
    ``n_devices`` is even and >= 4); returns each rank's record."""
    with _watchdog("dryrun_multichip"):
        return _dryrun_multichip(n_devices, device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_multichip(n: int, device) -> list[dict]:
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun over {n} cards, this host has "
                           f"{torch.cuda.device_count()}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.setdefault("OMP_NUM_THREADS", "2")
    with tempfile.TemporaryDirectory(prefix="graft-dryrun-") as tmp:
        store = (f"file://{os.path.join(tmp, 'store')}"
                 if device.type == "cpu"
                 else f"tcp://localhost:{_free_port()}")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "deepgo_tpu_torch.graft_entry",
             "--rank", str(r), "--ranks", str(n), "--store", store,
             "--device", device.type],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(n)]
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        outs = []
        try:
            for p in procs:
                left = max(1.0, deadline - time.monotonic())
                outs.append(p.communicate(timeout=left))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    records = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} exited {p.returncode}:\n"
                               f"{err[-3000:]}")
        line = [x for x in out.splitlines() if x.startswith("DRYRUN ")][-1]
        records.append(json.loads(line.split(" ", 1)[1]))
    r0 = records[0]
    print(f"dryrun_multichip: mesh data={r0['data']} model={r0['model']} "
          f"over {n} {device.type} ranks, one train step done, "
          f"loss={r0['losses'][0]:.4f}; {DRYRUN_STEPS} more steps "
          f"{[round(x, 4) for x in r0['losses'][1:]]} (decreasing)",
          flush=True)
    return records


def dryrun_batch(bs: int) -> dict:
    """The dry run's one global batch of ``bs`` boards (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    return {
        "packed": rng.integers(0, 3, size=(bs, 9, 19, 19), dtype=np.uint8),
        "player": rng.integers(1, 3, size=bs).astype(np.int32),
        "rank": rng.integers(1, 10, size=bs).astype(np.int32),
        "target": rng.integers(0, 361, size=bs).astype(np.int32),
    }


def _dryrun_rank(rank: int, n: int, store: str, device: str) -> dict:
    """One rank's work: join the group, place the tiny model under the
    dp x tp layout, and train on one fixed batch."""
    from .parallel import data_sharding, distributed, make_mesh, reshard
    from .training import make_train_step, sgd

    distributed.initialize(store, n, rank, device=device)
    try:
        here = distributed.local_device()
        tp = 2 if n % 2 == 0 and n >= 4 else 1
        dp = n // tp
        mesh = make_mesh(dp, tp)
        cfg = DRYRUN_CONFIG
        placement = reshard.Placement.for_model(cfg, mesh, tensor_parallel=tp,
                                                zero_opt=False)
        optimizer = sgd(0.01, rate_decay=1e-7)
        full = policy_cnn.init(torch.Generator().manual_seed(0), cfg,
                               device=here)
        model, _ = reshard.place_state(full, None, placement)
        state = optimizer.init(model)
        step = make_train_step(cfg, optimizer, mesh=mesh)
        host = dryrun_batch(2 * dp)
        rows = data_sharding(mesh)
        local = {k: torch.from_numpy(np.ascontiguousarray(rows.take(v))).to(
            here) for k, v in host.items()}
        losses = []
        for _ in range(1 + DRYRUN_STEPS):
            model, state, loss = step(model, state, local)
            losses.append(float(loss))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[1]:
            raise RuntimeError(f"dryrun rank {rank}: losses {losses}")
        return {"rank": rank, "data": dp, "model": tp,
                "device": str(here), "losses": losses}
    finally:
        distributed.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--store", required=True,
                    help="rendezvous: file:///path or tcp://host:port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    record = _dryrun_rank(args.rank, args.ranks, args.store, args.device)
    print("DRYRUN " + json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
