"""End-to-end streamed-training feed benchmark.

Measures the full streamed path — memmap sampling -> host batch -> (wire
encode) -> copy to the card -> K steps per call — under each combination
of the two feed levers:

  * wire_format:      "packed" (3.2 KB/position) vs "nibble" (1.7 KB)
  * device_prefetch:  0 (copy inline in the train loop) vs N (uploader
                      thread overlaps the copy with device compute)

plus a host-sampling-only rate (no device) to show where the host side
saturates. One JSON line per measurement. The port's twin of
``tools/feed_bench.py``: the same base config (``full``, B = 512, K = 20,
4 loader threads, prefetch 8), the port's ``Experiment`` on ``--device``
(``cuda`` by default).

Usage:
  python -m deepgo_tpu_torch.tools.feed_bench \
      --data-root data/corpus/processed --iters 600 \
      --set num_layers=12 channels=128 batch_size=512
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .. import resolve_device
from ..cli import parse_overrides
from ..data.dataset import GoDataset
from ..data.loader import make_host_batch, make_host_superbatch
from ..experiments import Experiment, ExperimentConfig
from ..utils.metrics import read_jsonl
from . import OUT_DIR


def host_sampling_rate(data_root: str, batch_size: int, wire: str,
                       seconds: float = 5.0) -> dict:
    """Pure host-side sampling rate (memmap gather + wire encode), no
    device."""
    ds = GoDataset(data_root, "train")
    rng = np.random.default_rng(0)
    make_host_batch(ds, rng, batch_size, "uniform", wire=wire)  # warm cache
    n = 0
    t0 = time.time()
    while time.time() - t0 < seconds:
        make_host_batch(ds, rng, batch_size, "uniform", wire=wire)
        n += batch_size
    return {"kind": "host_sampling", "wire": wire,
            "samples_per_sec": round(n / (time.time() - t0), 1)}


def host_superbatch_rate(data_root: str, batch_size: int, stack: int,
                         wire: str, seconds: float = 5.0) -> dict:
    """Host-side SUPERBATCH assembly rate — the unit the loader workers
    build (one K*B gather + one wire encode,
    ``data.loader.make_host_superbatch``)."""
    ds = GoDataset(data_root, "train")
    rng = np.random.default_rng(0)
    make_host_superbatch(ds, rng, batch_size, stack, "uniform", wire=wire)
    n = 0
    t0 = time.time()
    while time.time() - t0 < seconds:
        make_host_superbatch(ds, rng, batch_size, stack, "uniform", wire=wire)
        n += batch_size * stack
    return {"kind": "host_superbatch", "wire": wire, "stack": stack,
            "samples_per_sec": round(n / (time.time() - t0), 1)}


def streamed_training_rate(cfg: ExperimentConfig, iters: int,
                           device="cuda") -> dict:
    """Live streamed training samples/sec for one feed configuration.

    A fresh Experiment per setting (params at the same seed); the first
    print window carries the first call's set-up, so the rate averages
    the windows after it from the run's metrics.jsonl.
    """
    exp = Experiment(cfg, device=device)
    exp.run(iters)
    rows = [m for m in read_jsonl(os.path.join(exp.run_path, "metrics.jsonl"))
            if m["kind"] == "train"]
    if not rows:
        raise SystemExit(f"no train windows recorded: --iters must be >= "
                         f"print_interval ({cfg.print_interval})")
    # drop the first window (set-up) whenever a steady window remains
    steady = rows[1:] if len(rows) > 1 else rows
    sps = sum(m["samples_per_sec"] for m in steady) / len(steady)
    return {
        "kind": "streamed_training",
        "wire": cfg.wire_format,
        "device_prefetch": cfg.device_prefetch,
        "loader_threads": cfg.loader_threads,
        "steps_per_call": cfg.steps_per_call,
        "batch_size": cfg.batch_size,
        "samples_per_sec": round(sps, 1),
        "windows": len(steady),
        "run_id": exp.id,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-root", default="data/corpus/processed")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--out", default=os.path.join(OUT_DIR,
                                                  "feed_bench.jsonl"))
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    ap.add_argument("--device", default="cuda",
                    help="device of the streamed runs (cuda or cpu)")
    args = ap.parse_args(argv)

    resolve_device(args.device)  # no card: raise before any work
    base = ExperimentConfig(
        data_root=args.data_root, scheme="uniform", name="feed-bench",
        num_layers=12, channels=128, batch_size=512, steps_per_call=20,
        print_interval=100, validation_interval=10**9, loader_threads=4,
        prefetch=8,
    ).replace(**parse_overrides(args.set))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    def record(r: dict) -> None:
        # append as produced, so an interrupted sweep keeps earlier rows
        print(json.dumps(r), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(r) + "\n")

    for wire in ("packed", "nibble"):
        record(host_sampling_rate(args.data_root, base.batch_size, wire))
        record(host_superbatch_rate(args.data_root, base.batch_size,
                                    base.steps_per_call, wire))
    for wire, dev_prefetch in (("packed", 0), ("packed", 2),
                               ("nibble", 0), ("nibble", 2)):
        cfg = base.replace(wire_format=wire, device_prefetch=dev_prefetch)
        record(streamed_training_rate(cfg, args.iters, device=args.device))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
