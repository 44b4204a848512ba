"""Measure 8-fold dihedral symmetry-averaged inference vs the plain net.

Ensembling the 8 board symmetries at eval time
(``models/serving.make_sym_policy_fn``, whose gather + expansion is the
sym kernel on the card) is likely the cheapest accuracy lever available:
this tool measures both sides of the trade on a full split — test top-1 /
NLL delta, and the boards/sec cost of the 8x forward. The port's twin of
``tools/symmetry_eval.py``; the net runs on ``--device`` (``cuda`` by
default).

Usage:
  python -m deepgo_tpu_torch.tools.symmetry_eval \
      --checkpoint runs/<id>/checkpoint.npz \
      [--data-root data/corpus/processed] [--split test] [--batch 512]
      [--limit N] [--out runs/torch_tools/symmetry_eval.jsonl] [--device cpu]

Prints one JSON line per mode; optionally appends them to --out.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..data.dataset import GoDataset
from ..models.serving import load_policy, make_policy_fn, make_sym_policy_fn


def evaluate(predict, params, ds, batch: int, limit: int,
             label: str = "") -> dict:
    """Fixed-order sweep of the split's first ``limit`` positions.

    One warm-up batch runs before the clock starts (first-use set-up would
    otherwise skew boards/sec — the exact cost this tool measures). Each
    timed batch ends in the forward's copy back to numpy, so boards/sec is
    a synchronised figure. Progress prints every minute keep a long
    full-split sweep observable."""
    n = min(limit, len(ds)) if limit else len(ds)

    def load(i):
        packed, player, rank, target = ds.batch_at(
            np.arange(i, min(i + batch, n)))
        size = len(target)
        if size < batch:  # pad to the batch's shape; score real rows only
            pad = batch - size
            packed = np.concatenate([packed, np.zeros(
                (pad, *packed.shape[1:]), packed.dtype)])
            player = np.concatenate([player, np.ones(pad, player.dtype)])
            rank = np.concatenate([rank, np.ones(pad, rank.dtype)])
        return packed, player, rank, target, size

    packed, player, rank, _, _ = load(0)
    np.asarray(predict(params, packed, player, rank))  # warm: set-up + run

    correct = nll = seen = 0.0
    t0 = last = time.time()
    for i in range(0, n, batch):
        packed, player, rank, target, size = load(i)
        logp = np.asarray(predict(params, packed, player, rank))[:size]
        correct += (logp.argmax(axis=1) == target).sum()
        nll += -logp[np.arange(size), target].sum()
        seen += size
        if time.time() - last > 60:
            last = time.time()
            print(f"# {label} {int(seen)}/{n} positions, "
                  f"{seen / (last - t0):.0f} boards/sec", flush=True)
    dt = time.time() - t0
    return {
        "n": int(seen),
        "top1": round(float(correct / seen), 5),
        "nll": round(float(nll / seen), 5),
        "seconds": round(dt, 2),
        "boards_per_sec": round(seen / dt, 1),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data-root", default="data/corpus/processed")
    ap.add_argument("--split", default="test")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--limit", type=int, default=0,
                    help="positions to evaluate (0 = whole split)")
    ap.add_argument("--out", help="JSONL file to append results to")
    ap.add_argument("--device", default="cuda",
                    help="device of both forwards (cuda or cpu)")
    args = ap.parse_args(argv)

    _, params, cfg = load_policy(args.checkpoint, device=args.device)
    ds = GoDataset(args.data_root, args.split)
    plain_fn = make_policy_fn(cfg, top_k=1, device=args.device)

    def plain(params, packed, player, rank):
        return plain_fn(params, packed, player, rank)["log_probs"]

    sym = make_sym_policy_fn(cfg, device=args.device)
    lines = []
    for mode, fn in (("plain", plain), ("sym8", sym)):
        r = dict(evaluate(fn, params, ds, args.batch, args.limit, label=mode),
                 mode=mode, checkpoint=args.checkpoint, split=args.split)
        lines.append(r)
        print(json.dumps(r), flush=True)
    delta = lines[1]["top1"] - lines[0]["top1"]
    print(json.dumps({"mode": "delta", "top1_delta": round(delta, 5),
                      "cost_ratio": round(lines[0]["boards_per_sec"]
                                          / max(lines[1]["boards_per_sec"],
                                                1e-9), 2)}), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in lines:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
