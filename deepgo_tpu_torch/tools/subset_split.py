"""Carve a positions-budgeted subset out of a transcribed split.

Game-aligned prefix copy: whole games are taken in order until the position
budget is reached, so the subset is itself a valid split (planes.bin prefix
+ rewritten meta/games.json). Used to build the accuracy-vs-corpus-size
curve (``deepgo_tpu_torch.tools.accuracy_curve``). Host only.

Usage:
  python -m deepgo_tpu_torch.tools.subset_split \
      --src data/corpus/processed/train \
      --out data/corpus/processed/train_40k --positions 40000
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.dataset import RECORD_BYTES
from ..utils.atomicio import atomic_write


def subset_prefix_copy(src: str, out: str, positions: int) -> int:
    """Copy only the needed prefix of planes.bin (no full-file copy)."""
    with open(os.path.join(src, "games.json")) as f:
        games = json.load(f)
    keep = []
    total = 0
    for g in games:
        if total >= positions:
            break
        keep.append(g)
        total += g["count"]
    if not keep:
        raise ValueError(f"empty subset of {src} at {positions} positions")

    os.makedirs(out, exist_ok=True)
    meta = np.load(os.path.join(src, "meta.npy"))
    with atomic_write(os.path.join(out, "meta.npy")) as f:
        np.save(f, meta[:total])
    with atomic_write(os.path.join(out, "games.json"), "w") as f:
        json.dump(keep, f)
    remaining = total * RECORD_BYTES
    with open(os.path.join(src, "planes.bin"), "rb") as fin, \
            atomic_write(os.path.join(out, "planes.bin")) as fout:
        while remaining > 0:
            chunk = fin.read(min(64 << 20, remaining))
            if not chunk:
                raise ValueError(f"{src}/planes.bin is shorter than its "
                                 "meta implies")
            fout.write(chunk)
            remaining -= len(chunk)
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--positions", type=int, required=True)
    args = ap.parse_args(argv)
    n = subset_prefix_copy(args.src, args.out, args.positions)
    print(f"{args.out}: {n:,} positions")


if __name__ == "__main__":
    main()
