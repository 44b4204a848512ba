"""Build the per-position game-winner sidecar for outcome-conditioned
sampling (GoDataset scheme="winner") and value training.

The port's copy of ``tools/winner_index.py``, over the port's ``sgf``: the
same ``winner.npy`` bytes for the same shard and SGF directory.

Reads each game's SGF RE[] result (written by the corpus generator /
self-play exporter, e.g. "B+23.5", "W+4", "0") and writes
``<split>/winner.npy``: int8 (N,) = winner of the game containing each
position (1 black, 2 white, 0 unknown/draw/truncated). Training on only
the winner's moves biases imitation toward winning play — outcome
information the reference's on-disk format does not carry at all.

Usage:
  python -m deepgo_tpu_torch.data.winners \
      --processed data/corpus/processed/train --sgf data/corpus/sgf/train
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .. import sgf
from ..utils.atomicio import atomic_write


def winner_of(result: str) -> int:
    r = result.strip()
    if r.startswith("B+"):
        return 1
    if r.startswith("W+"):
        return 2
    return 0


def build(processed: str, sgf_dir: str) -> dict:
    with open(os.path.join(processed, "games.json")) as f:
        games = json.load(f)
    total = sum(g["count"] for g in games)
    winner = np.zeros(total, dtype=np.int8)
    stats = {"games": len(games), "decided": 0, "undecided": 0, "missing": 0}
    for g in games:
        path = os.path.join(sgf_dir, g["name"])
        if not os.path.exists(path):
            stats["missing"] += 1
            continue
        re_vals = sgf.parse_file(path).properties.get("RE", [])
        w = winner_of(re_vals[0]) if re_vals else 0
        if w:
            stats["decided"] += 1
            winner[g["start"]:g["start"] + g["count"]] = w
        else:
            stats["undecided"] += 1
    with atomic_write(os.path.join(processed, "winner.npy")) as f:
        np.save(f, winner)
    stats["winner_positions"] = int(
        (winner == np.load(os.path.join(processed, "meta.npy"))[:, 0]).sum())
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--processed", required=True)
    ap.add_argument("--sgf", required=True)
    args = ap.parse_args(argv)
    stats = build(args.processed, args.sgf)
    print(stats)


if __name__ == "__main__":
    main()
