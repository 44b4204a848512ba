"""Dataset splitter: shuffle a directory of SGF games into split directories.

The port's copy of ``deepgo_tpu/data/split.py``.

Equivalent of the reference's scatter_to_categories (makedata.lua:580-598):
files are shuffled once and dealt into the requested splits by count,
preserving relative subpaths. Operates on the raw SGF corpus (our pipeline
splits *before* transcription; the reference split after).

Usage:
  python -m deepgo_tpu_torch.data.split --src raw_sgf --out data/sgf \
      --sizes train=180000,validation=2000,test=2000 [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import random
import shutil

from .transcribe import find_sgfs


def scatter(src: str, out: str, sizes: dict[str, int], seed: int = 0) -> dict[str, int]:
    files = find_sgfs(src)
    rng = random.Random(seed)
    rng.shuffle(files)
    placed: dict[str, int] = {}
    i = 0
    for split, size in sizes.items():
        taken = files[i:i + size]
        i += size
        for path in taken:
            rel = os.path.relpath(path, src)
            dst = os.path.join(out, split, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(path, dst)
        placed[split] = len(taken)
        if len(taken) < size:
            break  # corpus exhausted (reference returns early too)
    return placed


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--sizes", required=True,
                    help="comma-separated split=count, dealt in order")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sizes = {}
    for part in args.sizes.split(","):
        split, count = part.split("=")
        sizes[split] = int(count)
    placed = scatter(args.src, args.out, sizes, seed=args.seed)
    for split, n in placed.items():
        print(f"{split}: {n} games")


if __name__ == "__main__":
    main()
