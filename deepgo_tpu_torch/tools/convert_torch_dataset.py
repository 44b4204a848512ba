"""Convert a reference-format transcribed dataset into deepgo_tpu shards.

For users migrating from the reference framework with an already-transcribed
corpus (one torch-serialized file per move under <root>/<split>/<game>/K,
reference makedata.lua:537-559) but without the source SGFs: decodes each
record with the port's ``t7reader`` and writes the shard format
(``data.dataset.DatasetWriter``) directly — no SGF replay involved. The
port's twin of ``tools/convert_torch_dataset.py``; host only.

Usage:
  python -m deepgo_tpu_torch.tools.convert_torch_dataset \
      --src /path/to/reference/data --out data/processed_from_torch \
      [--splits train,validation,test]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.dataset import META_COLS, DatasetWriter
from . import t7reader


def convert_game(game_dir: str):
    files = sorted(
        (f for f in os.listdir(game_dir) if f.isdigit()), key=int
    )
    packed, meta = [], []
    for f in files:
        rec = t7reader.load(os.path.join(game_dir, f))
        move, ranks = rec["move"], rec["ranks"]
        packed.append(rec["input"])
        meta.append((int(move["player"]), int(move["x"]) - 1, int(move["y"]) - 1,
                     int(ranks[1]), int(ranks[2]), 0))
    if not packed:
        return None
    return np.stack(packed), np.array(meta, dtype=np.int32).reshape(-1, META_COLS)


def convert_split(src: str, out_dir: str, verbose: bool = True) -> int:
    writer = DatasetWriter(out_dir)
    for root, dirs, _files in os.walk(src):
        for d in sorted(dirs):
            game_dir = os.path.join(root, d)
            if not os.path.isfile(os.path.join(game_dir, "1")):
                continue
            result = convert_game(game_dir)
            if result is not None:
                writer.add_game(os.path.relpath(game_dir, src), *result)
    total = writer.finalize()
    if verbose:
        print(f"{out_dir}: {total} examples")
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--splits", default="train,validation,test")
    args = ap.parse_args(argv)
    for split in args.splits.split(","):
        convert_split(os.path.join(args.src, split),
                      os.path.join(args.out, split))


if __name__ == "__main__":
    main()
