"""Transcription pipeline: SGF game records -> memory-mapped training shards.

The port's copy of ``deepgo_tpu/data/transcribe.py``. It writes through
the port's ``data/dataset.DatasetWriter`` and replays with the port's ``go``
engine, native or Python; its shards are byte-equal to the JAX package's.

The reference's equivalent is transcribe_in_parallel (makedata.lua:517-533):
32 Lua threads each replaying a shard of the SGF file list and writing one
torch file per move. Here a multiprocessing pool replays games (the Go rules
engine releases no GIL, so processes, not threads) and the parent streams
results into one shard per split (``data/dataset.DatasetWriter``).

Games without qualifying dan ranks are skipped entirely, like the reference
(makedata.lua:550). Transcription is idempotent per split: an existing
planes.bin is not rebuilt unless --force is given (reference targets_for
idempotency check, makedata.lua:364-367).

Usage:
  python -m deepgo_tpu_torch.data.transcribe --src data/sgf --out data/processed \
      [--splits train,validation,test] [--workers N] [--force] [--engine auto]
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import sys
import time

import numpy as np

from .. import sgf
from .dataset import META_COLS, DatasetWriter


def transcribe_game(path: str, engine: str = "auto"):
    """Replay one SGF file -> (packed (M,9,19,19) uint8, meta (M,6) int32)
    or None if the game is skipped (no qualifying ranks / no moves).

    engine: "native" (C++ via ctypes, ~50x faster), "python", or "auto"
    (native when buildable, else python)."""
    from ..go import native, replay_positions

    game = sgf.parse_file(path)
    if game.ranks is None or not game.moves:
        return None
    use_native = engine == "native" or (engine == "auto" and native.available())
    if use_native:
        packed = native.transcribe_game_native(game.handicaps, game.moves)
    else:
        packed = np.stack([p for p, _ in replay_positions(game)])
    meta = np.array(
        [
            (m.player, m.x, m.y, game.ranks[0], game.ranks[1], 0)
            for m in game.moves
        ],
        dtype=np.int32,
    ).reshape(-1, META_COLS)
    return packed, meta


def _worker(args):
    path, engine = args
    try:
        result = transcribe_game(path, engine)
    except Exception as e:  # a corrupt SGF shouldn't kill the whole run
        return path, None, f"{type(e).__name__}: {e}"
    return path, result, None


def find_sgfs(src: str) -> list[str]:
    out = []
    for root, _, files in os.walk(src):
        for f in sorted(files):
            if f.endswith(".sgf"):
                out.append(os.path.join(root, f))
    return sorted(out)


def transcribe_split(src: str, out_dir: str, workers: int = 0,
                     force: bool = False, verbose: bool = True,
                     engine: str = "auto") -> int:
    """Transcribe every .sgf under ``src`` into one shard at ``out_dir``.
    Returns the number of examples written (or already present)."""
    done_marker = os.path.join(out_dir, "planes.bin")
    if os.path.exists(done_marker) and not force:
        meta = np.load(os.path.join(out_dir, "meta.npy"), mmap_mode="r")
        if verbose:
            print(f"{out_dir}: already transcribed ({meta.shape[0]} examples); "
                  f"use --force to rebuild")
        return int(meta.shape[0])

    paths = find_sgfs(src)
    writer = DatasetWriter(out_dir)
    start = time.time()

    if engine == "auto":
        from ..go import native

        engine = "native" if native.available() else "python"
    jobs = [(p, engine) for p in paths]
    workers = workers or max(1, (os.cpu_count() or 2) - 1)
    if workers > 1 and len(paths) > 1:
        with mp.Pool(workers) as pool:
            results = pool.imap(_worker, jobs)
            _consume(results, src, writer, verbose)
    else:
        _consume(map(_worker, jobs), src, writer, verbose)

    total = writer.finalize()
    if verbose:
        dt = time.time() - start
        print(f"{out_dir}: {total} examples from {len(paths)} games "
              f"in {dt:.1f}s ({total / max(dt, 1e-9):.0f} positions/sec)")
    return total


def _consume(results, src, writer, verbose):
    for path, result, err in results:
        name = os.path.relpath(path, src)
        if err is not None:
            print(f"SKIP {name}: {err}", file=sys.stderr)
        elif result is None:
            if verbose:
                print(f"skip {name}: no qualifying ranks or no moves")
        else:
            packed, meta = result
            writer.add_game(name, packed, meta)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", required=True, help="directory of .sgf files, or "
                    "a parent containing one subdirectory per split")
    ap.add_argument("--out", required=True)
    ap.add_argument("--splits", default="",
                    help="comma-separated split subdirectories (default: "
                    "treat --src as a single split)")
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "native", "python"])
    args = ap.parse_args()

    if args.splits:
        for split in args.splits.split(","):
            transcribe_split(os.path.join(args.src, split),
                             os.path.join(args.out, split),
                             workers=args.workers, force=args.force,
                             engine=args.engine)
    else:
        transcribe_split(args.src, args.out, workers=args.workers,
                         force=args.force, engine=args.engine)


if __name__ == "__main__":
    main()
