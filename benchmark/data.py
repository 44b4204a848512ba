"""Inputs made from the run's seed: packed records and training splits.

``records`` is the synthetic record generator of the port's bench
(``deepgo_tpu_torch/bench.py`` ``_rand_batch``), with a largest value per
packed channel taken from the traffic file, so that every one of the 37
planes fires. ``write_split`` is the synthetic split of ``chip_smoke.py``
phase 7 (``write_split``): games of seeded records whose targets favour a
few dozen points, written in the dataset's on-disk layout
(``planes.bin``, ``meta.npy``, ``games.json``) without the program's
writer.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import cost


def records(rng: np.random.Generator, n: int, channel_max) -> tuple:
    """(packed (n, 9, 19, 19) uint8, player (n,) int32 in {1, 2}, rank (n,)
    int32 in 1..9); channel c of a record lies in [0, channel_max[c]]."""
    hi = np.asarray(channel_max, dtype=np.int64).reshape(1, -1, 1, 1) + 1
    packed = rng.integers(0, hi, size=(n, cost.PACKED_CHANNELS, cost.BOARD,
                                       cost.BOARD), dtype=np.uint8)
    return (packed, rng.integers(1, 3, size=n).astype(np.int32),
            rng.integers(1, 10, size=n).astype(np.int32))


def write_split(root: str, rng: np.random.Generator, games: int,
                game_positions: int, target_points: int, channel_max) -> dict:
    """Write one split of ``games`` x ``game_positions`` records under
    ``root``; returns the raw arrays (``packed``, ``player``, ``rank``,
    ``target``) that the reference reads."""
    n = games * game_positions
    packed, player, rank = records(rng, n, channel_max)
    points = rng.permutation(cost.POINTS)[:target_points]
    weights = 1.0 / np.arange(1, target_points + 1)
    target = points[rng.choice(target_points, n, p=weights / weights.sum())]
    meta = np.stack([player, target // cost.BOARD, target % cost.BOARD,
                     rank, rank, np.repeat(np.arange(games), game_positions)],
                    axis=1).astype(np.int32)
    os.makedirs(root, exist_ok=True)
    packed.tofile(os.path.join(root, "planes.bin"))
    np.save(os.path.join(root, "meta.npy"), meta)
    with open(os.path.join(root, "games.json"), "w") as f:
        json.dump([{"name": f"g{g:05d}", "start": g * game_positions,
                    "count": game_positions} for g in range(games)], f)
    return {"packed": packed, "player": player, "rank": rank,
            "target": target.astype(np.int32)}
