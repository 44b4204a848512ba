"""On-disk dataset format and random-access sampling.

The port's copy of ``deepgo_tpu/data/dataset.py`` (numpy only, no torch):
one memory-mapped shard per split,

  <root>/<split>/planes.bin   raw uint8, N x 9 x 19 x 19 packed records
  <root>/<split>/meta.npy     int32 (N, 6): player, x, y, black_rank,
                              white_rank, game_id
  <root>/<split>/games.json   ordered list of {name, start, count}

Sampling schemes:
  * ``game``     uniform game, then uniform move within it (the
    reference's data.lua:29-37).
  * ``uniform``  uniform over positions.
  * ``winner``   uniform over positions whose side to move went on to win;
    needs the ``winner.npy`` sidecar.

The port writes splits with ``DatasetWriter``; transcribing SGF files comes
with the game-playing stack.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .. import BOARD_SIZE
from ..features import PACKED_CHANNELS
from ..utils import faults
from ..utils.atomicio import atomic_write
from ..utils.retry import retry_with_backoff

RECORD_SHAPE = (PACKED_CHANNELS, BOARD_SIZE, BOARD_SIZE)
RECORD_BYTES = int(np.prod(RECORD_SHAPE))

# meta columns
M_PLAYER, M_X, M_Y, M_BLACK_RANK, M_WHITE_RANK, M_GAME = range(6)
META_COLS = 6


class GoDataset:
    """Random-access view over one transcribed split."""

    def __init__(self, root: str, split: str):
        self.dir = os.path.join(root, split)
        planes_path = os.path.join(self.dir, "planes.bin")
        if not os.path.exists(planes_path):
            raise FileNotFoundError(f"no transcribed data at {self.dir}")
        self.meta = np.load(os.path.join(self.dir, "meta.npy"))
        n = self.meta.shape[0]
        self.planes = np.memmap(planes_path, dtype=np.uint8, mode="r",
                                shape=(n, *RECORD_SHAPE))
        with open(os.path.join(self.dir, "games.json")) as f:
            games = json.load(f)
        self.game_names = [g["name"] for g in games]
        # (G, 2) start/count; games with zero moves are never written
        self.game_ranges = np.array([[g["start"], g["count"]] for g in games],
                                    dtype=np.int64)
        if not (self.game_ranges[:, 1] > 0).all():
            raise ValueError(f"{self.dir}/games.json lists an empty game")
        # optional per-position game-winner sidecar (1 black / 2 white /
        # 0 unknown or draw)
        wpath = os.path.join(self.dir, "winner.npy")
        self.winner = np.load(wpath) if os.path.exists(wpath) else None
        self._winner_positions: np.ndarray | None = None

    def __len__(self) -> int:
        return int(self.meta.shape[0])

    @property
    def num_games(self) -> int:
        return len(self.game_names)

    def sample_indices(self, rng: np.random.Generator, n: int,
                       scheme: str = "game") -> np.ndarray:
        if scheme == "uniform":
            return rng.integers(0, len(self), size=n)
        if scheme == "game":
            games = rng.integers(0, self.num_games, size=n)
            starts = self.game_ranges[games, 0]
            counts = self.game_ranges[games, 1]
            return starts + (rng.random(n) * counts).astype(np.int64)
        if scheme == "winner":
            cand = self.winner_positions()
            return cand[rng.integers(0, cand.size, size=n)]
        raise ValueError(f"unknown sampling scheme {scheme!r}")

    def winner_positions(self) -> np.ndarray:
        """Indices of positions whose side to move won the game (decided
        games only). Cached; requires the winner.npy sidecar."""
        if self._winner_positions is None:
            if self.winner is None:
                raise FileNotFoundError(
                    f"scheme='winner' needs {self.dir}/winner.npy")
            if self.winner.shape[0] != len(self):
                raise ValueError(f"{self.dir}/winner.npy has "
                                 f"{self.winner.shape[0]} rows for "
                                 f"{len(self)} positions")
            self._winner_positions = np.flatnonzero(
                self.winner == self.meta[:, M_PLAYER])
            if self._winner_positions.size == 0:
                raise ValueError("no decided-game positions in this split")
        return self._winner_positions

    def batch_at(self, indices: np.ndarray):
        """Gather (packed_planes, to_move_player, rank_of_player, target).

        The memmap gather is the ``loader_io`` fault point and runs under
        the bounded full-jitter retry: transient OSErrors are absorbed,
        persistent ones propagate after the attempts run out."""
        def gather():
            faults.check("loader_io")
            return self.planes[indices], self.meta[indices]

        # (B, 9, 19, 19) uint8 copy out of the memmap
        packed, meta = retry_with_backoff(gather, attempts=5, base_delay=0.05,
                                          jitter=True)
        player = meta[:, M_PLAYER]
        rank = np.where(player == 1, meta[:, M_BLACK_RANK],
                        meta[:, M_WHITE_RANK])
        target = meta[:, M_X] * BOARD_SIZE + meta[:, M_Y]
        return (packed, player.astype(np.int32), rank.astype(np.int32),
                target.astype(np.int32))

    def sample_batch(self, rng: np.random.Generator, n: int,
                     scheme: str = "game"):
        return self.batch_at(self.sample_indices(rng, n, scheme))

    def first_n(self, n: int):
        """Deterministic prefix batch."""
        return self.batch_at(np.arange(min(n, len(self))))

    def even_indices(self, n: int) -> np.ndarray:
        """Deterministic sample of n positions spread evenly across games.

        Waterfill: every game contributes equally until its moves run out,
        so the sample covers min(num_games, n) games; within a game the
        quota is evenly spaced over the move sequence."""
        n = min(n, len(self))
        counts = self.game_ranges[:, 1]
        quota = np.zeros_like(counts)
        remaining = n
        while remaining > 0:
            active = np.flatnonzero(quota < counts)
            share = remaining // len(active)
            if share == 0:
                quota[active[:remaining]] += 1
                break
            add = np.minimum(counts[active] - quota[active], share)
            quota[active] += add
            remaining -= int(add.sum())
        out = []
        for g in np.flatnonzero(quota):
            pos = np.round(
                np.linspace(0, counts[g] - 1, quota[g])
            ).astype(np.int64)
            out.append(self.game_ranges[g, 0] + pos)
        return np.concatenate(out) if out else np.zeros(0, np.int64)

    def even_n(self, n: int):
        """Deterministic, game-balanced batch (fixed validation sets)."""
        return self.batch_at(self.even_indices(n))


class DatasetWriter:
    """Streaming writer for one split: append games, then finalize."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        # streamed .tmp + fsync + os.replace in finalize() is the atomic
        # pattern for a file larger than one buffer
        self._planes_f = open(os.path.join(out_dir, "planes.bin.tmp"), "wb")
        self._meta: list[np.ndarray] = []
        self._games: list[dict] = []
        self._count = 0

    def add_game(self, name: str, packed: np.ndarray, meta: np.ndarray
                 ) -> None:
        """packed: (M, 9, 19, 19) uint8; meta: (M, 6) int32 with the
        game_id column ignored (rewritten to this game's index)."""
        m = packed.shape[0]
        if m == 0:
            return
        if packed.dtype != np.uint8 or packed.shape[1:] != RECORD_SHAPE:
            raise ValueError(f"packed must be (M, *{RECORD_SHAPE}) uint8, "
                             f"got {packed.dtype} {packed.shape}")
        meta = meta.astype(np.int32, copy=True)
        meta[:, M_GAME] = len(self._games)
        self._planes_f.write(packed.tobytes())
        self._meta.append(meta)
        self._games.append({"name": name, "start": self._count, "count": m})
        self._count += m

    def finalize(self) -> int:
        # durable before visible: a crash mid-write never leaves a
        # partially flushed planes.bin under the final name
        self._planes_f.flush()
        os.fsync(self._planes_f.fileno())
        self._planes_f.close()
        os.replace(os.path.join(self.out_dir, "planes.bin.tmp"),
                   os.path.join(self.out_dir, "planes.bin"))
        meta = (np.concatenate(self._meta) if self._meta
                else np.zeros((0, META_COLS), dtype=np.int32))
        with atomic_write(os.path.join(self.out_dir, "meta.npy")) as f:
            np.save(f, meta)
        # games.json is the shard's commit point: readers treat its
        # appearance as "this shard is complete"
        with atomic_write(os.path.join(self.out_dir, "games.json"),
                          mode="w") as f:
            json.dump(self._games, f)
        # a winner.npy sidecar describes the old shard
        stale = os.path.join(self.out_dir, "winner.npy")
        if os.path.exists(stale):
            os.remove(stale)
        return self._count
