"""Bounded on-disk replay buffer: games in while training reads, bit-exactly.

The port's copy of ``deepgo_tpu/loop/replay.py``. The directory is a file
format shared with the JAX package: the same ingest sequence writes
byte-identical game, segment and index files in both, and a buffer written
by either opens in the other.

The expert-iteration learner trains *while* selfplay actors append new
games, which breaks the static-corpus assumption every earlier data path
leaned on: ``GoDataset`` memmaps one immutable shard, and the step-indexed
loader's bit-exact-resume guarantee (``data.loader.step_rng``,
docs/robustness.md) only holds when step t samples from the same byte
range on every replay. This module restores both properties over a
*growing* corpus:

  append      ``ingest_game`` writes each finished game as its own
              fsync'd file (utils.atomicio) before acknowledging — an
              acked game survives any kill, which is what the chaos
              soak's "zero lost games" assertion actually checks.
  seal        open games compact into immutable *segments* (planes.bin /
              meta.npy / winner.npy, the GoDataset layout) in gid order;
              ``index.json`` is replaced atomically and its ``version``
              bumps once per seal — the window-versioned index the
              learner pins its read cursor against.
  extent      positions get a *logical index* that never changes once
              assigned (segment files record their [lo, hi) range).
              A ``ReplayView`` over a frozen extent is an immutable
              dataset: the learner freezes one per training window,
              records it in its checkpointed cursor, and a resumed run
              re-opens the identical byte range no matter how much the
              corpus grew in between — that is the whole bit-exact-resume
              story for a live buffer.
  bounded     ``evict(protect_lo)`` drops whole oldest segments once the
              sealed span exceeds ``capacity_positions``, but never past
              the learner's protected cursor — an extent a checkpoint
              still references cannot be deleted out from under a resume.

Crash recovery is a pure function of the directory: segment dirs not in
``index.json`` are half-built seals and are removed; open-game files at
or below the sealed gid watermark are duplicates of sealed data and are
removed; everything else is replayed into the in-memory state. Fault
site ``loop_ingest`` fires inside ``ingest_game`` (transients are
retried with the loader's backoff policy, hard faults surface to the
actor's supervisor — docs/robustness.md "Loop failure domains").
"""

from __future__ import annotations

import io
import json
import os
import shutil

import numpy as np

from ..analysis.lockcheck import make_rlock
from .. import BOARD_SIZE
from ..data.dataset import (M_BLACK_RANK, M_PLAYER, M_WHITE_RANK, M_X, M_Y,
                            META_COLS, RECORD_SHAPE)
from ..utils import faults
from ..utils.atomicio import atomic_write, atomic_write_bytes
from ..utils.retry import retry_with_backoff

INDEX_NAME = "index.json"
GAMES_DIR = "games"


class ReplayError(RuntimeError):
    """A replay-buffer invariant was violated (evicted extent, corrupt
    segment, meta/planes disagreement). Carries enough context to decide
    between 'operator bug' and 'disk corruption'."""


def _segment_name(seg_id: int) -> str:
    return f"seg-{seg_id:06d}"


def _game_name(gid: int) -> str:
    return f"g-{gid:08d}.npz"


class _Segment:
    """One sealed, immutable slice of the logical position space."""

    __slots__ = ("name", "dir", "lo", "hi", "first_gid", "last_gid",
                 "games", "_planes", "_meta", "_winner")

    def __init__(self, buffer_dir: str, entry: dict):
        self.name = entry["name"]
        self.dir = os.path.join(buffer_dir, self.name)
        self.lo = int(entry["lo"])
        self.hi = int(entry["hi"])
        self.first_gid = int(entry["first_gid"])
        self.last_gid = int(entry["last_gid"])
        self.games = entry["games"]  # [[gid, logical_start, count], ...]
        self._planes = None
        self._meta = None
        self._winner = None

    @property
    def positions(self) -> int:
        return self.hi - self.lo

    def _load(self) -> None:
        if self._planes is not None:
            return
        n = self.positions
        planes_path = os.path.join(self.dir, "planes.bin")
        try:
            self._planes = np.memmap(planes_path, dtype=np.uint8, mode="r",
                                     shape=(n, *RECORD_SHAPE))
            self._meta = np.load(os.path.join(self.dir, "meta.npy"))
            self._winner = np.load(os.path.join(self.dir, "winner.npy"))
        except (OSError, ValueError) as e:
            raise ReplayError(
                f"segment {self.dir} unreadable ({e}) — sealed segments "
                "are immutable, so this is disk damage, not a race") from e
        if self._meta.shape[0] != n or self._winner.shape[0] != n:
            raise ReplayError(
                f"segment {self.dir}: meta/winner rows "
                f"({self._meta.shape[0]}/{self._winner.shape[0]}) disagree "
                f"with the indexed position count {n}")

    def gather(self, local: np.ndarray):
        self._load()
        return self._planes[local], self._meta[local], self._winner[local]

    def entry(self) -> dict:
        return {"name": self.name, "lo": self.lo, "hi": self.hi,
                "first_gid": self.first_gid, "last_gid": self.last_gid,
                "games": self.games}


class ReplayView:
    """An immutable dataset over one frozen extent [lo, hi).

    Duck-types the slice of ``GoDataset`` the step-indexed loader uses
    (``sample_indices`` / ``batch_at`` / ``__len__`` / game ranges), so
    ``data.loader.make_step_batch`` — and with it the whole bit-exact
    deterministic stream — runs over the buffer unchanged. Indices are
    LOGICAL (stable across corpus growth and eviction), which is what a
    checkpointed cursor needs; sampling maps them into [lo, hi).
    """

    def __init__(self, segments: list[_Segment], lo: int, hi: int):
        if not segments:
            raise ReplayError(f"empty extent [{lo}, {hi}) — nothing sealed")
        self.lo = lo
        self.hi = hi
        self._segments = segments
        self._seg_los = np.array([s.lo for s in segments], dtype=np.int64)
        ranges = []
        for s in segments:
            for _, start, count in s.games:
                if start >= lo and start + count <= hi:
                    ranges.append((start, count))
        self.game_ranges = (np.array(ranges, dtype=np.int64)
                            if ranges else np.zeros((0, 2), np.int64))
        self._winner_positions: np.ndarray | None = None

    def __len__(self) -> int:
        return self.hi - self.lo

    @property
    def num_games(self) -> int:
        return len(self.game_ranges)

    def sample_indices(self, rng: np.random.Generator, n: int,
                       scheme: str = "game") -> np.ndarray:
        if scheme == "uniform":
            return self.lo + rng.integers(0, len(self), size=n)
        if scheme == "game":
            if self.num_games == 0:
                raise ReplayError(
                    f"extent [{self.lo}, {self.hi}) holds no whole game")
            games = rng.integers(0, self.num_games, size=n)
            starts = self.game_ranges[games, 0]
            counts = self.game_ranges[games, 1]
            return starts + (rng.random(n) * counts).astype(np.int64)
        if scheme == "winner":
            cand = self.winner_positions()
            return cand[rng.integers(0, cand.size, size=n)]
        raise ValueError(f"unknown sampling scheme {scheme!r}")

    def winner_positions(self) -> np.ndarray:
        """Logical indices whose side to move went on to win (decided
        games only) — the outcome-conditioned slice expert iteration
        distills from (tools/r3_lib.sh's scheme=winner, buffer-native)."""
        if self._winner_positions is None:
            out = []
            for s in self._segments:
                s._load()
                local = np.flatnonzero(
                    (s._winner == s._meta[:, M_PLAYER]) & (s._winner != 0))
                logical = local + s.lo
                out.append(logical[(logical >= self.lo)
                                   & (logical < self.hi)])
            cand = (np.concatenate(out) if out
                    else np.zeros(0, np.int64))
            if cand.size == 0:
                raise ReplayError(
                    f"scheme='winner': no decided-game positions in "
                    f"extent [{self.lo}, {self.hi})")
            self._winner_positions = cand
        return self._winner_positions

    def batch_at(self, indices: np.ndarray):
        """Gather (packed, player, rank, target), GoDataset.batch_at's
        contract over logical indices. Runs under the same loader_io
        fault site + bounded-jitter retry as the static-corpus gather."""
        indices = np.asarray(indices, dtype=np.int64)
        if indices.size and (indices.min() < self.lo
                             or indices.max() >= self.hi):
            raise ReplayError(
                f"index outside frozen extent [{self.lo}, {self.hi}): "
                f"min={indices.min()} max={indices.max()}")

        def gather():
            faults.check("loader_io")
            packed = np.empty((indices.size, *RECORD_SHAPE), np.uint8)
            meta = np.empty((indices.size, META_COLS), np.int32)
            seg_of = np.searchsorted(self._seg_los, indices, side="right") - 1
            for si in np.unique(seg_of):
                seg = self._segments[si]
                sel = np.flatnonzero(seg_of == si)
                p, m, _ = seg.gather(indices[sel] - seg.lo)
                packed[sel] = p
                meta[sel] = m
            return packed, meta

        packed, meta = retry_with_backoff(gather, attempts=5,
                                          base_delay=0.05, jitter=True)
        player = meta[:, M_PLAYER]
        rank = np.where(player == 1, meta[:, M_BLACK_RANK],
                        meta[:, M_WHITE_RANK])
        target = meta[:, M_X] * BOARD_SIZE + meta[:, M_Y]
        return (packed, player.astype(np.int32), rank.astype(np.int32),
                target.astype(np.int32))


class ReplayBuffer:
    """The writable front: durable per-game ingest, sealing, eviction.

    Thread-safe — every actor ingests concurrently and the learner
    freezes extents from another thread; sealed segments are immutable so
    views never need the lock.
    """

    def __init__(self, buffer_dir: str, segment_games: int = 64,
                 capacity_positions: int = 0, metrics=None):
        if segment_games < 1:
            raise ValueError(f"segment_games must be >= 1, got {segment_games}")
        self.dir = buffer_dir
        self.segment_games = segment_games
        self.capacity_positions = capacity_positions
        self._metrics = metrics
        # reentrant: the seal path re-enters through ingest bookkeeping
        self._lock = make_rlock("loop.replay")
        os.makedirs(os.path.join(buffer_dir, GAMES_DIR), exist_ok=True)
        self._recover()

    # -- recovery ----------------------------------------------------------

    def _index_path(self) -> str:
        return os.path.join(self.dir, INDEX_NAME)

    def _recover(self) -> None:
        """Rebuild in-memory state from the directory. index.json is the
        single source of truth for sealed data; anything else on disk is
        either an open game (kept) or debris from a torn seal (removed)."""
        try:
            with open(self._index_path()) as f:
                idx = json.load(f)
        except FileNotFoundError:
            idx = {"version": 0, "next_seg": 0, "base_lo": 0,
                   "sealed_hi": 0, "segments": []}
        except (OSError, ValueError) as e:
            raise ReplayError(
                f"{self._index_path()} unreadable ({e}) — the index is "
                "written atomically, so this is disk damage") from e
        self.version = int(idx["version"])
        self._next_seg = int(idx["next_seg"])
        self.base_lo = int(idx["base_lo"])
        self.sealed_hi = int(idx["sealed_hi"])
        self._segments = [_Segment(self.dir, e) for e in idx["segments"]]
        indexed = {s.name for s in self._segments}
        watermark = max((s.last_gid for s in self._segments), default=-1)
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("seg-") and name not in indexed:
                # a seal that died before the index flip: its games are
                # still in games/ (deleted only after the flip), so the
                # half-built directory is pure debris
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
        self._open: list[tuple[int, str]] = []  # (gid, path), gid order
        gdir = os.path.join(self.dir, GAMES_DIR)
        for name in sorted(os.listdir(gdir)):
            if not name.startswith("g-") or not name.endswith(".npz"):
                continue
            gid = int(name[2:-4])
            path = os.path.join(gdir, name)
            if gid <= watermark:
                # sealed before the crash; the file is a duplicate
                os.remove(path)
            else:
                self._open.append((gid, path))
        self._next_gid = max(watermark,
                             max((g for g, _ in self._open), default=-1)) + 1

    # -- ingest ------------------------------------------------------------

    def ingest_game(self, packed: np.ndarray, meta: np.ndarray,
                    winner: int = 0, source: str = "") -> int:
        """Durably append one finished game; returns its gid once — and
        only once — the bytes are fsync'd under their final name. ``meta``
        is the (M, 6) transcription layout (game_id column rewritten);
        ``winner`` is 1 (black) / 2 (white) / 0 (undecided), feeding the
        scheme='winner' slice. Auto-seals a full segment."""
        m = int(packed.shape[0])
        if m == 0:
            raise ValueError("refusing to ingest a zero-move game")
        if packed.dtype != np.uint8 or packed.shape[1:] != RECORD_SHAPE:
            raise ValueError(
                f"packed must be (M, {RECORD_SHAPE}) uint8, got "
                f"{packed.dtype} {packed.shape}")
        if meta.shape != (m, META_COLS):
            raise ValueError(f"meta must be ({m}, {META_COLS}), got {meta.shape}")

        def write() -> int:
            faults.check("loop_ingest")
            with self._lock:
                gid = self._next_gid
                path = os.path.join(self.dir, GAMES_DIR, _game_name(gid))
                buf = io.BytesIO()
                np.savez(buf, packed=packed,
                         meta=meta.astype(np.int32),
                         winner=np.int32(winner))
                atomic_write_bytes(path, buf.getvalue())
                self._next_gid = gid + 1
                self._open.append((gid, path))
            return gid

        # transient injected (or real) I/O faults are absorbed exactly
        # like the loader's memmap gather; hard faults reach the actor's
        # supervisor with the game UN-acked (never half-ingested)
        gid = retry_with_backoff(write, attempts=5, base_delay=0.05,
                                 jitter=True)
        if self._metrics is not None:
            self._metrics.write("loop_ingest", gid=gid, positions=m,
                                winner=winner, source=source)
        with self._lock:
            if len(self._open) >= self.segment_games:
                self.seal()
        return gid

    # -- sealing -----------------------------------------------------------

    def seal(self) -> int | None:
        """Compact every open game into one immutable segment and bump the
        index version. Returns the new version, or None when nothing was
        open. Crash-safe: the index flip is the commit point — the segment
        files land first (atomic each), game files are deleted only after
        the flip, and recovery resolves every intermediate state."""
        with self._lock:
            if not self._open:
                return None
            open_games = list(self._open)
            seg_id = self._next_seg
            name = _segment_name(seg_id)
            seg_dir = os.path.join(self.dir, name)
            os.makedirs(seg_dir, exist_ok=True)
            planes_parts, meta_parts, winner_parts, games = [], [], [], []
            cursor = self.sealed_hi
            for gid, path in open_games:
                try:
                    with np.load(path) as z:
                        packed = z["packed"]
                        meta = z["meta"]
                        winner = int(z["winner"])
                except (OSError, ValueError, KeyError) as e:
                    raise ReplayError(
                        f"open game {path} unreadable ({e}) — ingest is "
                        "atomic, so this is disk damage") from e
                m = packed.shape[0]
                meta = meta.copy()
                meta[:, -1] = gid  # game-id column: the buffer-wide gid
                planes_parts.append(packed)
                meta_parts.append(meta)
                winner_parts.append(np.full(m, winner, np.int32))
                games.append([gid, cursor, m])
                cursor += m
            with atomic_write(os.path.join(seg_dir, "planes.bin")) as f:
                f.write(np.concatenate(planes_parts).tobytes())
            with atomic_write(os.path.join(seg_dir, "meta.npy")) as f:
                np.save(f, np.concatenate(meta_parts))
            with atomic_write(os.path.join(seg_dir, "winner.npy")) as f:
                np.save(f, np.concatenate(winner_parts))
            seg = _Segment(self.dir, {
                "name": name, "lo": self.sealed_hi, "hi": cursor,
                "first_gid": open_games[0][0],
                "last_gid": open_games[-1][0], "games": games,
            })
            self._segments.append(seg)
            self.sealed_hi = cursor
            self._next_seg = seg_id + 1
            self.version += 1
            self._write_index()  # THE commit point
            for _, path in open_games:
                try:
                    os.remove(path)
                except OSError:
                    pass  # recovery drops it via the gid watermark
            self._open = []
            if self._metrics is not None:
                self._metrics.write("loop_seal", segment=name,
                                    version=self.version,
                                    games=len(games),
                                    positions=seg.positions,
                                    sealed_hi=self.sealed_hi)
                # the lineage chain's game->segment join: which gids own
                # which logical position range, so a window's frozen
                # extent resolves back to the games inside it
                self._metrics.write("lineage_segment", segment=name,
                                    version=self.version,
                                    lo=seg.lo, hi=seg.hi,
                                    first_gid=seg.first_gid,
                                    last_gid=seg.last_gid,
                                    games=len(games))
            return self.version

    def _write_index(self) -> None:
        idx = {"version": self.version, "next_seg": self._next_seg,
               "base_lo": self.base_lo, "sealed_hi": self.sealed_hi,
               "segments": [s.entry() for s in self._segments]}
        atomic_write_bytes(self._index_path(),
                           json.dumps(idx).encode())

    # -- reading -----------------------------------------------------------

    def extent(self) -> tuple[int, int, int]:
        """(lo, hi, version) of the currently sealed span — what a
        learner freezes at a window start and records in its cursor."""
        with self._lock:
            return self.base_lo, self.sealed_hi, self.version

    def view(self, lo: int, hi: int) -> ReplayView:
        """An immutable dataset over [lo, hi). Raises ReplayError if the
        extent reaches below the eviction floor (a protect_lo bug) or
        above the sealed span (a cursor from the future)."""
        with self._lock:
            if lo < self.base_lo:
                raise ReplayError(
                    f"extent lo {lo} below eviction floor {self.base_lo} — "
                    "evict() ran past a live cursor")
            if hi > self.sealed_hi:
                raise ReplayError(
                    f"extent hi {hi} beyond sealed span {self.sealed_hi}")
            segs = [s for s in self._segments if s.hi > lo and s.lo < hi]
        return ReplayView(segs, lo, hi)

    # -- retention ---------------------------------------------------------

    def evict(self, protect_lo: int | None = None) -> int:
        """Drop whole oldest segments while the sealed span exceeds
        ``capacity_positions``, never crossing ``protect_lo`` (the oldest
        logical index a live cursor/checkpoint still references).
        Returns the number of segments dropped."""
        if self.capacity_positions <= 0:
            return 0
        dropped = 0
        with self._lock:
            while (len(self._segments) > 1
                   and self.sealed_hi - self.base_lo
                   > self.capacity_positions):
                victim = self._segments[0]
                if protect_lo is not None and victim.hi > protect_lo:
                    break
                self._segments.pop(0)
                self.base_lo = victim.hi
                self._write_index()
                shutil.rmtree(victim.dir, ignore_errors=True)
                dropped += 1
                if self._metrics is not None:
                    self._metrics.write("loop_evict", segment=victim.name,
                                        base_lo=self.base_lo)
        return dropped

    # -- accounting --------------------------------------------------------

    @property
    def total_games(self) -> int:
        with self._lock:
            return (sum(len(s.games) for s in self._segments)
                    + len(self._open))

    @property
    def open_positions(self) -> int:
        with self._lock:
            total = 0
            for _, path in self._open:
                with np.load(path) as z:
                    total += int(z["meta"].shape[0])
            return total

    def stats(self) -> dict:
        with self._lock:
            return {
                "version": self.version,
                "segments": len(self._segments),
                "sealed_positions": self.sealed_hi - self.base_lo,
                "sealed_hi": self.sealed_hi,
                "base_lo": self.base_lo,
                "open_games": len(self._open),
                "total_games": self.total_games,
            }


def count_durable_games(buffer_dir: str) -> int:
    """Games durably on disk, counted WITHOUT constructing a buffer (no
    recovery side effects — safe next to a live writer). Sealed games
    come from index.json; open games are the g-*.npz files above the
    sealed gid watermark. This fresh read is the zero-lost-games witness
    the chaos soak compares against the actors' acked counter."""
    try:
        with open(os.path.join(buffer_dir, INDEX_NAME)) as f:
            idx = json.load(f)
    except (FileNotFoundError, ValueError, OSError):
        idx = {"segments": []}
    sealed = sum(len(e["games"]) for e in idx["segments"])
    watermark = max((int(e["last_gid"]) for e in idx["segments"]),
                    default=-1)
    open_games = 0
    gdir = os.path.join(buffer_dir, GAMES_DIR)
    try:
        names = os.listdir(gdir)
    except FileNotFoundError:
        names = []
    for name in names:
        if name.startswith("g-") and name.endswith(".npz") \
                and int(name[2:-4]) > watermark:
            open_games += 1
    return sealed + open_games
