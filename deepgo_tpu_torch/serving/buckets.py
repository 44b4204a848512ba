"""Shape buckets: pad any request count onto a fixed ladder of batch sizes.

The port's own copy of ``deepgo_tpu/serving/buckets.py``. Under JAX every
distinct batch shape compiles a program, so the ladder keeps the compiled
shapes to five. Under PyTorch nothing compiles, but the ladder still bounds
the shapes cuDNN chooses algorithms for, and it is what makes padding
exact: each board's forward is row-independent, so within one rung a
board's row is bitwise the same whatever the other rows hold. Across rungs
cuDNN may pick another algorithm per batch size, so rows agree there only
within a tolerance (see ``serving/engine.py``).
"""

from __future__ import annotations

import numpy as np

# ~4x rung spacing keeps warmup to five shapes while capping pad waste at
# 4x on the smallest requests.
DEFAULT_BUCKETS = (1, 8, 32, 128, 512)

# Padding rows: an empty board scored for player 1 at rank 1, the JAX
# package's filler.
PAD_PLAYER = 1
PAD_RANK = 1


class BucketLadder:
    """An ascending ladder of batch sizes plus the pad/plan arithmetic."""

    def __init__(self, buckets=DEFAULT_BUCKETS):
        rungs = tuple(sorted({int(b) for b in buckets}))
        if not rungs or rungs[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self.buckets = rungs

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest rung >= n. Raises for n over the top rung — callers
        split oversize batches with plan() instead of padding down."""
        if n < 1:
            raise ValueError(f"need at least one request, got {n}")
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"{n} exceeds the largest bucket {self.max_bucket}")

    def plan(self, n: int) -> list[tuple[int, int, int]]:
        """Cover n rows with ladder-shaped dispatches:
        ``[(start, count, bucket), ...]``. Full top-rung chunks first (no
        padding), then one padded dispatch for the remainder."""
        out, start = [], 0
        while n - start >= self.max_bucket:
            out.append((start, self.max_bucket, self.max_bucket))
            start += self.max_bucket
        rest = n - start
        if rest:
            out.append((start, rest, self.bucket_for(rest)))
        return out

    def pad(self, packed: np.ndarray, players: np.ndarray, ranks: np.ndarray,
            bucket: int):
        """(packed, players, ranks) padded with empty-board filler rows up
        to ``bucket``; no copy when the count already sits on a rung."""
        n = len(packed)
        if bucket == n:
            return packed, players, ranks
        pad = bucket - n
        return (
            np.concatenate(
                [packed, np.zeros((pad,) + packed.shape[1:], packed.dtype)]),
            np.concatenate(
                [players, np.full(pad, PAD_PLAYER, players.dtype)]),
            np.concatenate([ranks, np.full(pad, PAD_RANK, ranks.dtype)]),
        )


def bucketed_forward(fn, packed: np.ndarray, players: np.ndarray,
                     ranks: np.ndarray, ladder: BucketLadder) -> np.ndarray:
    """Run ``fn(packed, players, ranks) -> (B, ...)`` over the ladder.

    Any request count dispatches as top-rung chunks plus one padded
    remainder, so ``fn`` only ever sees ladder shapes. Returns the first-n
    rows as one host array.
    """
    parts = []
    for start, count, bucket in ladder.plan(len(packed)):
        sl = slice(start, start + count)
        p, pl, rk = ladder.pad(packed[sl], players[sl], ranks[sl], bucket)
        parts.append(np.asarray(fn(p, pl, rk))[:count])
    return parts[0] if len(parts) == 1 else np.concatenate(parts)
