"""Content-addressed position cache with request coalescing.

The port's copy of ``deepgo_tpu/serving/cache.py`` (digests from the
port's ``utils/digest.py``, so keys
and remapped rows are bitwise those of the JAX cache). The policy network
is a pure function of (packed planes, player, rank), and opening-heavy
traffic repeats positions, so a bounded LRU in front of
``FleetRouter.submit`` keyed on the content digests serves repeats without
a forward. Three protocol layers sit on top of plain lookup:

  * **keying** — ``exact`` keys on the sha256-64 of the dispatch row;
    ``canonical`` keys on the 8-fold-symmetry orbit minimum, so all
    dihedral views of one position share a single entry. A canonical
    entry stores the forward output of the CANONICAL view; a hit from
    any view is mapped back through the inverse dihedral permutation
    (``digest.INV_PERMS``, the same frozen table ``ops/augment`` bakes
    into training) — for an equivariant forward the remap is a pure
    gather, so parity with an uncached forward is bitwise. The plain
    f32 CNN is NOT architecturally equivariant (only the fused ``sym``
    variant is), so ``canonical`` is a config choice, not the default.
  * **coalescing** — N in-flight submits for one key attach as
    followers to one leader; the fleet runs exactly one forward. A
    failed/timed-out leader never poisons its followers: the leader's
    own caller sees its error, the next follower is PROMOTED and
    re-dispatched, and the chain terminates because every promotion
    consumes a waiter.
  * **invalidation** — stale-weights answers are wrong answers. The
    router bumps the cache generation and clears entries at BOTH ends
    of ``fleet.reload()``; every leader captures the generation when it
    starts, and ``complete_ok`` refuses to publish a fill from an older
    generation — so a forward that raced a weight roll can never leave
    a mixed-weights row behind for later traffic.
      ``deepgo_cache_stale_hits_total`` counts entries SERVED from a
    dead generation; the clear-on-invalidate discipline makes it
    structurally zero.

Per-tier bypass (``CacheConfig.bypass_tiers``) lets batch-tier bulk
scans opt out of polluting the LRU entirely — no lookup, no fill.

``simulate`` replays a captured key stream through the same eviction
policy offline: the achieved (not just projected) hit rate per cache
size, for capacity planning.

The cache owns keys, storage, and waiter bookkeeping; the ROUTER owns
dispatch and calls ``join`` / ``complete_ok`` / ``complete_err`` /
``invalidate`` (see fleet.py "the cached door"). Everything here is
thread-safe under one lock; resolution of waiter futures happens
outside it.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterable

import numpy as np

from ..analysis.lockcheck import make_lock
from ..obs import get_registry
from ..utils import digest as digest_mod

KEYINGS = ("exact", "canonical")


class CacheKeyingError(RuntimeError):
    """A canonical-key remap was asked of an output shape that has no
    per-point axis to permute (not a scalar, last dim != 361)."""


@dataclass(frozen=True)
class CacheConfig:
    """Position-cache policy knobs.

    capacity      — max entries; 0 disables storage (coalescing still
                    works: in-flight dedup needs no LRU).
    keying        — "exact" (sha256-64 of the dispatch row) or
                    "canonical" (8-fold-symmetry orbit minimum; requires
                    an equivariant forward for bitwise parity).
    bypass_tiers  — tiers that skip the cache entirely (no lookup, no
                    fill, no coalescing): batch-tier bulk scans must not
                    evict the interactive working set.
    coalesce      — attach concurrent same-key submits to one leader.
    """

    capacity: int = 4096
    keying: str = "exact"
    bypass_tiers: tuple = ("batch",)
    coalesce: bool = True

    def __post_init__(self):
        if self.capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {self.capacity}")
        if self.keying not in KEYINGS:
            raise ValueError(f"keying {self.keying!r} not in {KEYINGS}")


class Waiter:
    """One caller future riding an in-flight forward, plus everything a
    promotion needs to re-dispatch it (deadline/trace belong to the
    waiter, not the key)."""

    __slots__ = ("future", "k", "tier", "deadline", "trace")

    def __init__(self, future, k, tier, deadline, trace):
        self.future = future
        self.k = k
        self.tier = tier
        self.deadline = deadline
        self.trace = trace


class _InFlight:
    """One leader forward and its followers. ``generation`` is captured
    at creation: a fill whose generation is no longer current is
    discarded (the answer still serves its waiters — it was computed
    under SOME consistent weights — it just never enters storage)."""

    __slots__ = ("packed", "player", "rank", "generation", "waiters")

    def __init__(self, packed, player, rank, generation, waiter):
        self.packed = packed
        self.player = player
        self.rank = rank
        self.generation = generation
        self.waiters = [waiter]


class _Entry:
    __slots__ = ("row", "generation", "nbytes")

    def __init__(self, row: np.ndarray, generation: int):
        self.row = row
        self.generation = generation
        self.nbytes = int(row.nbytes)


class PositionCache:
    """Bounded content-addressed result cache + coalescing table.

    Driven by the router; usable standalone in tests. All counters are
    mirrored to the shared obs registry under ``deepgo_cache_*`` with a
    ``kind`` label carrying the keying mode.
    """

    def __init__(self, config: CacheConfig | None = None,
                 name: str = "cache", metrics=None,
                 clock=time.monotonic):
        self.config = config or CacheConfig()
        self.name = name
        self._metrics = metrics
        self._clock = clock
        self._lock = make_lock(f"cache.{name}")
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self._inflight: dict[str, _InFlight] = {}
        self._generation = 0
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._coalesced = 0
        self._evictions = 0
        self._invalidations = 0
        self._bypassed = 0
        self._stale_hits = 0     # gen-mismatched entries SERVED: never
        self._stale_blocked = 0  # gen-mismatched entries dropped unserved
        reg = get_registry()
        self._obs_hits = reg.counter(
            "deepgo_cache_hits_total",
            "requests served from the position cache")
        self._obs_misses = reg.counter(
            "deepgo_cache_misses_total",
            "cache lookups that went to a forward (leader dispatches)")
        self._obs_coalesced = reg.counter(
            "deepgo_cache_coalesced_total",
            "requests attached as followers to an in-flight leader")
        self._obs_evictions = reg.counter(
            "deepgo_cache_evictions_total",
            "entries dropped by the LRU bound")
        self._obs_invalidations = reg.counter(
            "deepgo_cache_invalidations_total",
            "generation bumps (reload starts/ends) clearing the cache")
        self._obs_stale = reg.counter(
            "deepgo_cache_stale_hits_total",
            "entries SERVED from a dead generation — structurally zero; "
            "the chaos integrity re-check asserts it stays there")
        self._obs_entries = reg.gauge(
            "deepgo_cache_entries", "positions currently cached")
        self._obs_bytes = reg.gauge(
            "deepgo_cache_bytes", "bytes held by cached result rows")

    # -- keying ------------------------------------------------------------

    def prepare(self, packed: np.ndarray, player: int, rank: int
                ) -> tuple[str, np.ndarray, int]:
        """(key, dispatch_packed, k): the cache key for this request,
        the packed view a leader should actually dispatch, and the
        symmetry index mapping the dispatched view back to the request
        (0 under exact keying — dispatch is the request itself)."""
        if self.config.keying == "canonical":
            return digest_mod.canonicalize(packed, player, rank)
        return (digest_mod.exact_digest(packed, player, rank),
                np.asarray(packed), 0)

    def bypass(self, tier: str | None) -> bool:
        if tier in self.config.bypass_tiers:
            with self._lock:
                self._bypassed += 1
            return True
        return False

    def _remap(self, row: np.ndarray, k: int) -> np.ndarray:
        """Map a stored canonical-view output to the waiter's view. A
        scalar output is symmetry-invariant (remap is the identity); a
        (..., 361) row gathers through the pinned inverse table; any
        other shape cannot be served across views."""
        arr = np.asarray(row)
        if k == 0 or arr.ndim == 0:
            return arr
        if arr.shape[-1] != digest_mod.NUM_POINTS:
            raise CacheKeyingError(
                f"canonical keying cannot remap output shape {arr.shape} "
                f"(expected scalar or last dim {digest_mod.NUM_POINTS})")
        return digest_mod.remap_from_canonical(arr, k)

    # -- the coalescing protocol ------------------------------------------

    def join(self, key: str, waiter: Waiter) -> tuple[str, np.ndarray | None]:
        """Atomically classify one request against storage + in-flight:

        ("hit", row)      — stored entry, already remapped to the
                            waiter's view; resolve the caller now.
        ("follower", None) — a leader is in flight; the waiter is queued
                            and will be resolved by ``complete_*``.
        ("leader", None)  — nobody is computing this key; the caller
                            must dispatch it and report back.
        """
        tier = waiter.tier or "none"
        kind = self.config.keying
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                if entry.generation != self._generation:
                    # invalidate() clears storage, so a dead-generation
                    # entry should not exist; drop it UNSERVED if one
                    # ever does — the miss path recomputes
                    self._drop_locked(key, entry)
                    self._stale_blocked += 1
                else:
                    self._entries.move_to_end(key)
                    self._hits += 1
                    row = entry.row
                    self._obs_hits.inc(cache=self.name, kind=kind, tier=tier)
                    return "hit", self._remap(row, waiter.k)
            flight = self._inflight.get(key)
            if flight is not None and self.config.coalesce:
                flight.waiters.append(waiter)
                self._coalesced += 1
                self._obs_coalesced.inc(cache=self.name, kind=kind,
                                        tier=tier)
                return "follower", None
            self._misses += 1
            self._obs_misses.inc(cache=self.name, kind=kind, tier=tier)
            return "leader", None

    def lead(self, key: str, packed: np.ndarray, player: int, rank: int,
             waiter: Waiter) -> None:
        """Register the leader's in-flight record (after ``join``
        returned "leader"). Kept separate so the router can refuse to
        lead — e.g. coalescing disabled — without poisoning the table."""
        with self._lock:
            self._inflight[key] = _InFlight(
                packed, int(player), int(rank), self._generation, waiter)

    def complete_ok(self, key: str, row) -> list[tuple[Waiter, object]]:
        """The leader's forward succeeded: publish (same-generation
        fills only) and hand back ``(waiter, value)`` pairs — values
        already remapped per waiter — for the router to resolve outside
        the cache lock."""
        arr = np.asarray(row)
        out = []
        with self._lock:
            flight = self._inflight.pop(key, None)
            if flight is None:
                return out
            if (flight.generation == self._generation
                    and self.config.capacity > 0):
                stored = np.array(arr)  # private copy; callers may mutate
                stored.setflags(write=False)
                prev = self._entries.pop(key, None)
                if prev is not None:
                    self._bytes -= prev.nbytes
                entry = _Entry(stored, flight.generation)
                self._entries[key] = entry
                self._bytes += entry.nbytes
                while len(self._entries) > self.config.capacity:
                    _, old = self._entries.popitem(last=False)
                    self._bytes -= old.nbytes
                    self._evictions += 1
                    self._obs_evictions.inc(cache=self.name,
                                            kind=self.config.keying)
                self._update_gauges_locked()
            for w in flight.waiters:
                try:
                    out.append((w, self._remap(arr, w.k)))
                except CacheKeyingError as e:
                    out.append((w, e))
        return out

    def complete_err(self, key: str
                     ) -> tuple[Waiter | None, Waiter | None, object | None]:
        """The leader's forward failed. Returns ``(leader, promoted,
        dispatch)``: the leader waiter (its caller gets the error — a
        failure is the leader's own), the next follower promoted to
        leader (re-dispatch it; None when no followers remain), and the
        ``(packed, player, rank)`` triple the promotion must submit."""
        with self._lock:
            flight = self._inflight.get(key)
            if flight is None:
                return None, None, None
            leader = flight.waiters.pop(0) if flight.waiters else None
            if not flight.waiters:
                del self._inflight[key]
                return leader, None, None
            promoted = flight.waiters[0]
            return leader, promoted, (flight.packed, flight.player,
                                      flight.rank)

    def drop_flight(self, key: str) -> list[Waiter]:
        """Remove one in-flight record wholesale (shutdown sweep) and
        return every waiter still riding it."""
        with self._lock:
            flight = self._inflight.pop(key, None)
            return list(flight.waiters) if flight is not None else []

    def inflight_keys(self) -> list[str]:
        with self._lock:
            return list(self._inflight)

    # -- invalidation ------------------------------------------------------

    def invalidate(self, reason: str = "reload") -> int:
        """Bump the generation and clear storage. In-flight leaders keep
        computing — their answers still serve their waiters — but their
        fills are now refused (generation mismatch). Returns the number
        of entries dropped."""
        with self._lock:
            dropped = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            self._generation += 1
            self._invalidations += 1
            self._update_gauges_locked()
        self._obs_invalidations.inc(cache=self.name,
                                    kind=self.config.keying, reason=reason)
        if self._metrics is not None:
            self._metrics.write("cache_invalidate", cache=self.name,
                                reason=reason, dropped=dropped)
        return dropped

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    # -- accounting --------------------------------------------------------

    def _drop_locked(self, key: str, entry: _Entry) -> None:
        self._entries.pop(key, None)
        self._bytes -= entry.nbytes
        self._update_gauges_locked()

    def _update_gauges_locked(self) -> None:
        self._obs_entries.set(len(self._entries), cache=self.name)
        self._obs_bytes.set(self._bytes, cache=self.name)

    def stats(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            return {
                "keying": self.config.keying,
                "capacity": self.config.capacity,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self._hits,
                "misses": self._misses,
                "coalesced": self._coalesced,
                "evictions": self._evictions,
                "invalidations": self._invalidations,
                "bypassed": self._bypassed,
                "stale_hits": self._stale_hits,
                "stale_blocked": self._stale_blocked,
                "hit_rate": (self._hits / total) if total else None,
                "inflight": len(self._inflight),
                "generation": self._generation,
            }


# -- offline simulation ----------------------------------------------------

def simulate(keys: Iterable[str], capacity: int) -> dict:
    """Replay a key stream through the production eviction policy (LRU,
    same order of operations) and report the ACHIEVED hit rate, for
    capacity planning. Coalescing is not modeled: a capture is sequential, so
    in-flight overlap is a live-only effect."""
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    lru: OrderedDict[str, None] = OrderedDict()
    hits = misses = evictions = 0
    for key in keys:
        if key in lru:
            hits += 1
            lru.move_to_end(key)
            continue
        misses += 1
        if capacity > 0:
            lru[key] = None
            if len(lru) > capacity:
                lru.popitem(last=False)
                evictions += 1
    total = hits + misses
    return {
        "capacity": capacity,
        "requests": total,
        "hits": hits,
        "misses": misses,
        "evictions": evictions,
        "hit_rate": round(hits / total, 4) if total else None,
    }
