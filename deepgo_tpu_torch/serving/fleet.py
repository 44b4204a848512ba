"""FleetRouter: N supervised engine replicas behind one failure-absorbing
front door.

The port of ``deepgo_tpu/serving/fleet.py``. One ``SupervisedEngine``
survives a dead dispatcher, a poisoned batch and a failing device, but it
is still one dispatcher — a single failure domain and a single ceiling.
FireCaffe's scale-out framing (arXiv:1511.00175) says the serving answer is
N replicas whose aggregate absorbs the failure of any one of them, and at
fleet sizes failure is the steady state, so the router — not the operator —
must do the absorbing. This module is that router, plus the two things a
fleet needs that a single engine does not:

  placement   least-estimated-wait: each submit routes to the serving
              replica whose ``estimated_wait_s()`` (rolling p50 dispatch
              latency x pending windows, the supervisor's admission
              estimate) is
              smallest, with pending-count and round-robin tie-breaks, so
              load follows capacity instead of a static hash.
  failover    a request whose replica dies under it (RestartsExhausted,
              dispatcher death past the replica's restart budget, closed
              mid-flight) or trips its breaker is transparently re-routed
              to a healthy replica WITH EXCLUSION — the failed replica is
              struck from that request's candidate set, so a poisoned
              placement can't bounce back to the same corpse. Retries are
              bounded (``max_failovers``); a ``PoisonedRequest`` is final
              — the request's own content fails the forward, and retrying
              it fleet-wide would poison every replica in turn.
  respawn     a replica that exhausted its supervisor's restart budget is
              rebuilt in the background (bounded full-jitter backoff, the
              resilience.py discipline) while traffic routes around it;
              the fleet never blocks a caller on a rebuild.
  hot reload  ``reload(params_or_checkpoint)`` rolls new weights through
              the replicas ONE AT A TIME: drain (placement skips the
              replica, its in-flight requests finish on the old weights),
              swap the params reference (``set_params``: the live
              module is never written in place), rejoin. In-flight
              futures never
              drop and the fleet never goes below N-1 capacity.
  QoS tiers   every request carries a priority class, ``interactive >
              selfplay > batch``. Fleet admission control sheds the cheap
              tier first: each tier's headroom factor scales how much of
              its deadline the estimated queue wait may consume before
              the request is shed at the door (batch sheds at 30% of its
              deadline, interactive only when the deadline is genuinely
              unmeetable), with per-tier shed counters and a ``tier``
              label on the request-latency histogram.
  hedging     gray-failure defense #1: a request on
              a latency-critical tier (``hedge_tiers``) that has not
              resolved after a p99-derived delay is DUPLICATED onto a
              second replica — first result wins, the loser is
              cancelled, and the duplicate rate is capped
              (``hedge_max_frac``) so a sick fleet can't double its own
              load. A slow-but-alive replica costs one hedge delay, not
              one brownout.
  ejection    gray-failure defense #2: the router keeps a per-replica
              latency window; a replica whose median stays above
              ``eject_factor`` x the median of its peers for
              ``eject_consecutive`` scans is force-recycled through the
              existing respawn path (``eject_replica`` — also the
              entry point for a prober that catches a replica
              returning wrong answers).
  integrity   gray-failure defense #3: an optional per-response
              ``integrity_check`` predicate; a row that fails it is
              treated as a replica failure (excluded, failed over,
              counted) instead of being handed to the caller — corrupt
              output becomes lost headroom, never a wrong answer.
  caching     an optional content-addressed result cache in FRONT of
              placement (serving/cache.py): repeat positions are served
              from memory, concurrent same-position submits coalesce
              onto one forward with leader-failure promotion, and
              ``reload`` invalidates at both ends of the roll so a
              stale-weights row is never served.
  surge tier  heterogeneous replica platforms (``fleet_policy_engine``'s
              ``platforms=``, e.g. ``("cuda", "cpu")``): batch-tier
              traffic prefers CPU surge replicas and the latency tiers
              avoid them, by PREFERENCE —
              failover crosses platforms when a tier's preferred set
              dies — and the straggler scan baselines each replica
              against same-platform peers only.

Fault sites: ``fleet_route`` fires inside each placement attempt (an
injected fault there is absorbed like a replica failure — excluded,
re-routed, counted); ``fleet_reload`` fires per replica swap during a
rolling reload (a fault surfaces as a typed ``FleetReloadError`` while
the replica rejoins and the fleet keeps serving).

The contract is the supervisor's, widened to the fleet: every submitted
future RESOLVES — a result (possibly after transparent failovers and
respawns), or a typed shed / poison / timeout / exhaustion — never a
stranded waiter. Clock, sleep, and RNG are injectable; the tests drive
every transition deterministically.

A resolved future says where its row came from: ``replica`` (the index
that ran the forward) and ``bucket`` (the rung it dispatched on), both
None for a cache hit, and on the cached door ``cache``, one of "leader",
"follower" and "hit". Several replicas on one card each run their own
dispatcher thread on that thread's current (default) stream; the
forward's device-to-host copy is each dispatch's one synchronisation.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import os
import queue
import random
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np

from ..analysis.lockcheck import make_lock
from ..obs import get_registry
from ..obs.sentinel import flight_dump
from ..utils import faults
from .cache import PositionCache, Waiter
from .engine import EngineBusy, EngineClosed, EngineError
from .resilience import (CircuitOpen, EngineOverloaded, PoisonedRequest,
                         full_jitter_delay)

# priority classes, most- to least-important: overload sheds from the
# right end first (per-tier headroom factors in FleetConfig)
TIERS = ("interactive", "selfplay", "batch")


class FleetUnavailable(EngineError):
    """No replica could take the request: everything is failed,
    respawning, or excluded by this request's own failover history."""


class FailoverExhausted(EngineError):
    """The request's bounded failover budget ran out; the last replica
    failure rides as ``__cause__``."""


class FleetReloadError(EngineError):
    """A rolling weight reload failed mid-roll. Replicas already swapped
    keep the new weights, the failing replica rejoined on its old ones,
    and every later respawn/restart converges on the new checkpoint —
    re-invoking ``reload`` is idempotent."""


class IntegrityViolation(EngineError):
    """A replica returned a response that failed the fleet's
    ``integrity_check`` predicate — silently wrong output (the gray
    failure). The router treats it as a replica failure: the request
    fails over with exclusion and the caller never sees the bad row."""


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs for one FleetRouter.

    ``*_headroom`` is the fraction of a request's deadline the estimated
    fleet queue wait may consume before that tier is shed at admission:
    1.0 sheds interactive only when its deadline is already unmeetable,
    while batch backs off at 30% — so overload drains the cheap tier
    first and the expensive tier last. ``max_failovers`` bounds how many
    replica FAILURES one request may ride through (shed-reroutes don't
    count); ``max_respawns`` bounds CONSECUTIVE background rebuilds of
    one replica (any request it serves resets the count).

    The gray-failure knobs are OFF by default — ``hedge_tiers=()``
    disables hedging, ``eject_stragglers=False`` disables outlier
    ejection, ``integrity_check=None`` disables response validation — so
    a plain fleet behaves exactly as before; a production config opts in
    explicitly. A request on a
    hedged tier duplicates after ``hedge_factor`` x that tier's rolling
    p99 (floored at ``hedge_min_delay_s`` while the tier has no data),
    with at most ``hedge_max_frac`` of submits hedged. A replica whose
    per-replica latency median exceeds ``eject_factor`` x the median of
    its peers (each over ``eject_min_samples``+ completions) for
    ``eject_consecutive`` consecutive scans is force-recycled.
    ``integrity_check(row) -> bool`` validates every response row.

    ``surge_platforms`` names the CPU surge tier on a heterogeneous
    fleet: replicas whose engine carries a matching ``platform`` stamp
    (``fleet_policy_engine(platforms=...)``) are PREFERRED for batch-tier
    traffic and avoided by the latency tiers — but preference, not
    partition: when a tier's preferred set is empty (all CUDA replicas
    dead, or a CPU-only fleet) placement falls back to every candidate,
    so failover crosses platforms automatically. On a homogeneous fleet
    (no platform stamps) the knob is inert."""

    max_failovers: int = 3
    default_tier: str = "interactive"
    interactive_headroom: float = 1.0
    selfplay_headroom: float = 0.6
    batch_headroom: float = 0.3
    admission_control: bool = True
    min_serving: int = 1
    max_respawns: int = 8
    respawn_base_s: float = 0.05
    respawn_cap_s: float = 2.0
    warm_on_respawn: bool = True
    drain_timeout_s: float = 30.0
    hedge_tiers: tuple = ()
    hedge_factor: float = 1.0
    hedge_min_delay_s: float = 0.02
    hedge_max_frac: float = 0.2
    eject_stragglers: bool = False
    eject_factor: float = 3.0
    eject_min_samples: int = 20
    eject_consecutive: int = 2
    integrity_check: object = None
    surge_platforms: tuple = ("cpu",)

    def headroom(self, tier: str) -> float:
        return {"interactive": self.interactive_headroom,
                "selfplay": self.selfplay_headroom,
                "batch": self.batch_headroom}[tier]


class _FleetRequest:
    __slots__ = ("packed", "player", "rank", "tier", "deadline", "future",
                 "excluded", "failovers", "t_submit", "t_first_failure",
                 "last_error", "trace", "workload", "placed", "inners",
                 "hedge_state", "hedge_idx", "parked")

    def __init__(self, packed, player, rank, tier, deadline, t_submit,
                 trace=None, workload=None):
        self.packed = packed
        self.player = player
        self.rank = rank
        self.tier = tier
        self.deadline = deadline          # absolute, router clock
        self.future: Future = Future()
        self.excluded: set[int] = set()   # replicas this request fled
        self.failovers = 0
        self.t_submit = t_submit
        self.t_first_failure: float | None = None
        self.last_error: BaseException | None = None
        self.trace = trace                # one id across every hop
        self.workload = workload          # WorkloadToken, fleet-owned
        self.placed: int | None = None    # latest primary placement
        self.inners: dict[int, Future] = {}  # replica idx -> inner future
        self.hedge_state: str | None = None  # None|scheduled|launched
        self.hedge_idx: int | None = None    # the hedge copy's replica
        self.parked = False               # waiting out a respawn in flight


class _Replica:
    __slots__ = ("idx", "engine", "state", "pending", "consec_respawns",
                 "respawns", "lat", "eject_strikes")

    def __init__(self, idx, engine):
        self.idx = idx
        self.engine = engine
        self.state = "serving"   # serving | draining | respawning | failed
        self.pending = 0         # in-flight requests routed here
        self.consec_respawns = 0
        self.respawns = 0
        self.lat: deque = deque(maxlen=128)  # per-replica completion times
        self.eject_strikes = 0   # consecutive outlier scans


class FleetRouter:
    """N replicas, one router thread, the full SupervisedEngine surface.

    ``make_replica(i) -> SupervisedEngine`` builds (and rebuilds) replica
    ``i``; build the forward ONCE outside and close over it so all
    replicas share it, through restarts, respawns and weight reloads.
    Duck-types the engine surface every consumer
    uses (submit / evaluate / warmup / stats / compile_cache_size /
    health / close / context manager), so selfplay, arena agents, the
    shared registry, and /healthz adapters ride it unchanged.
    """

    def __init__(self, make_replica, replicas: int,
                 config: FleetConfig | None = None, name: str = "fleet",
                 metrics=None, clock=time.monotonic, sleep=time.sleep,
                 rng=None, params=None, cache=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.config = config or FleetConfig()
        if self.config.default_tier not in TIERS:
            raise ValueError(
                f"default_tier {self.config.default_tier!r} not in {TIERS}")
        self.name = name
        # the position cache sits in FRONT of placement (serving/cache.py:
        # keying, coalescing, invalidation-on-reload); None keeps the
        # pre-cache door byte-for-byte. A CacheConfig is wrapped here so
        # callers never have to touch PositionCache directly.
        if cache is None or isinstance(cache, PositionCache):
            self.cache = cache
        else:
            self.cache = PositionCache(cache, name=f"{name}-cache",
                                       metrics=metrics)
        self._make_replica = make_replica
        self._metrics = metrics
        self._clock = clock
        self._sleep = sleep
        # lint: allow[determinism] backoff jitter only — placement and results never depend on it; tests inject rng=
        self._rng = rng if rng is not None else random.Random()
        self._lock = make_lock(f"fleet.{name}")
        self._closing = threading.Event()
        self._events: queue.Queue = queue.Queue()
        self._rr = 0                       # round-robin tie-break cursor
        # the BASE (full-precision) params, the reload/respawn source of
        # truth: replicas serving a lossy variant carry a
        # ``prepare_params`` hook (serving/variants.py) the router
        # applies before every swap, so the base tree — not a variant's
        # int8 pytree — is always the checkpoint-load template
        self._current_params = params      # updated by reload; respawns converge
        self._reload_mutex = make_lock(f"fleet.{name}.reload")
        self._failovers = 0
        self._respawns = 0
        self._reloads = 0
        self._poisoned = 0
        self._submits = 0
        self._hedges = 0
        self._hedge_wins = 0
        self._ejections = 0
        self._integrity_failures = 0
        self._respawn_threads: list[threading.Thread] = []
        self._parked: list[_FleetRequest] = []
        self._parks = 0
        self._shed = {t: 0 for t in TIERS}
        self._tier_lat: dict[str, deque] = {t: deque(maxlen=4096)
                                            for t in TIERS}
        self._failover_lat: deque = deque(maxlen=1024)
        reg = get_registry()
        self._obs_failovers = reg.counter(
            "deepgo_fleet_failovers_total",
            "requests re-routed off a failed replica")
        self._obs_shed = reg.counter(
            "deepgo_fleet_shed_total",
            "requests shed at the fleet door (tier, reason)")
        self._obs_respawns = reg.counter(
            "deepgo_fleet_respawns_total",
            "replicas rebuilt in the background after supervisor give-up")
        self._obs_reloads = reg.counter(
            "deepgo_fleet_reloads_total", "rolling weight reloads completed")
        self._obs_serving = reg.gauge(
            "deepgo_fleet_replicas_serving",
            "replicas currently accepting placement")
        self._obs_replica_state = reg.gauge(
            "deepgo_fleet_replica_state",
            "per-replica lifecycle: 1 serving, 0.5 draining/respawning, "
            "0 failed — the dash health grid's rows")
        self._obs_failover_s = reg.histogram(
            "deepgo_fleet_failover_seconds",
            "first replica failure to final resolution, failed-over "
            "requests only")
        self._obs_hedges = reg.counter(
            "deepgo_fleet_hedges_total",
            "hedge duplicates launched for latency-critical tiers")
        self._obs_hedge_wins = reg.counter(
            "deepgo_fleet_hedge_wins_total",
            "hedged requests whose hedge copy resolved first")
        self._obs_ejections = reg.counter(
            "deepgo_fleet_ejections_total",
            "replicas force-recycled (latency outlier, canary, operator)")
        self._obs_integrity = reg.counter(
            "deepgo_fleet_integrity_failures_total",
            "responses rejected by the fleet integrity check")
        self._obs_parks = reg.counter(
            "deepgo_fleet_parks_total",
            "unroutable requests parked to wait out a respawn in flight "
            "instead of resolving typed exhaustion against a fleet that "
            "is only temporarily below strength")
        self._obs_breaker = reg.gauge(
            "deepgo_fleet_breaker_state",
            "per-replica circuit breaker: 0 closed, 1 half-open, 2 open")
        # the EXISTING request histogram gains a tier label at fleet
        # level: per-tier latency scrapes next to the engines' own series
        self._obs_request = reg.histogram(
            "deepgo_serving_request_seconds",
            "request latency submit-to-result")
        self._replicas = [_Replica(i, make_replica(i))
                          for i in range(replicas)]
        self._update_serving_gauge()
        self._hedge_q: list = []       # heap of (due, seq, request)
        self._hedge_cv = threading.Condition()
        self._hedge_seq = itertools.count()
        self._hedge_thread = None
        if self.config.hedge_tiers and replicas > 1:
            self._hedge_thread = threading.Thread(
                target=self._hedge_loop, name=f"fleet-{name}-hedger",
                daemon=True)
            self._hedge_thread.start()
        self._thread = threading.Thread(
            target=self._router_loop, name=f"fleet-{name}", daemon=True)
        self._thread.start()

    # -- lifecycle ---------------------------------------------------------

    def warmup(self) -> int:
        """Warm every replica at every rung. Returns the per-replica
        rung count (the engine warmup contract)."""
        warmed = 0
        for rep in self._replicas:
            warmed = rep.engine.warmup()
        return warmed

    def compile_cache_size(self) -> int | None:
        """Fleet-wide compile count: the SUM over replicas (None when no
        replica exposes a cache, as no port engine does: it has no
        compile cache)."""
        sizes = [s for s in self.compile_cache_sizes() if s is not None]
        return sum(sizes) if sizes else None

    def compile_cache_sizes(self) -> list[int | None]:
        """Per-replica compile counts, index-aligned with replica ids."""
        return [rep.engine.compile_cache_size() for rep in self._replicas]

    @property
    def ladder(self):
        return self._replicas[0].engine.ladder

    @property
    def replicas(self) -> int:
        return len(self._replicas)

    def _check_alive(self) -> None:
        if self._closing.is_set():
            raise EngineClosed(f"FleetRouter[{self.name}] is closed")

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop routing and shut every replica down. Same contract as the
        layers below: returns with every outstanding future resolved —
        drained results or typed EngineClosed, never stranded waiters.

        Respawn threads are joined (bounded by ``timeout``) BEFORE the
        replica engines close: a respawn that already built its
        replacement engine swaps it in under the lock, and closing the
        replica list while that swap is in flight would close the corpse
        and leak the live replacement. ``_respawn`` checks ``_closing``
        after the build and discards its engine, so after the join there
        is exactly one engine per replica left to close."""
        self._closing.set()
        self._events.put(("stop", None))
        with self._hedge_cv:
            self._hedge_cv.notify_all()
        self._thread.join(timeout=timeout)
        if self._hedge_thread is not None:
            self._hedge_thread.join(timeout=timeout)
        with self._lock:
            spawners = list(self._respawn_threads)
        for t in spawners:
            t.join(timeout=timeout)
        for rep in self._replicas:
            try:
                rep.engine.close(drain=drain, timeout=timeout)
            except Exception:  # pragma: no cover — corpse cleanup only
                pass
        exc = EngineClosed(
            f"FleetRouter[{self.name}] closed with request pending")
        while True:
            try:
                kind, payload = self._events.get_nowait()
            except queue.Empty:
                break
            if kind == "failover" and not payload.future.done():
                payload.future.set_exception(exc)
        with self._lock:
            parked, self._parked = self._parked, []
        for req in parked:
            if not req.future.done():
                req.future.set_exception(exc)
        if self.cache is not None:
            # failing the queued internal leaders above already walked
            # complete_err/promotion for most flights; this sweep catches
            # waiters whose leader future resolved before the callback
            # could re-dispatch — the no-stranded-waiter contract holds
            # through the cached door too
            for key in self.cache.inflight_keys():
                for w in self.cache.drop_flight(key):
                    self._resolve_waiter(w, exc)
        if self._metrics is not None:
            self._metrics.write("fleet_close", fleet=self.name,
                                **self._counters())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- submission --------------------------------------------------------

    def submit(self, packed: np.ndarray, player: int, rank: int,
               tier: str | None = None, timeout_s: float | None = None,
               block: bool = True, session: str | None = None) -> Future:
        """Queue one board on the least-loaded replica; the Future ALWAYS
        resolves: the result row (possibly after transparent failovers,
        replica restarts, and background respawns), TimeoutError,
        EngineOverloaded (tier shed at the fleet door), CircuitOpen /
        EngineBusy (every replica shedding), PoisonedRequest (the request
        itself fails the forward — final, never retried fleet-wide),
        FailoverExhausted, or FleetUnavailable."""
        self._check_alive()
        tier = tier or self.config.default_tier
        if tier not in TIERS:
            raise ValueError(f"tier {tier!r} not in {TIERS}")
        if timeout_s is not None and self.config.admission_control:
            est = self.estimated_wait_s()
            if est is not None and est > timeout_s * self.config.headroom(tier):
                self._count_shed(tier, "admission")
                raise EngineOverloaded(
                    f"FleetRouter[{self.name}] estimated queue wait "
                    f"{est:.3f}s exceeds tier {tier!r} headroom "
                    f"({self.config.headroom(tier):g} x {timeout_s}s "
                    "deadline); shed at the fleet door")
        now = self._clock()
        deadline = None if timeout_s is None else now + timeout_s
        # the fleet door is the outermost serving layer: it owns the
        # request's TraceContext — one trace id across every placement,
        # failover hop, replica restart, and the final resolution —
        # and, under the same ownership rule, the request's
        # WorkloadToken (obs/workload.py): arrival + tier recorded
        # here, the bucket stamped by whichever engine dispatches it
        from ..obs import tracing
        from ..obs import workload as workload_mod

        trace = tracing.start_request(fleet=self.name, tier=tier)
        wl = workload_mod.note_request(packed, player, rank, tier=tier,
                                       fleet=self.name, session=session)
        if self.cache is not None and not self.cache.bypass(tier):
            return self._submit_cached(packed, player, rank, tier,
                                       deadline, now, trace, wl, block)
        req = _FleetRequest(np.asarray(packed), int(player), int(rank),
                            tier, deadline, now, trace=trace, workload=wl)
        with self._lock:
            self._submits += 1  # the hedge-rate cap's denominator
        if trace is not None:
            trace.mark("queued", fleet=self.name, tier=tier)
            req.future.add_done_callback(trace.finish_future)
        if wl is not None:
            req.future.add_done_callback(wl.finish_future)
        self._dispatch(req, block=block)
        if req.future.done():
            exc = req.future.exception()
            if isinstance(exc, (EngineOverloaded, CircuitOpen, EngineBusy,
                                FleetUnavailable)):
                raise exc  # door-shed surface, same as SupervisedEngine
        return req.future

    # -- the cached door ---------------------------------------------------

    def _submit_cached(self, packed, player, rank, tier, deadline, now,
                       trace, wl, block) -> Future:
        """Route one request through the position cache:

        hit       — the stored row (remapped to this view under canonical
                    keying) resolves the caller immediately; no replica
                    sees the request.
        follower  — a leader forward for this key is in flight; the
                    caller rides it and is resolved by the leader's
                    completion. Exactly one forward for N submits.
        leader    — dispatch through the normal placement/failover path;
                    the internal request's future is DECOUPLED from the
                    caller's so a leader failure can promote a follower
                    instead of poisoning everyone (``_on_leader_done``).

        Cache hits deliberately do NOT feed the per-replica/tier latency
        windows — hedging delays and ejection baselines measure forwards,
        and letting near-zero hit latencies in would hedge everything."""
        cache = self.cache
        caller: Future = Future()
        with self._lock:
            self._submits += 1  # the hedge-rate cap's denominator
        if trace is not None:
            trace.mark("queued", fleet=self.name, tier=tier)
            caller.add_done_callback(trace.finish_future)
        if wl is not None:
            caller.add_done_callback(wl.finish_future)
        key, disp_packed, k = cache.prepare(np.asarray(packed),
                                            int(player), int(rank))
        waiter = Waiter(caller, k, tier, deadline, trace)
        role, row = cache.join(key, waiter)
        caller.cache = role
        if role == "hit":
            if trace is not None:
                trace.mark("cache_hit", key=key)
            caller.replica = caller.bucket = None
            self._resolve_waiter(waiter, row)
            return caller
        if role == "follower":
            if trace is not None:
                trace.mark("cache_coalesced", key=key)
            return caller
        if trace is not None:
            trace.mark("cache_miss", key=key)
        cache.lead(key, disp_packed, int(player), int(rank), waiter)
        req = _FleetRequest(np.asarray(disp_packed), int(player),
                            int(rank), tier, deadline, now, trace=trace,
                            workload=wl)
        req.future.add_done_callback(
            lambda f: self._on_leader_done(key, f))
        self._dispatch(req, block=block)
        if caller.done():
            exc = caller.exception()
            if isinstance(exc, (EngineOverloaded, CircuitOpen, EngineBusy,
                                FleetUnavailable)):
                raise exc  # door-shed surface, same as the uncached path
        return caller

    @staticmethod
    def _resolve_waiter(waiter: Waiter, value) -> bool:
        """Resolve one cache waiter's caller future exactly once; a
        CacheKeyingError value (an output shape the canonical remap
        cannot serve across views) resolves as the typed exception."""
        try:
            if isinstance(value, BaseException):
                waiter.future.set_exception(value)
            else:
                waiter.future.set_result(value)
            return True
        except InvalidStateError:
            return False

    def _on_leader_done(self, key: str, f: Future) -> None:
        """The leader's internal forward resolved. Success publishes the
        fill (same generation only) and resolves every waiter with its
        per-view remap. Failure is the LEADER'S OWN — its caller gets
        the error, the next follower is promoted and re-dispatched on
        the router thread (never this resolver thread), and the chain
        terminates because each promotion consumes a waiter."""
        cache = self.cache
        exc = (EngineClosed(f"FleetRouter[{self.name}] cancelled a "
                            "cached leader") if f.cancelled()
               else f.exception())
        if exc is None:
            for w, value in cache.complete_ok(key, f.result()):
                w.future.replica = getattr(f, "replica", None)
                w.future.bucket = getattr(f, "bucket", None)
                self._resolve_waiter(w, value)
            return
        leader, promoted, dispatch = cache.complete_err(key)
        if leader is not None:
            self._resolve_waiter(leader, exc)
        if promoted is None:
            return
        if promoted.trace is not None:
            promoted.trace.mark("cache_promoted", key=key)
        if self._closing.is_set():
            closed = EngineClosed(
                f"FleetRouter[{self.name}] closed with request pending")
            self._resolve_waiter(promoted, closed)
            for w in cache.drop_flight(key):
                self._resolve_waiter(w, closed)
            return
        packed, player, rank = dispatch
        # the promoted waiter's OWN deadline/trace ride the re-dispatch;
        # its workload token keeps finishing through its caller future
        # (the bucket stamp of the failed leader's forward is lost —
        # acceptable: promotions are failure-path rare)
        req = _FleetRequest(packed, player, rank, promoted.tier,
                            promoted.deadline, self._clock(),
                            trace=promoted.trace, workload=None)
        req.future.add_done_callback(
            lambda f2: self._on_leader_done(key, f2))
        self._events.put(("failover", req))

    def evaluate(self, packed: np.ndarray, players: np.ndarray,
                 ranks: np.ndarray, timeout_s: float | None = None,
                 tier: str | None = None) -> np.ndarray:
        """Blocking convenience, same shape as InferenceEngine.evaluate."""
        futures = [self.submit(packed[i], int(players[i]), int(ranks[i]),
                               tier=tier, timeout_s=timeout_s)
                   for i in range(len(packed))]
        return np.stack([f.result() for f in futures])

    def estimated_wait_s(self) -> float | None:
        """The fleet's load estimate: the MINIMUM replica estimate — a
        new request goes to the least-loaded replica, so the best replica
        is the wait the request will actually see. Replicas with no
        dispatch data yet are UNKNOWN, not idle — they are skipped, so a
        freshly (re)spawned replica cannot zero the fleet-wide minimum
        and blind the admission door while its siblings drown. None when
        no serving replica has data (an idle fleet never sheds)."""
        with self._lock:
            reps = [r for r in self._replicas if r.state == "serving"]
        vals = []
        for r in reps:
            try:
                v = r.engine.estimated_wait_s()
            except Exception:  # a dying replica must not poison admission
                continue
            if v is not None:
                vals.append(v)
        return min(vals) if vals else None

    # -- routing -----------------------------------------------------------

    def _pick(self, req: _FleetRequest, tried: set[int]):
        """Least-estimated-wait placement over serving replicas, skipping
        this request's exclusions. Draining replicas (mid-reload) are a
        last resort: better one more old-weights request than a shed."""
        avoid = req.excluded | tried
        with self._lock:
            cands = [r for r in self._replicas
                     if r.state == "serving" and r.idx not in avoid]
            if not cands:
                cands = [r for r in self._replicas
                         if r.state == "draining" and r.idx not in avoid]
            self._rr += 1
            rr = self._rr
        if not cands:
            return None
        cands = self._platform_preference(cands, req.tier)
        n = len(self._replicas)

        def key(r):
            try:
                est = r.engine.estimated_wait_s()
            except Exception:
                est = None
            return (est if est is not None else 0.0, r.pending,
                    (r.idx - rr) % n)

        return min(cands, key=key)

    def _platform_preference(self, cands: list, tier: str) -> list:
        """The CPU surge tier's routing rule: batch-tier traffic prefers
        ``surge_platforms`` replicas (bulk scans tolerate CPU latency and
        free the accelerators), every other tier avoids them. Preference
        only — an empty preferred set falls back to all candidates, so a
        fleet whose TPU replicas all died keeps serving interactive
        traffic on the surge tier, and a homogeneous fleet (no platform
        stamps) is untouched."""
        surge = self.config.surge_platforms
        if not surge:
            return cands
        if tier == "batch":
            pref = [r for r in cands
                    if getattr(r.engine, "platform", None) in surge]
        else:
            pref = [r for r in cands
                    if getattr(r.engine, "platform", None) not in surge]
        return pref or cands

    def _dispatch(self, req: _FleetRequest, block: bool = True) -> None:
        """Route one request: try candidates best-first until a replica
        accepts it. Hard failures exclude the replica for this request's
        lifetime (failover-with-exclusion) and wake the respawn scanner;
        sheds only skip the replica for this routing round."""
        tried: set[int] = set()
        shed_error: BaseException | None = None
        while True:
            if req.future.done():
                return
            if req.deadline is not None and self._clock() >= req.deadline:
                self._resolve(req, exc=TimeoutError(
                    f"request deadline expired before placement in "
                    f"FleetRouter[{self.name}]"))
                return
            rep = self._pick(req, tried)
            if rep is None:
                self._resolve_unroutable(req, shed_error)
                return
            remaining = (None if req.deadline is None
                         else req.deadline - self._clock())
            if req.trace is not None:
                # the placement decision, stamped before the handoff so a
                # submit-time death renders as routed -> hop
                req.trace.mark("routed", replica=rep.idx)
                req.trace.set(replica=rep.idx)
            try:
                faults.check("fleet_route")
                # the trace/workload kwargs only travel when armed, so
                # scripted duck-typed replicas keep their plain signature
                kw = {} if req.trace is None else {"trace": req.trace}
                if req.workload is not None:
                    kw["workload"] = req.workload
                inner = rep.engine.submit(req.packed, req.player, req.rank,
                                          timeout_s=remaining, block=block,
                                          **kw)
            except (EngineOverloaded, CircuitOpen, EngineBusy) as e:
                # replica-level shed: transparent reroute, no exclusion —
                # the replica is healthy, just full (or probing)
                tried.add(rep.idx)
                shed_error = e
                continue
            except (EngineError, faults.FaultError) as e:
                # replica dead/dying under the submit (RestartsExhausted,
                # EngineClosed, injected route fault): exclude + re-route
                self._note_failure(req, rep, e)
                if req.future.done():
                    return
                continue
            with self._lock:
                rep.pending += 1
            req.placed = rep.idx
            req.inners[rep.idx] = inner
            inner.add_done_callback(
                lambda f, rep=rep: self._on_replica_done(req, rep, f))
            if (self._hedge_thread is not None
                    and req.tier in self.config.hedge_tiers
                    and req.hedge_state is None):
                self._schedule_hedge(req)
            return

    def _resolve_unroutable(self, req: _FleetRequest,
                            shed_error: BaseException | None) -> None:
        """Every candidate is gone: a shed if replicas shed us, typed
        exhaustion if this request already fled failures, else the fleet
        is simply down — UNLESS a respawn is in flight and the deadline
        still has headroom, in which case the request parks and the
        router re-dispatches it when the rebuild lands."""
        if shed_error is not None:
            self._count_shed(req.tier, "replicas")
            self._resolve(req, exc=shed_error)
        elif self._park(req):
            return
        elif req.failovers > 0:
            err = FailoverExhausted(
                f"FleetRouter[{self.name}] request failed over "
                f"{req.failovers} time(s) and no healthy replica remains")
            err.__cause__ = req.last_error
            self._resolve(req, exc=err)
        else:
            self._count_shed(req.tier, "unroutable")
            self._resolve(req, exc=FleetUnavailable(
                f"FleetRouter[{self.name}] has no serving replica "
                f"({self._serving_count()}/{len(self._replicas)} serving)"))

    def _park(self, req: _FleetRequest) -> bool:
        """Park one unroutable request while any replica is mid-respawn:
        the fleet is temporarily below strength, not down, so resolving
        FailoverExhausted / FleetUnavailable here burns a typed error
        against capacity that is seconds from returning. Parked requests are re-dispatched by
        the router when a respawn lands or gives up (``"respawned"``
        events), and swept on idle ticks so a lapsed deadline resolves
        its TimeoutError promptly; ``close()`` drains the parking lot
        with EngineClosed — no stranded waiters."""
        if self._closing.is_set():
            return False
        if req.deadline is not None and self._clock() >= req.deadline:
            return False
        with self._lock:
            respawning = sum(r.state == "respawning"
                             for r in self._replicas)
            if not respawning:
                return False
            req.parked = True
            self._parked.append(req)
            self._parks += 1
        self._obs_parks.inc(fleet=self.name)
        if req.trace is not None:
            req.trace.mark("parked", respawning=respawning)
        return True

    def _unpark(self, rep: _Replica | None = None,
                respawned: bool = False) -> None:
        """Re-dispatch every parked request (router thread only). A
        respawn that LANDED also clears the fresh replica from each
        parked request's exclusion set — the rebuilt engine is not the
        corpse the request fled. Requests that are still unroutable and
        still covered by another in-flight respawn simply park again;
        lapsed deadlines resolve TimeoutError inside ``_dispatch``."""
        with self._lock:
            parked, self._parked = self._parked, []
        for req in parked:
            req.parked = False
            if req.future.done():
                continue
            if respawned and rep is not None:
                req.excluded.discard(rep.idx)
            self._dispatch(req, block=True)

    def _note_failure(self, req: _FleetRequest, rep: _Replica,
                      exc: BaseException) -> None:
        """Account one replica failure against the request's bounded
        failover budget and schedule the replica health check."""
        req.excluded.add(rep.idx)
        req.last_error = exc
        req.failovers += 1
        if req.trace is not None:
            req.trace.hop(rep.idx, type(exc).__name__)
        if req.t_first_failure is None:
            req.t_first_failure = self._clock()
        with self._lock:
            self._failovers += 1
            respawning = sum(r.state == "respawning"
                             for r in self._replicas)
            rep_serving = rep.state == "serving"
        self._obs_failovers.inc(fleet=self.name)
        self._events.put(("check", rep))
        # the budget is respawn-aware:
        # hops burned while replicas are mid-rebuild are hops against a
        # fleet TEMPORARILY below strength, not against this request —
        # each respawn in flight widens the budget by one, and once the
        # rebuilds land (or give up) the configured bound is back
        if (rep_serving
                and req.failovers > self.config.max_failovers + respawning):
            # the corpse that just failed us may not have flipped to
            # "respawning" yet (its check event is queued, not yet
            # processed): peek at the engine so the budget widens on the
            # same failure that killed the replica, not one hop later
            try:
                if rep.engine.health().get("state") in ("failed", "closed"):
                    respawning += 1
            except Exception:  # noqa: BLE001 — a corpse that can't even
                respawning += 1  # report health is certainly dead
        if req.failovers > self.config.max_failovers + respawning:
            err = FailoverExhausted(
                f"FleetRouter[{self.name}] request exhausted its failover "
                f"budget ({self.config.max_failovers}); last error: {exc!r}")
            err.__cause__ = exc
            self._resolve(req, exc=err)

    @staticmethod
    def _resolve(req: _FleetRequest, value=None,
                 exc: BaseException | None = None) -> bool:
        """Resolve the caller's future exactly once. With hedging, the
        primary and the hedge copy race to this point from different
        resolver threads; the loser gets False and stands down."""
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(value)
            return True
        except InvalidStateError:
            return False

    @staticmethod
    def _cancel_losers(req: _FleetRequest, winner_idx: int) -> None:
        """Best-effort cancel of the losing placements of a resolved
        request: a still-queued duplicate is withdrawn before dispatch
        (``set_running_or_notify_cancel`` skips it); one already in a
        forward just completes into a done caller-future and is
        discarded on arrival."""
        for idx, inner in list(req.inners.items()):
            if idx != winner_idx and not inner.done():
                inner.cancel()

    def _on_replica_done(self, req: _FleetRequest, rep: _Replica,
                         f: Future, hedge: bool = False) -> None:
        """Classify one replica completion. Runs on whatever thread
        resolved the replica future — never blocks, never submits;
        failovers are handed to the router thread. With hedging a
        request can complete twice: first result wins, the duplicate is
        accounted (pending, per-replica latency) and dropped."""
        with self._lock:
            rep.pending -= 1
        if f.cancelled():
            return  # a withdrawn hedge loser; the winner already resolved
        exc = f.exception()
        dt = self._clock() - req.t_submit
        if exc is None:
            # per-replica latency tap — winners AND hedge losers: the
            # loser's slow completion is exactly the straggler signal
            # the outlier ejection scan feeds on
            with self._lock:
                rep.lat.append(dt)
        if req.future.done():
            return
        if exc is None:
            check = self.config.integrity_check
            if check is not None and not self._integrity_ok(check, f):
                with self._lock:
                    self._integrity_failures += 1
                self._obs_integrity.inc(fleet=self.name)
                bad = IntegrityViolation(
                    f"FleetRouter[{self.name}] replica {rep.idx} returned "
                    "a response failing the integrity check; failing over")
                self._note_failure(req, rep, bad)
                self._failover_or_ride_hedge(req, rep)
                return
            rep.consec_respawns = 0
            req.future.replica = rep.idx
            req.future.bucket = getattr(f, "bucket", None)
            if not self._resolve(req, value=f.result()):
                return  # lost the hedge race after the done-check
            if hedge:
                with self._lock:
                    self._hedge_wins += 1
                self._obs_hedge_wins.inc(fleet=self.name)
            self._cancel_losers(req, rep.idx)
            self._obs_request.observe(dt, engine=self.name, tier=req.tier)
            with self._lock:
                self._tier_lat[req.tier].append(dt)
            if req.t_first_failure is not None:
                lat = self._clock() - req.t_first_failure
                self._obs_failover_s.observe(lat, fleet=self.name)
                with self._lock:
                    self._failover_lat.append(lat)
        elif isinstance(exc, TimeoutError):
            # the deadline is the request's own: final wherever it expired
            self._resolve(req, exc=exc)
        elif isinstance(exc, PoisonedRequest):
            # the request's content fails the forward — retrying it on
            # another replica would just poison the whole fleet in turn
            with self._lock:
                self._poisoned += 1
            self._resolve(req, exc=exc)
        else:
            # replica died under the request (RestartsExhausted, closed,
            # or an unclassified engine error): failover with exclusion
            self._note_failure(req, rep, exc)
            self._failover_or_ride_hedge(req, rep)

    @staticmethod
    def _integrity_ok(check, f: Future) -> bool:
        try:
            return bool(check(f.result()))
        except Exception:  # noqa: BLE001 — a broken check must fail closed
            return False

    def _failover_or_ride_hedge(self, req: _FleetRequest,
                                rep: _Replica) -> None:
        """Queue a failover re-dispatch unless a sibling placement of
        this request is still in flight — the hedge IS the retry. If
        that sibling later fails too, its own completion callback sees
        this placement done and queues the failover then; the last
        sibling standing always either resolves the future or queues,
        so no waiter strands."""
        if req.future.done():
            return
        live = [i for idx, i in req.inners.items()
                if idx != rep.idx and not i.done()]
        if not live:
            self._events.put(("failover", req))

    # -- request hedging ---------------------------------------------------

    def _hedge_delay_s(self, tier: str) -> float:
        """The p99-derived hedge delay: duplicate only once the request
        is already past what a HEALTHY replica's slowest percentile
        would have taken — hedging the median request would double load
        for nothing (the tail-at-scale rule). The bar is the fastest
        serving replica's p99, not the pooled tier window: a browning
        replica drags the pooled p99 up to its own latency, so a pooled
        delay self-disables hedging exactly when it is needed (the
        duplicate would fire only after the straggler already blew the
        budget)."""
        floor = self.config.hedge_min_delay_s
        with self._lock:
            windows = [np.array(rep.lat, dtype=np.float64)
                       for rep in self._replicas
                       if rep.state == "serving" and len(rep.lat) >= 16]
            if not windows:
                pooled = self._tier_lat[tier]
                if len(pooled) < 16:
                    return floor
                windows = [np.array(pooled, dtype=np.float64)]
        p99 = min(float(np.percentile(w, 99)) for w in windows)
        return max(p99 * self.config.hedge_factor, floor)

    def _schedule_hedge(self, req: _FleetRequest) -> None:
        """Arm one hedge timer for a freshly placed request, subject to
        the rate cap: at most ``hedge_max_frac`` of submits may hedge, so
        a fleet-wide slowdown degrades into capped duplicate load
        instead of a self-inflicted doubling."""
        with self._lock:
            over_cap = (self._hedges + 1
                        > self.config.hedge_max_frac * max(self._submits, 1))
        if over_cap:
            return
        req.hedge_state = "scheduled"
        due = self._clock() + self._hedge_delay_s(req.tier)
        with self._hedge_cv:
            heapq.heappush(self._hedge_q, (due, next(self._hedge_seq), req))
            self._hedge_cv.notify()

    def _hedge_loop(self) -> None:
        """The hedger thread: pops due timers; a request still
        unresolved at its deadline gets a duplicate placement."""
        while not self._closing.is_set():
            with self._hedge_cv:
                if not self._hedge_q:
                    self._hedge_cv.wait(timeout=0.2)
                    continue
                due, _, req = self._hedge_q[0]
                now = self._clock()
                if due > now:
                    self._hedge_cv.wait(timeout=min(due - now, 0.05))
                    continue
                heapq.heappop(self._hedge_q)
            if not req.future.done():
                self._launch_hedge(req)

    def _launch_hedge(self, req: _FleetRequest) -> None:
        """Place the duplicate on a second replica (primary excluded).
        First result wins — ``_on_replica_done`` resolves exactly once
        and cancels the loser. A hedge that cannot place (one replica
        serving, replica full, closing) is silently dropped: hedging
        only ever adds a chance, never a failure mode."""
        if self._closing.is_set():
            return
        avoid = set() if req.placed is None else {req.placed}
        rep = self._pick(req, avoid)
        if rep is None or rep.idx == req.placed:
            return
        remaining = (None if req.deadline is None
                     else req.deadline - self._clock())
        if remaining is not None and remaining <= 0:
            return
        try:
            kw = {} if req.trace is None else {"trace": req.trace}
            inner = rep.engine.submit(req.packed, req.player, req.rank,
                                      timeout_s=remaining, block=False, **kw)
        except Exception:  # noqa: BLE001 — a failed hedge must stay silent
            return
        req.hedge_state = "launched"
        req.hedge_idx = rep.idx
        req.inners[rep.idx] = inner
        with self._lock:
            rep.pending += 1
            self._hedges += 1
        self._obs_hedges.inc(fleet=self.name, tier=req.tier)
        if req.trace is not None:
            req.trace.mark("hedged", replica=rep.idx)
        inner.add_done_callback(
            lambda f, rep=rep: self._on_replica_done(req, rep, f,
                                                     hedge=True))

    # -- the router thread -------------------------------------------------

    def _router_loop(self) -> None:
        ticks = 0
        while True:
            try:
                kind, payload = self._events.get(timeout=0.05)
            except queue.Empty:
                if self._closing.is_set():
                    return
                ticks += 1
                if ticks % 5 == 0:  # idle backstop: catch silent deaths
                    self._scan_replicas()
                continue
            if kind == "stop":
                return
            if kind == "failover":
                self._dispatch(payload, block=True)
            elif kind == "check":
                self._check_replica(payload)
            elif kind == "respawned":
                self._unpark(*payload)

    def _scan_replicas(self) -> None:
        for rep in self._replicas:
            self._check_replica(rep)
        if self.config.eject_stragglers:
            self._eject_outliers()
        self._update_breaker_gauge()
        self._unpark()  # deadline sweep for the parking lot

    def _check_replica(self, rep: _Replica) -> None:
        with self._lock:
            if rep.state != "serving":
                return
        try:
            state = rep.engine.health().get("state")
        except Exception:
            state = "failed"
        if state in ("failed", "closed") and not self._closing.is_set():
            with self._lock:
                if rep.state != "serving":
                    return
                rep.state = "respawning"
            self._update_serving_gauge()
            self._start_respawn(rep)

    def _start_respawn(self, rep: _Replica) -> None:
        """Spawn (and TRACK) one background respawn thread — close()
        joins the tracked set so a shutdown racing an in-flight rebuild
        neither hangs on it nor leaks its engine."""
        t = threading.Thread(target=self._respawn, args=(rep,),
                             name=f"fleet-{self.name}-respawn-{rep.idx}",
                             daemon=True)
        with self._lock:
            self._respawn_threads = [x for x in self._respawn_threads
                                     if x.is_alive()]
            self._respawn_threads.append(t)
        t.start()

    # -- gray-failure defenses: ejection + canary entry point --------------

    def eject_replica(self, idx: int, reason: str = "operator") -> bool:
        """Force one SERVING replica through the respawn path: placement
        stops immediately, in-flight requests on it fail over as its
        engine closes, and a fresh replica rejoins in the background.
        The recycling half of the gray-failure story — the latency
        outlier scan and an answer prober both land here. Returns False
        when the replica is not currently serving (already draining/
        respawning/failed) or the fleet is closing."""
        if not 0 <= idx < len(self._replicas):
            raise ValueError(f"replica {idx} not in fleet of "
                             f"{len(self._replicas)}")
        rep = self._replicas[idx]
        if self._closing.is_set():
            return False
        with self._lock:
            if rep.state != "serving":
                return False
            rep.state = "respawning"
            rep.lat.clear()
            rep.eject_strikes = 0
            self._ejections += 1
        self._update_serving_gauge()
        self._obs_ejections.inc(fleet=self.name, reason=reason)
        flight_dump("fleet_eject", fleet=self.name, replica=idx,
                    why=reason)
        if self._metrics is not None:
            self._metrics.write("fleet_eject", fleet=self.name,
                                replica=idx, reason=reason)
        self._start_respawn(rep)
        return True

    def _eject_outliers(self) -> None:
        """The straggler scan (router thread, idle ticks): a replica
        whose median completion latency exceeds ``eject_factor`` x the
        median of its PEERS — its own window excluded, so one straggler
        can't drag the baseline up to its own level — for
        ``eject_consecutive`` consecutive scans is recycled. Persistence
        gating keeps one GC pause or one unlucky batch from costing a
        respawn. On a heterogeneous fleet the baseline is SAME-PLATFORM
        peers only — a CPU surge replica is slower than its CUDA peers by
        design, not by gray failure, and a platform singleton (no peer to
        compare against) is never ejected for latency."""
        cfg = self.config
        with self._lock:
            meds = {rep.idx: float(np.median(np.array(rep.lat)))
                    for rep in self._replicas
                    if rep.state == "serving"
                    and len(rep.lat) >= cfg.eject_min_samples}
            plats = {rep.idx: getattr(rep.engine, "platform", None)
                     for rep in self._replicas}
        if len(meds) < 2:
            return
        for rep in self._replicas:
            mine = meds.get(rep.idx)
            if mine is None:
                continue
            peers = [v for k, v in meds.items()
                     if k != rep.idx and plats.get(k) == plats.get(rep.idx)]
            if not peers:
                rep.eject_strikes = 0
                continue
            base = float(np.median(np.array(peers)))
            if base > 0.0 and mine > cfg.eject_factor * base:
                rep.eject_strikes += 1
                if rep.eject_strikes >= cfg.eject_consecutive:
                    self.eject_replica(rep.idx, reason="straggler")
            else:
                rep.eject_strikes = 0

    _BREAKER_VALUE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

    def _update_breaker_gauge(self) -> None:
        """Republish each replica's CircuitBreaker.snapshot() as the
        ``deepgo_fleet_breaker_state`` gauge (0 closed / 1 half-open /
        2 open) so breaker flaps reach the watchlist and dash, not just
        health()."""
        for rep in self._replicas:
            snap_fn = getattr(rep.engine, "breaker_snapshot", None)
            if snap_fn is None:
                continue
            try:
                state = (snap_fn() or {}).get("state")
            except Exception:  # noqa: BLE001 — a corpse mid-respawn
                continue
            self._obs_breaker.set(
                self._BREAKER_VALUE.get(state, 0.0),
                fleet=self.name, replica=str(rep.idx))

    def _respawn(self, rep: _Replica) -> None:
        """Background rebuild of one dead replica: bounded consecutive
        attempts with full-jitter backoff; the fleet keeps serving on the
        survivors the whole time."""
        flight_dump("fleet_respawn", fleet=self.name, replica=rep.idx,
                    consec=rep.consec_respawns + 1)
        while not self._closing.is_set():
            rep.consec_respawns += 1
            if rep.consec_respawns > self.config.max_respawns:
                with self._lock:
                    rep.state = "failed"
                self._update_serving_gauge()
                if self._metrics is not None:
                    self._metrics.write(
                        "fleet_replica_failed", fleet=self.name,
                        replica=rep.idx, respawns=rep.respawns)
                # a respawn giving up still wakes the parking lot: with
                # no rebuild left in flight the parked requests resolve
                # their typed exhaustion instead of waiting for a tick
                self._events.put(("respawned", (rep, False)))
                return
            # backoff waits on the closing event, not a bare sleep, so a
            # concurrent close() interrupts the wait instead of hanging
            # its join on a full backoff cap
            self._closing.wait(full_jitter_delay(
                rep.consec_respawns - 1, self.config.respawn_base_s,
                self.config.respawn_cap_s, self._rng))
            try:
                rep.engine.close(drain=False, timeout=1.0)
            except Exception:  # pragma: no cover — corpse cleanup only
                pass
            try:
                eng = self._make_replica(rep.idx)
                if self._current_params is not None:
                    self._apply_params(eng, self._current_params)
                if self.config.warm_on_respawn:
                    eng.warmup()
            except Exception:
                continue  # burns one consecutive-respawn budget slot
            if self._closing.is_set():
                try:
                    eng.close(drain=False, timeout=1.0)
                except Exception:
                    pass
                return
            with self._lock:
                rep.engine = eng
                rep.state = "serving"
                rep.respawns += 1
                rep.lat.clear()       # a fresh engine starts a fresh window
                rep.eject_strikes = 0
                self._respawns += 1
                total = self._respawns
            self._update_serving_gauge()
            self._obs_respawns.inc(fleet=self.name)
            if self._metrics is not None:
                self._metrics.write("fleet_respawn", fleet=self.name,
                                    replica=rep.idx,
                                    attempt=rep.consec_respawns,
                                    total_respawns=total)
            # the landed respawn re-dispatches the parking lot, and the
            # fresh engine gets a clean slate in each parked request's
            # exclusion set (it is not the corpse the request fled)
            self._events.put(("respawned", (rep, True)))
            return

    # -- hot weight reload -------------------------------------------------

    def reload(self, new_params, drain_timeout_s: float | None = None
               ) -> dict:
        """Roll new weights through the fleet, one replica at a time.

        ``new_params`` is a model of the serving model's class and
        config, or a checkpoint path, read with the port's
        ``experiments/checkpoint.py`` into a fresh module of the current
        params' class and config on their device; each replica's
        ``prepare_params`` then places or re-prepares it for its own
        device and variant. Protocol per replica: drain (placement skips
        it; in-flight requests finish on the weights they were submitted
        under), reference swap, rejoin — so in-flight
        futures never drop and capacity never dips below N-1. Replicas
        mid-respawn are skipped: the respawn itself applies the new
        weights, as does every later supervisor restart (the
        ``set_params`` override). Returns ``{"replicas": swapped,
        "seconds": wall}``. Concurrent reloads serialize."""
        self._check_alive()
        with self._reload_mutex:
            params = self._resolve_params(new_params)
            t0 = self._clock()
            # from this instant every respawn/rebuild converges on the
            # new weights, even for replicas the roll hasn't reached yet
            self._current_params = params
            # stale-weights answers are wrong answers: clear BEFORE the
            # roll (old-weights entries must not outlive the moment the
            # new checkpoint became the source of truth) and AFTER it
            # (forwards that ran mid-roll on a not-yet-swapped replica
            # filled under the new generation — legitimate old-or-new
            # answers while rolling, stale the instant the roll is done).
            # Generation capture in the cache refuses fills from flights
            # led before each clear, so no mixed-weights row survives.
            if self.cache is not None:
                self.cache.invalidate("reload_start")
            budget = (self.config.drain_timeout_s
                      if drain_timeout_s is None else drain_timeout_s)
            swapped = 0
            try:
                for rep in self._replicas:
                    if self._closing.is_set():
                        raise EngineClosed(
                            f"FleetRouter[{self.name}] closed mid-reload "
                            f"({swapped} replica(s) already swapped)")
                    with self._lock:
                        if rep.state != "serving":
                            continue  # respawn path applies the new weights
                        rep.state = "draining"
                    self._update_serving_gauge()
                    try:
                        deadline = self._clock() + budget
                        while (rep.pending > 0 and self._clock() < deadline
                               and not self._closing.is_set()):
                            self._sleep(0.002)
                        try:
                            faults.check("fleet_reload")
                        except faults.FaultError as e:
                            raise FleetReloadError(
                                f"FleetRouter[{self.name}] reload failed at "
                                f"replica {rep.idx} ({swapped} already "
                                "swapped; restarts/respawns will converge on "
                                "the new weights)") from e
                        self._apply_params(rep.engine, params)
                        swapped += 1
                    finally:
                        with self._lock:
                            if rep.state == "draining":
                                rep.state = "serving"
                        self._update_serving_gauge()
            finally:
                if self.cache is not None:
                    self.cache.invalidate("reload_end")
            dt = self._clock() - t0
            with self._lock:
                self._reloads += 1
            self._obs_reloads.inc(fleet=self.name)
            if self._metrics is not None:
                self._metrics.write("fleet_reload", fleet=self.name,
                                    replicas=swapped,
                                    seconds=round(dt, 4))
            return {"replicas": swapped, "seconds": dt}

    @staticmethod
    def _apply_params(engine, base_params) -> None:
        """Swap BASE params into one replica, through its variant's
        ``prepare_params`` hook when it carries one (an int8 replica
        re-quantizes the new checkpoint; an f32 replica takes it as
        is) — the single point reload and respawn share, so a variant
        replica can never be handed the raw f32 tree by one path and
        the prepared one by the other."""
        prepare = getattr(engine, "prepare_params", None)
        engine.set_params(prepare(base_params) if prepare is not None
                          else base_params)

    def _resolve_params(self, new):
        if isinstance(new, (str, os.PathLike)):
            from ..experiments import checkpoint as ckpt

            path = str(new)
            template = self._current_params
            if template is None:
                template = self._replicas[0].engine.params
            return ckpt.load_model_like(template, path)
        return new

    # -- observability -----------------------------------------------------

    def _serving_count(self) -> int:
        with self._lock:
            return sum(r.state == "serving" for r in self._replicas)

    _STATE_VALUE = {"serving": 1.0, "draining": 0.5, "respawning": 0.5,
                    "failed": 0.0}

    def _update_serving_gauge(self) -> None:
        self._obs_serving.set(self._serving_count(), fleet=self.name)
        with self._lock:
            states = [(r.idx, r.state) for r in self._replicas]
        for idx, state in states:
            self._obs_replica_state.set(
                self._STATE_VALUE.get(state, 0.0),
                fleet=self.name, replica=str(idx))

    def _count_shed(self, tier: str, reason: str) -> None:
        with self._lock:
            self._shed[tier] += 1
        self._obs_shed.inc(fleet=self.name, tier=tier, reason=reason)

    def _counters(self) -> dict:
        with self._lock:
            return {
                "failovers": self._failovers,
                "respawns": self._respawns,
                "reloads": self._reloads,
                "poisoned": self._poisoned,
                "hedges": self._hedges,
                "hedge_wins": self._hedge_wins,
                "ejections": self._ejections,
                "integrity_failures": self._integrity_failures,
                "parks": self._parks,
                "shed": dict(self._shed),
            }

    def probe_targets(self) -> list:
        """(idx, engine) for every SERVING replica — a prober's
        placement-pinned view (it submits directly to each engine,
        bypassing placement, so a corrupt replica can't hide behind a
        healthy peer)."""
        with self._lock:
            return [(r.idx, r.engine) for r in self._replicas
                    if r.state == "serving"]

    def _tier_latency(self) -> dict:
        out = {}
        with self._lock:
            snap = {t: list(lat) for t, lat in self._tier_lat.items()}
        for tier, lat in snap.items():
            arr = np.array(lat, dtype=np.float64)
            out[tier] = {
                "requests": int(arr.size),
                "p50_ms": round(float(np.percentile(arr, 50)) * 1000, 3)
                if arr.size else None,
                "p99_ms": round(float(np.percentile(arr, 99)) * 1000, 3)
                if arr.size else None,
            }
        return out

    def health(self) -> dict:
        """One snapshot of the whole fleet. ``state`` is strict on
        purpose: "serving" only at FULL strength, "degraded" while any
        replica is down-but-covered, "down" below ``min_serving`` — so a
        composed /healthz (health_from_engine) flips 503 the moment a
        replica dies and back to 200 when the respawn lands, and an
        orchestrator watching the endpoint sees the incident even though
        the fleet absorbed it."""
        with self._lock:
            reps = list(self._replicas)
        detail = []
        serving = 0
        for r in reps:
            entry = {"replica": r.idx, "state": r.state,
                     "pending": r.pending, "respawns": r.respawns}
            variant = getattr(r.engine, "variant", None)
            if variant is not None:
                entry["variant"] = variant
            platform = getattr(r.engine, "platform", None)
            if platform is not None:
                entry["platform"] = platform
                realized = getattr(r.engine, "platform_realized", None)
                if realized is not None:
                    entry["platform_realized"] = realized
            if r.state in ("serving", "draining"):
                try:
                    h = r.engine.health()
                except Exception as e:  # noqa: BLE001 — reported inline
                    entry["error"] = repr(e)
                    h = {"state": "failed"}
                entry["engine_state"] = h.get("state")
                entry["breaker"] = (h.get("breaker") or {}).get("state")
                entry["estimated_wait_s"] = h.get("estimated_wait_s")
                # a DRAINING replica still counts as healthy: a planned
                # sub-second reload drain is not an incident, and /healthz
                # must flip 503 for deaths, not for rolling upgrades
                if h.get("state") == "serving":
                    serving += 1
            detail.append(entry)
        if self._closing.is_set():
            state = "closed"
        elif serving == len(reps):
            state = "serving"
        elif serving >= self.config.min_serving:
            state = "degraded"
        else:
            state = "down"
        out = {"state": state, "replicas_serving": serving,
               "replicas_total": len(reps),
               "estimated_wait_s": self.estimated_wait_s(),
               "tiers": self._tier_latency(), "replicas": detail}
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        out.update(self._counters())
        return out

    def stats(self) -> dict:
        """Per-replica engine stats plus a ``fleet`` block, so existing
        consumers surface the fleet counters without a second call
        site."""
        with self._lock:
            reps = list(self._replicas)
        replica_stats = []
        boards = 0
        for r in reps:
            try:
                s = r.engine.stats()
            except Exception as e:  # noqa: BLE001 — a corpse mid-respawn
                s = {"error": repr(e)}
            s["replica"] = r.idx
            s["state"] = r.state
            variant = getattr(r.engine, "variant", None)
            if variant is not None:
                s["variant"] = variant
            platform = getattr(r.engine, "platform", None)
            if platform is not None:
                s["platform"] = platform
            boards += s.get("boards") or 0
            replica_stats.append(s)
        with self._lock:
            failover_lat = list(self._failover_lat)
        fleet = self._counters()
        if self.cache is not None:
            fleet["cache"] = self.cache.stats()
        fleet.update({
            "replicas_serving": self._serving_count(),
            "replicas_total": len(reps),
            "boards": boards,
            "tiers": self._tier_latency(),
            "failover_p50_ms": round(float(np.percentile(
                np.array(failover_lat), 50)) * 1000, 3)
            if failover_lat else None,
        })
        return {"fleet": fleet, "replicas": replica_stats,
                "boards": boards}
