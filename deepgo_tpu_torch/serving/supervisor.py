"""SupervisedEngine: the resilience layer over the micro-batching engine.

The port of ``deepgo_tpu/serving/supervisor.py``. Training treats failure
as the steady state (atomic checkpoints, DEEPGO_FAULTS, auto-resume); this
module does the same for *serving*. A bare ``InferenceEngine`` has three
production gaps:

  1. a dispatcher-thread death is permanent — ``_check_alive`` re-raises
     forever, so one crash takes the engine down for every later caller;
  2. a single poisoned request fails every coalesced neighbor that
     happened to ride its dispatch;
  3. an overloaded queue makes no admission decision beyond blocking or
     ``EngineBusy`` — requests that can no longer meet their deadline
     still consume a dispatch slot, then time out anyway.

``SupervisedEngine`` wraps an engine *factory* (not an engine) and closes
all three:

  restart   dispatcher death is detected (on a failed future or a failed
            submit), the corpse is torn down, and a fresh engine is built
            after a bounded-exponential full-jitter backoff
            (resilience.full_jitter_delay). In-flight requests whose
            deadline is still live are REPLAYED on the new engine — the
            forward is pure, so replay is idempotent and submitters ride
            through the restart untouched, with bit-identical results.
  poison    a failed coalesced dispatch (engine.BatchDispatchError) is
            bisected through the engine's solo lane: every member retries
            strictly alone, so a bad row fails alone while its neighbors
            succeed. A request that keeps failing alone
            (``poison_threshold`` lone failures) is declared poison: its
            future gets a typed PoisonedRequest and its inputs are dumped
            atomically to ``quarantine_dir`` (training's bad_batch
            discipline, applied to serving).
  breaker   every dispatch failure / engine death feeds a closed/open/
            half-open circuit breaker (resilience.CircuitBreaker). A
            persistently failing device flips it open and submit() sheds
            instantly with CircuitOpen instead of timing every caller
            out; one probe per ``breaker_reset_s`` closes it again.
  shedding  deadline-aware admission control: when the estimated queue
            wait (rolling p50 dispatch latency x pending dispatch
            windows) already exceeds a request's deadline, submit()
            rejects with EngineOverloaded up front — the caller learns in
            microseconds what the queue would have told it at its
            deadline.

The contract the tests assert: every submitted future RESOLVES —
success, typed shed, typed poison, or typed restart-budget exhaustion —
never strands. Clock, sleep, and RNG are injectable so every backoff
bound and breaker transition is testable without wall time. A resolved
future carries ``bucket``, the rung its row was dispatched on.

What a restart can and cannot clear on the card. Every failure this layer
absorbs is a Python exception raised at a fault site or by the forward: a
dead dispatcher thread, a failed batch. A rebuilt engine runs the same
forward in the same CUDA context. A sticky CUDA error (an illegal memory
access, a device-side assert) poisons that whole context: every later
launch and copy in the process fails, so the restarted engine fails too,
restart after restart, until ``max_restarts`` gives up with
``RestartsExhausted``. Only a new process clears it. The injected faults
(``utils/faults.py``) are all Python exceptions, never device faults.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import random
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..analysis.lockcheck import make_lock
from ..obs import get_registry
from ..obs.sentinel import flight_dump
from .engine import (BatchDispatchError, EngineBusy, EngineClosed,
                     EngineError, InferenceEngine)
from .resilience import (CircuitBreaker, CircuitOpen, EngineOverloaded,
                         PoisonedRequest, RestartsExhausted,
                         full_jitter_delay)


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Knobs for one SupervisedEngine.

    ``max_restarts`` bounds CONSECUTIVE rebuilds (any served request
    resets the count): a permanently broken device must eventually fail
    loudly, not restart forever. ``poison_threshold`` is how many times a
    request must fail ALONE before it is declared poison rather than the
    victim of transient weather (2+ keeps a one-shot transient from
    condemning an innocent request)."""

    max_restarts: int = 8
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    breaker_failures: int = 5
    breaker_reset_s: float = 30.0
    poison_threshold: int = 2
    admission_control: bool = True
    warm_on_restart: bool = False
    quarantine_dir: str | None = None


class _SupRequest:
    __slots__ = ("packed", "player", "rank", "deadline", "future",
                 "solo", "solo_failures", "trace", "workload")

    def __init__(self, packed, player, rank, deadline, trace=None,
                 workload=None):
        self.packed = packed
        self.player = player
        self.rank = rank
        self.deadline = deadline          # absolute, supervisor clock
        self.future: Future = Future()
        self.solo = False                 # isolation-lane retry
        self.solo_failures = 0            # times it failed dispatching alone
        self.trace = trace                # TraceContext riding every retry
        self.workload = workload          # WorkloadToken, same discipline


class SupervisedEngine:
    """One engine factory, one supervisor thread, many resilient callers.

    Duck-types the InferenceEngine surface every consumer uses (submit /
    evaluate / warmup / stats / compile_cache_size / close / context
    manager), so selfplay fleets, arena agents, and the shared-engine
    registry ride it unchanged.
    """

    def __init__(self, factory, config: SupervisorConfig | None = None,
                 name: str = "supervised", metrics=None,
                 clock=time.monotonic, sleep=time.sleep, rng=None):
        """``factory() -> InferenceEngine`` builds (and rebuilds) the inner
        engine. Build the forward ONCE outside the factory and close over
        it, as ``serving.supervised_policy_engine`` does: a restart then
        reuses it and its weights."""
        self.config = config or SupervisorConfig()
        self.name = name
        self._factory = factory
        self._metrics = metrics
        self._clock = clock
        self._sleep = sleep
        # lint: allow[determinism] backoff jitter only — replay-bearing results never depend on it; tests inject rng=
        self._rng = rng if rng is not None else random.Random()
        self._lock = make_lock(f"supervisor.{name}")
        self._breaker = CircuitBreaker(
            self.config.breaker_failures, self.config.breaker_reset_s,
            clock=clock, on_transition=self._on_breaker_transition,
            name=f"breaker.{name}")
        self._events: queue.Queue = queue.Queue()
        self._replay: list[_SupRequest] = []
        self._restarts = 0
        self._consec_restarts = 0
        self._replayed = 0
        self._shed_overload = 0
        self._shed_breaker = 0
        self._poisoned = 0
        self._quarantined: list[str] = []
        self._closing = threading.Event()
        self._failed: EngineError | None = None
        self._params_override = None      # set_params survives restarts
        # resilience aggregates on the process registry: the counters
        # /metrics serves live and health() already snapshots. Breaker
        # state renders as a gauge (0 closed / 1 half-open / 2 open) so
        # a scrape sees the transition, not just its transition count.
        reg = get_registry()
        self._obs_restarts = reg.counter(
            "deepgo_serving_restarts_total", "engine rebuilds after death")
        self._obs_shed = reg.counter(
            "deepgo_serving_shed_total",
            "requests shed at admission (reason=overload|breaker)")
        self._obs_poisoned = reg.counter(
            "deepgo_serving_poisoned_total",
            "requests declared poison after isolated failures")
        self._obs_replayed = reg.counter(
            "deepgo_serving_replayed_total",
            "in-flight requests replayed onto a fresh engine")
        self._obs_breaker = reg.gauge(
            "deepgo_serving_breaker_state",
            "circuit breaker state (0 closed, 1 half-open, 2 open)")
        self._obs_breaker.set(0, engine=name)
        self._engine = factory()
        self._thread = threading.Thread(
            target=self._supervise_loop, name=f"supervisor-{name}",
            daemon=True)
        self._thread.start()

    # -- lifecycle ---------------------------------------------------------

    def warmup(self) -> int:
        return self._engine.warmup()

    def compile_cache_size(self) -> int | None:
        return self._engine.compile_cache_size()

    @property
    def params(self):
        """The weights the CURRENT inner engine dispatches with."""
        return self._engine.params

    def set_params(self, params) -> None:
        """Hot-swap weights through the supervision layer.

        Forwards the pointer swap to the live inner engine AND pins the
        override for every future restart: the factory closure was built
        over the original weights, so without the override a post-reload
        dispatcher death would silently resurrect the old checkpoint."""
        self._params_override = params
        self._engine.set_params(params)

    @property
    def ladder(self):
        return self._engine.ladder

    def _check_alive(self) -> None:
        if self._failed is not None:
            raise RestartsExhausted(
                f"SupervisedEngine[{self.name}] gave up: {self._failed}"
            ) from self._failed
        if self._closing.is_set():
            raise EngineClosed(f"SupervisedEngine[{self.name}] is closed")

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop supervising and shut the inner engine down.

        Same contract as InferenceEngine.close(): returns with every
        outstanding future resolved — drained results, or typed
        EngineClosed — never stranded waiters."""
        self._closing.set()
        self._events.put(("stop", None))
        self._thread.join(timeout=timeout)
        self._engine.close(drain=drain, timeout=timeout)
        # anything the loop left behind (parked replays, queued retries)
        # must not strand its waiters
        with self._lock:
            leftovers, self._replay = self._replay, []
        while True:
            try:
                kind, payload = self._events.get_nowait()
            except queue.Empty:
                break
            if kind == "retry":
                leftovers.append(payload)
        exc = EngineClosed(
            f"SupervisedEngine[{self.name}] closed with request pending")
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(exc)
        if self._metrics is not None:
            self._metrics.write("serving_supervisor_close", engine=self.name,
                                **self._health_counters())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- submission --------------------------------------------------------

    def submit(self, packed: np.ndarray, player: int, rank: int,
               timeout_s: float | None = None, block: bool = True,
               trace=None, workload=None) -> Future:
        """Queue one board; returns a Future that ALWAYS resolves.

        Outcomes: the result row (possibly after transparent engine
        restarts and replays); TimeoutError (deadline expired);
        EngineOverloaded (admission control shed it at the door);
        CircuitOpen (breaker shedding a persistently failing engine);
        PoisonedRequest (this request fails the forward on its own);
        EngineBusy (non-blocking submit, queue full). ``trace`` is the
        caller's TraceContext; the SAME id rides every restart replay
        and isolation retry (obs/tracing.py)."""
        self._check_alive()
        engine = self._engine
        if timeout_s is None:
            timeout_s = engine.config.timeout_s
        if timeout_s is not None and self.config.admission_control:
            est = self.estimated_wait_s()
            if est is not None and est > timeout_s:
                with self._lock:
                    self._shed_overload += 1
                self._obs_shed.inc(engine=self.name, reason="overload")
                raise EngineOverloaded(
                    f"SupervisedEngine[{self.name}] estimated queue wait "
                    f"{est:.3f}s exceeds the request deadline {timeout_s}s "
                    "(deadline-aware shed)")
        if not self._breaker.allow():
            with self._lock:
                self._shed_breaker += 1
            self._obs_shed.inc(engine=self.name, reason="breaker")
            raise CircuitOpen(
                f"SupervisedEngine[{self.name}] circuit breaker is "
                f"{self._breaker.state}: engine failing persistently, "
                "shedding instead of queueing")
        # trace creation sits BEHIND the door sheds: a shed raise is its
        # own answer; timelines trace requests that entered the system
        owned = None
        if trace is None:
            from ..obs import tracing

            trace = owned = tracing.start_request(engine=self.name)
        wl_owned = None
        if workload is None:
            from ..obs import workload as workload_mod

            workload = wl_owned = workload_mod.note_request(
                packed, player, rank, engine=self.name)
        deadline = None if timeout_s is None else self._clock() + timeout_s
        req = _SupRequest(np.asarray(packed), int(player), int(rank),
                          deadline, trace=trace, workload=workload)
        if owned is not None:
            req.future.add_done_callback(owned.finish_future)
        if wl_owned is not None:
            req.future.add_done_callback(wl_owned.finish_future)
        try:
            self._submit_inner(req, block=block)
        except EngineBusy:
            # the breaker may have granted THE half-open probe to this
            # submit; a request that never went out must hand it back
            self._breaker.cancel_probe()
            if owned is not None:
                owned.finish("error", error="EngineBusy")
            if wl_owned is not None:
                wl_owned.finish("shed")
            raise
        return req.future

    def evaluate(self, packed: np.ndarray, players: np.ndarray,
                 ranks: np.ndarray, timeout_s: float | None = None
                 ) -> np.ndarray:
        """Blocking convenience, same shape as InferenceEngine.evaluate."""
        futures = [self.submit(packed[i], int(players[i]), int(ranks[i]),
                               timeout_s=timeout_s)
                   for i in range(len(packed))]
        return np.stack([f.result() for f in futures])

    def estimated_wait_s(self) -> float | None:
        """Admission control's load estimate: rolling p50 FULL-window
        dispatch latency x pending dispatch windows (queue depth / top
        bucket, rounded up) — the backlog drains in max-bucket windows,
        so their cost is the right multiplier even when small
        interactive dispatches dominate the recent mix. None until the
        first dispatch has been measured."""
        engine = self._engine
        p50 = engine.window_p50_s()
        if p50 is None:
            return None
        depth = engine.queue_depth()
        windows = -(-depth // engine.ladder.max_bucket)  # ceil div
        return p50 * windows

    def _submit_inner(self, req: _SupRequest, block: bool = True) -> None:
        """Hand one request to the current inner engine.

        A dead/closing engine parks the request for post-restart replay
        instead of failing it; only EngineBusy (explicit non-blocking
        backpressure) propagates."""
        engine = self._engine
        remaining = None
        if req.deadline is not None:
            remaining = req.deadline - self._clock()
            if remaining <= 0:
                if not req.future.done():
                    req.future.set_exception(TimeoutError(
                        f"request deadline expired before dispatch in "
                        f"SupervisedEngine[{self.name}]"))
                return
        try:
            inner = engine.submit(req.packed, req.player, req.rank,
                                  timeout_s=remaining, block=block,
                                  solo=req.solo, trace=req.trace,
                                  workload=req.workload)
        except EngineBusy:
            raise
        except EngineError:
            # dispatcher dead or engine closing under us: park + wake the
            # supervisor; the caller's future resolves after the replay
            self._park(req, engine)
            return
        inner.add_done_callback(
            lambda f, eng=engine: self._on_inner_done(req, f, eng))

    def _park(self, req: _SupRequest, engine: InferenceEngine) -> None:
        with self._lock:
            self._replay.append(req)
        self._events.put(("died", engine))

    # -- completion classification ----------------------------------------

    def _on_inner_done(self, req: _SupRequest, f: Future,
                       engine: InferenceEngine) -> None:
        """Classify one inner-engine completion.

        Runs on whatever thread resolved the inner future (dispatcher,
        closer, or supervisor) — so it never blocks and never submits;
        retries and restarts are handed to the supervisor thread."""
        exc = f.exception()
        if req.future.done():
            if exc is None:
                self._breaker.record_success()
            return
        if exc is None:
            self._breaker.record_success()
            with self._lock:
                self._consec_restarts = 0
            req.future.bucket = getattr(f, "bucket", None)
            req.future.set_result(f.result())
        elif isinstance(exc, TimeoutError):
            # the deadline expired in the queue: a final, typed outcome
            req.future.set_exception(exc)
        elif isinstance(exc, BatchDispatchError):
            self._breaker.record_failure()
            if exc.batch_size == 1:
                req.solo_failures += 1
            if req.solo_failures >= self.config.poison_threshold:
                self._declare_poison(req, exc)
            else:
                req.solo = True  # bisect: retry strictly alone
                if req.trace is not None:
                    req.trace.mark("isolated", engine=self.name,
                                   failures=req.solo_failures)
                self._events.put(("retry", req))
        else:
            # raw error = dispatcher death (or closed under the request):
            # the members are innocent, the engine is the casualty
            self._park(req, engine)

    def _declare_poison(self, req: _SupRequest, exc: BaseException) -> None:
        with self._lock:
            self._poisoned += 1
            n = self._poisoned
        self._obs_poisoned.inc(engine=self.name)
        path = self._quarantine(req, exc, n)
        if self._metrics is not None:
            self._metrics.write("serving_poison", engine=self.name,
                                error=repr(exc.__cause__ or exc), path=path)
        err = PoisonedRequest(
            f"request fails the forward on its own ({req.solo_failures} "
            f"isolated attempts) in SupervisedEngine[{self.name}]"
            + (f"; inputs quarantined at {path}" if path else ""))
        err.__cause__ = exc
        req.future.set_exception(err)

    def _quarantine(self, req: _SupRequest, exc: BaseException,
                    n: int) -> str | None:
        """Atomic postmortem dump of the poisoned inputs — training's
        bad_batch discipline applied to serving. Returns the path, or
        None when no quarantine_dir is configured (or the dump itself
        fails: the postmortem must never mask the poison verdict)."""
        if not self.config.quarantine_dir:
            return None
        from ..utils.atomicio import atomic_write

        path = os.path.join(self.config.quarantine_dir,
                            f"poison-{n:04d}.npz")
        try:
            os.makedirs(self.config.quarantine_dir, exist_ok=True)
            with atomic_write(path) as fh:
                np.savez(fh, packed=req.packed,
                         player=np.int32(req.player),
                         rank=np.int32(req.rank),
                         error=np.array(repr(exc.__cause__ or exc)))
        except OSError:
            return None
        with self._lock:
            self._quarantined.append(path)
        return path

    # -- the supervisor thread ---------------------------------------------

    def _supervise_loop(self) -> None:
        while True:
            try:
                kind, payload = self._events.get(timeout=0.05)
            except queue.Empty:
                if self._closing.is_set():
                    return
                continue
            if kind == "stop":
                return
            if kind == "retry":
                if self._failed is not None:
                    if not payload.future.done():
                        payload.future.set_exception(self._failed)
                else:
                    self._submit_inner(payload, block=True)
            elif kind == "died":
                self._handle_death(payload)

    def _handle_death(self, dead: InferenceEngine) -> None:
        if self._failed is not None or self._closing.is_set():
            self._flush_replay()
            return
        if dead is self._engine:
            self._breaker.record_failure()
            with self._lock:
                self._restarts += 1
                self._consec_restarts += 1
                attempt = self._consec_restarts
            self._obs_restarts.inc(engine=self.name)
            # ship the black box with the incident: the ring buffer holds
            # the dispatch latencies and spans that preceded the death
            # (a no-op unless obs.sentinel.configure_flight armed it)
            flight_dump("serving_restart", engine=self.name,
                        attempt=attempt, total_restarts=self._restarts)
            if attempt > self.config.max_restarts:
                self._give_up(RestartsExhausted(
                    f"SupervisedEngine[{self.name}] engine died "
                    f"{attempt} times without serving a request in "
                    f"between (max_restarts={self.config.max_restarts})"))
                return
            delay = full_jitter_delay(
                attempt - 1, self.config.backoff_base_s,
                self.config.backoff_cap_s, self._rng)
            if self._metrics is not None:
                self._metrics.write(
                    "serving_restart", engine=self.name, attempt=attempt,
                    delay_s=round(delay, 4), total_restarts=self._restarts)
            self._sleep(delay)
            # tear the corpse down WITHOUT draining: its queued requests
            # fail with EngineClosed, which the done-callbacks classify as
            # engine death and park for replay below
            try:
                dead.close(drain=False, timeout=1.0)
            except Exception:  # pragma: no cover — corpse cleanup only
                pass
            if self._closing.is_set():
                self._flush_replay()
                return
            self._engine = self._factory()
            if self._params_override is not None:
                self._engine.set_params(self._params_override)
            if self.config.warm_on_restart:
                self._engine.warmup()
        # stale death notice (engine already replaced) still flushes: late
        # parks from the old corpse's callbacks land in the same list
        self._flush_replay()

    def _flush_replay(self) -> None:
        with self._lock:
            reqs, self._replay = self._replay, []
        err = self._failed or (
            EngineClosed(f"SupervisedEngine[{self.name}] closed with "
                         "request pending")
            if self._closing.is_set() else None)
        for req in reqs:
            if req.future.done():
                continue
            if err is not None:
                req.future.set_exception(err)
                continue
            with self._lock:
                self._replayed += 1
            self._obs_replayed.inc(engine=self.name)
            if req.trace is not None:
                req.trace.mark("replayed", engine=self.name)
            self._submit_inner(req, block=True)

    def _give_up(self, err: RestartsExhausted) -> None:
        with self._lock:
            self._failed = err
        if self._metrics is not None:
            self._metrics.write("serving_supervisor_failed",
                                engine=self.name, error=str(err))
        self._flush_replay()

    # -- observability -----------------------------------------------------

    def _on_breaker_transition(self, old: str, new: str) -> None:
        self._obs_breaker.set(
            {"closed": 0, "half_open": 1, "open": 2}.get(new, -1),
            engine=self.name)
        if self._metrics is not None:
            self._metrics.write("serving_breaker", engine=self.name,
                                from_state=old, to_state=new)

    def _health_counters(self) -> dict:
        with self._lock:
            return {
                "restarts": self._restarts,
                "consecutive_restarts": self._consec_restarts,
                "replayed": self._replayed,
                "shed_overload": self._shed_overload,
                "shed_breaker": self._shed_breaker,
                "poisoned": self._poisoned,
                "quarantined": list(self._quarantined),
            }

    def breaker_snapshot(self) -> dict:
        """The circuit breaker's state dict (state / consecutive_failures
        / transitions) — the fleet router republishes it per replica as
        the ``deepgo_fleet_breaker_state`` gauge, so breaker flaps are
        telemetry, not just a ``health()`` field."""
        return self._breaker.snapshot()

    def health(self) -> dict:
        """One snapshot of the whole resilience layer: supervisor state,
        breaker state, restart/shed/poison counters, the load estimate,
        and the inner engine's own stats()."""
        state = ("failed" if self._failed is not None
                 else "closed" if self._closing.is_set() else "serving")
        out = {"state": state, "breaker": self._breaker.snapshot(),
               "estimated_wait_s": self.estimated_wait_s()}
        out.update(self._health_counters())
        out["engine"] = self._engine.stats()
        return out

    def stats(self) -> dict:
        """The inner engine's stats() plus a ``supervisor`` block, so
        existing consumers surface resilience counters without a second
        call site."""
        s = self._engine.stats()
        s["supervisor"] = self._health_counters()
        s["supervisor"]["breaker"] = self._breaker.snapshot()["state"]
        return s
