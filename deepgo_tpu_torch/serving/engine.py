"""Micro-batching inference engine: futures in, one padded dispatch out.

The port of ``deepgo_tpu/serving/engine.py``. Callers submit single-board
requests and get ``concurrent.futures.Future``s. A dispatcher thread
coalesces up to ``max_bucket`` requests or ``max_wait_ms``, pads the batch
onto the bucket ladder (buckets.py), runs ONE forward, and scatters result
rows back to the futures. The queue is bounded (backpressure), requests
carry optional deadlines, a failed forward fails only its own batch
(``BatchDispatchError``), and dispatcher death surfaces on the next
``submit()``. Each resolved future carries ``bucket``, the rung its
request dispatched on.

Numerics of batching under PyTorch. The forward is row-independent, so
within one rung a request's row is bitwise the same whichever requests
rode with it: one batch shape runs one sequence of kernels (with
``torch.backends.cudnn.benchmark`` False, PyTorch's default, cuDNN picks
its algorithm from the shape alone). Across rungs that does not hold as it
does under XLA: cuDNN may pick another convolution algorithm for another
batch size, which sums in another order, so the same board's row may
differ between rungs by rounding. ``chip_smoke.py`` holds engine rows
bitwise against the direct forward at the same rung and states the
tolerance it holds them to across rungs.

The taps the resilience layers read, as in the JAX engine: the solo
(isolation) lane the supervisor bisects poisoned batches through
(``submit(solo=True)``); ``params`` / ``set_params``, a swap of the
reference the dispatcher reads once per dispatch (the live module is never
written in place, so a forward in flight finishes on the weights it
started with); ``queue_depth``, ``dispatch_p50_s`` and ``window_p50_s``,
the admission-control and placement estimates; the fault sites
``serving_forward``, ``serving_slow``, ``serving_corrupt`` (on the numpy
rows after the device-to-host copy) and ``serving_dispatch[.name]``
(``utils/faults.py``); request tracing and workload capture
(``obs/tracing.py``, ``obs/workload.py``); and the process registry's
``deepgo_serving_*`` metrics. There is no jit cache, so
``compile_cache_size()`` is None. Under ``DEEPGO_XLACHECK=1`` the
runtime sanitizer (``analysis/cudacheck.py``) counts the forward's
signatures (zero new ones after warm-up), and each dispatch stages its
batch onto the forward's ``device`` explicitly and runs the forward inside
the transfer guard.

The dispatcher launches on its own thread's current CUDA stream; the
forward's ``.cpu()`` copy is the one synchronisation per dispatch.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from ..analysis import cudacheck
from ..analysis.lockcheck import make_lock
from .. import BOARD_SIZE
from ..features import PACKED_CHANNELS
from ..obs import get_registry
from ..utils import faults
from .buckets import DEFAULT_BUCKETS, BucketLadder


class EngineError(RuntimeError):
    """Base class for serving-engine failures."""


class EngineClosed(EngineError):
    """submit() after close(), or a pending request cancelled by close()."""


class EngineBusy(EngineError):
    """Non-blocking submit() against a full request queue (backpressure)."""


class BatchDispatchError(EngineError):
    """One coalesced dispatch failed inside the forward.

    Fails only the batch that rode the broken dispatch; the dispatcher
    survives. Carries ``batch_size`` (live requests in the failed
    dispatch) so the supervisor can tell a group failure (retry members
    alone: a neighbour may be poison) from a lone one; the forward's
    exception rides as ``__cause__``.
    """

    def __init__(self, message: str, batch_size: int):
        super().__init__(message)
        self.batch_size = batch_size


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for one engine. ``max_wait_ms`` is the latency/throughput
    trade: 0 dispatches whatever is queued immediately; a few ms lets
    concurrent submitters coalesce into one fuller dispatch."""

    buckets: tuple[int, ...] = DEFAULT_BUCKETS
    max_wait_ms: float = 2.0
    max_queue: int = 4096
    timeout_s: float | None = None      # default per-request deadline
    latency_window: int = 2048          # samples kept for p50/p99
    metrics_interval: int = 100         # dispatches between metrics records


class _Request:
    __slots__ = ("packed", "player", "rank", "future", "t_submit", "deadline",
                 "solo", "trace", "workload")

    def __init__(self, packed, player, rank, deadline, solo=False,
                 trace=None, workload=None):
        self.packed = packed
        self.player = player
        self.rank = rank
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.deadline = deadline
        self.solo = solo
        self.trace = trace  # obs.tracing.TraceContext, or None (off)
        self.workload = workload  # obs.workload.WorkloadToken, or None (off)


class InferenceEngine:
    """One model, one dispatcher thread, many concurrent submitters.

    ``forward(params, packed, player, rank) -> (B, ...)`` is any
    row-independent forward taking and returning numpy arrays (the policy
    log-probs of ``models/serving.make_log_prob_fn``, the value win-probs
    of ``make_value_fn``); the engine is agnostic to what the rows mean.
    """

    def __init__(self, forward, params, config: EngineConfig | None = None,
                 name: str = "policy", metrics=None):
        self.config = config or EngineConfig()
        self.ladder = BucketLadder(self.config.buckets)
        self.name = name
        # DEEPGO_XLACHECK=1 arms the signature sentinel and the transfer
        # guard; off, the forward passes through untouched and a dispatch
        # pays one attribute check
        self._device = getattr(forward, "device", None)
        self._forward = cudacheck.watch_compiles(forward, name=name)
        self._xla_on = cudacheck.enabled()
        self._params = params
        self._metrics = metrics
        self._queue: queue.Queue[_Request] = queue.Queue(
            maxsize=self.config.max_queue)
        self._closing = threading.Event()   # no new submits
        self._cancel = threading.Event()    # fail pending instead of draining
        self._error: BaseException | None = None
        self._lock = make_lock(f"engine.{name}")
        self._latencies: deque[float] = deque(
            maxlen=self.config.latency_window)
        # forward-only durations of recent successful dispatches: the
        # supervisor's admission control estimates queue wait from their
        # p50 (a small window keeps the estimate current under load shifts)
        self._dispatch_secs: deque[float] = deque(maxlen=64)
        # full (max-bucket) windows tracked separately: a backlog drains
        # in max-bucket windows, and the all-sizes p50 underestimates
        # their cost when small interactive dispatches dominate the mix
        self._window_secs: deque[float] = deque(maxlen=32)
        # solo lane: isolation retries from the supervisor dispatch
        # strictly alone (never coalesced), so a retried request's failure
        # is attributable to IT. Bypasses the bounded queue; membership is
        # capped by the batch that failed.
        self._solo: deque[_Request] = deque()
        self._bucket_hits: dict[int, int] = {}
        self._forwards = 0
        self._dispatches = 0
        self._dispatch_failures = 0
        self._boards = 0
        self._padded_boards = 0
        self._timeouts = 0
        self._warm_shapes = 0
        self._join_timed_out = False
        self._t_start = time.monotonic()
        # process-registry aggregates, labeled by engine name; the metric
        # objects are cached here so a dispatch pays one observe()/inc()
        # per event, never a registry lookup
        reg = get_registry()
        self._obs_dispatch = reg.histogram(
            "deepgo_serving_dispatch_seconds",
            "forward duration of one coalesced dispatch")
        self._obs_request = reg.histogram(
            "deepgo_serving_request_seconds",
            "request latency submit-to-result")
        self._obs_boards = reg.counter(
            "deepgo_serving_boards_total", "boards served")
        self._obs_dispatches = reg.counter(
            "deepgo_serving_dispatches_total", "coalesced dispatches run")
        self._obs_failures = reg.counter(
            "deepgo_serving_dispatch_failures_total",
            "dispatches failed inside the forward")
        self._obs_timeouts = reg.counter(
            "deepgo_serving_timeouts_total",
            "requests expired before dispatch")
        self._obs_occupancy = reg.gauge(
            "deepgo_serving_occupancy",
            "real boards / padded boards since engine start")
        self._obs_depth = reg.gauge(
            "deepgo_serving_queue_depth",
            "requests waiting in the bounded queue")
        self._thread = threading.Thread(
            target=self._dispatch_loop, name=f"serving-{name}", daemon=True)
        self._thread.start()

    # -- lifecycle ---------------------------------------------------------

    def _run_forward(self, packed, player, rank, guarded: bool = False
                     ) -> np.ndarray:
        """One call of the forward on the current weights, counted. A
        ``guarded`` call (a live dispatch with the sanitizer armed) stages
        the batch at the DECLARED host-to-device point and runs inside the
        transfer guard, which proves the forward copies nothing else."""
        with self._lock:
            self._forwards += 1
            params = self._params
        if guarded and self._xla_on:
            inputs = cudacheck.stage_h2d(packed, player, rank,
                                         device=self._device)
            with cudacheck.transfer_guard(f"engine.{self.name}",
                                          device=self._device,
                                          inputs=inputs):
                return np.asarray(self._forward(params, *inputs))
        return np.asarray(self._forward(params, packed, player, rank))

    def warmup(self) -> int:
        """Run one empty-board forward at every ladder rung, so the first
        live dispatch of each shape pays no first-call cost (cuDNN
        algorithm choice, allocator growth). Returns the rung count.

        Each rung's forward is timed and seeded into the rolling
        dispatch-latency window, so admission control has a latency prior
        before the first live dispatch: without it the estimate stays None
        under a tight-deadline flood (queued requests expire before any
        dispatch succeeds) and the door never sheds. The seed includes the
        first-call cost, so it errs high; the medians follow the live
        dispatches within a few windows. (The JAX engine times a second
        forward per rung, after the compile; here one suffices.)"""
        for b in self.ladder.buckets:
            packed = np.zeros((b, PACKED_CHANNELS, BOARD_SIZE, BOARD_SIZE),
                              dtype=np.uint8)
            ones = np.ones(b, dtype=np.int32)
            t_fwd = time.monotonic()
            self._run_forward(packed, ones, ones)
            dt = time.monotonic() - t_fwd
            with self._lock:
                self._dispatch_secs.append(dt)
                if b == self.ladder.max_bucket:
                    self._window_secs.append(dt)
        self._warm_shapes = len(self.ladder.buckets)
        # warm-up over: from here a new forward signature is a
        # RecompileStorm finding when the sanitizer is armed
        cudacheck.mark_warm(self._forward)
        return self._warm_shapes

    def compile_cache_size(self) -> int | None:
        """None: an eager PyTorch forward has no compile cache (the JAX
        engine reports its jit cache's size here)."""
        return None

    @property
    def params(self):
        """The weights the next dispatch will use (see set_params)."""
        return self._params

    def set_params(self, params) -> None:
        """Weight hot-swap: a swap of the reference, no pause.

        The dispatcher reads ``self._params`` once per dispatch, under the
        same lock, so one assignment is the whole protocol: a dispatch in
        flight finishes on the module it started with, the next one takes
        the new module. The live module is never written in place (a
        ``copy_`` into it would tear the rows of a forward in flight). The
        fleet reload path (serving/fleet.py) drains a replica first so a
        request's weights are never ambiguous."""
        with self._lock:
            self._params = params

    def _check_alive(self) -> None:
        if self._error is not None:
            raise EngineError(
                f"InferenceEngine[{self.name}] dispatcher thread died"
            ) from self._error
        if self._closing.is_set():
            raise EngineClosed(f"InferenceEngine[{self.name}] is closed")

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting work and shut the dispatcher down.

        ``drain=True`` processes everything already queued before the
        thread exits; ``drain=False`` fails pending futures with
        EngineClosed instead. Either way no waiter is left on a future
        nobody will resolve."""
        if not drain:
            self._cancel.set()
        self._closing.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self._join_timed_out = True
            print(
                f"InferenceEngine[{self.name}] dispatcher did not exit "
                f"within {timeout}s at close; thread leaked (likely wedged "
                "inside the forward)", file=sys.stderr, flush=True)
        self._fail_pending(EngineClosed(
            f"InferenceEngine[{self.name}] closed with request pending"))
        if self._metrics is not None:
            self._metrics.write("serving_close", engine=self.name,
                                **self.stats())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- submission --------------------------------------------------------

    def submit(self, packed: np.ndarray, player: int, rank: int,
               timeout_s: float | None = None, block: bool = True,
               solo: bool = False, trace=None, workload=None) -> Future:
        """Queue one board; returns a Future resolving to its result row.

        ``timeout_s`` (default: config.timeout_s) bounds queue-to-result
        time — an expired request fails with TimeoutError instead of
        occupying a dispatch. With ``block=False`` a full queue raises
        EngineBusy immediately; blocking submits wait for space but keep
        re-checking engine liveness. ``solo=True`` routes the request
        through the isolation lane: it dispatches strictly alone (the
        supervisor's batch-poison bisection), skipping the bounded queue.
        ``trace`` is the caller's TraceContext (obs/tracing.py): the
        timeline gains queued/coalesced/dispatched/resolved stamps; when
        tracing is armed and no outer layer owns the request, the engine
        starts (and finishes) a trace of its own. ``workload`` is the
        caller's WorkloadToken (obs/workload.py) under the same ownership
        rule; the engine stamps the rung the request dispatched on."""
        self._check_alive()
        owned = None
        if trace is None:
            from ..obs import tracing

            trace = owned = tracing.start_request(engine=self.name)
        if trace is not None:
            trace.mark("queued", engine=self.name)
        wl_owned = None
        if workload is None:
            from ..obs import workload as workload_mod

            workload = wl_owned = workload_mod.note_request(
                packed, player, rank, engine=self.name)
        timeout_s = self.config.timeout_s if timeout_s is None else timeout_s
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        req = _Request(np.asarray(packed), int(player), int(rank), deadline,
                       solo=solo, trace=trace, workload=workload)
        if owned is not None:
            req.future.add_done_callback(owned.finish_future)
        if wl_owned is not None:
            req.future.add_done_callback(wl_owned.finish_future)
        if solo:
            self._solo.append(req)
            return req.future
        while True:
            try:
                self._queue.put(req, block=block, timeout=0.1)
                return req.future
            except queue.Full:
                if not block:
                    raise EngineBusy(
                        f"InferenceEngine[{self.name}] queue full "
                        f"({self.config.max_queue} pending)") from None
                self._check_alive()

    def evaluate(self, packed: np.ndarray, players: np.ndarray,
                 ranks: np.ndarray, timeout_s: float | None = None
                 ) -> np.ndarray:
        """Blocking convenience: submit every row, gather in order."""
        futures = [self.submit(packed[i], int(players[i]), int(ranks[i]),
                               timeout_s=timeout_s)
                   for i in range(len(packed))]
        return np.stack([f.result() for f in futures])

    # -- dispatcher --------------------------------------------------------

    def _collect(self) -> list[_Request] | None:
        """One coalescing window: block for the first request, then gather
        until the ladder's top rung fills or ``max_wait_ms`` elapses.
        Solo requests (the isolation lane) preempt the window and dispatch
        strictly alone. Returns None when closing and everything is
        empty."""
        while True:
            if self._solo:
                return [self._solo.popleft()]
            try:
                first = self._queue.get(timeout=0.05)
                break
            except queue.Empty:
                if self._closing.is_set() and not self._solo:
                    return None
        batch = [first]
        t_end = time.monotonic() + self.config.max_wait_ms / 1000.0
        while len(batch) < self.ladder.max_bucket:
            # a closing engine stops waiting for stragglers: drain eagerly
            remaining = 0.0 if self._closing.is_set() \
                else t_end - time.monotonic()
            try:
                batch.append(self._queue.get(
                    block=remaining > 0, timeout=max(remaining, 0.0) or None))
            except queue.Empty:
                break
        return batch

    def _dispatch(self, batch: list[_Request]) -> None:
        now = time.monotonic()
        live = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                if r.trace is not None:
                    r.trace.mark("expired", engine=self.name)
                r.future.set_exception(TimeoutError(
                    f"request expired after {now - r.t_submit:.3f}s in "
                    f"InferenceEngine[{self.name}] queue"))
                with self._lock:
                    self._timeouts += 1
                self._obs_timeouts.inc(engine=self.name)
            elif r.future.set_running_or_notify_cancel():
                live.append(r)
        if not live:
            return
        n = len(live)
        bucket = self.ladder.bucket_for(n)
        for r in live:
            if r.workload is not None:
                r.workload.bucket = bucket
        traced = [r for r in live if r.trace is not None]
        for r in traced:
            r.trace.mark("coalesced", engine=self.name, batch=n,
                         bucket=bucket)
            r.trace.set(bucket=bucket, engine=self.name)
        packed, players, ranks = self.ladder.pad(
            np.stack([r.packed for r in live]),
            np.array([r.player for r in live], dtype=np.int32),
            np.array([r.rank for r in live], dtype=np.int32), bucket)
        for r in traced:
            r.trace.mark("dispatched", engine=self.name)
        t_fwd = time.monotonic()
        try:
            faults.check("serving_forward")
            # an injected brownout sleeps INSIDE the timed dispatch window,
            # so every latency surface (dispatch histogram, admission
            # estimate, the fleet's outlier ejection) sees it as it would
            # see a really slow replica
            faults.maybe_slow("serving_slow", self.name)
            out = self._run_forward(packed, players, ranks, guarded=True)
            if faults.corrupt_due("serving_corrupt", self.name):
                # silently WRONG rows, perturbed on the host after the
                # device-to-host copy: a log-prob row comes back
                # denormalised with its argmax at the original argmin
                out = 1.0 - out
        except BaseException as e:  # noqa: BLE001 — typed onto the futures
            # contain the blast radius to THIS batch: its futures fail with
            # a typed wrapper (cause attached); the dispatcher keeps
            # serving. The supervisor bisects the batch through the solo
            # lane.
            err = BatchDispatchError(
                f"dispatch of {n} request(s) failed in "
                f"InferenceEngine[{self.name}]: {e!r}", n)
            err.__cause__ = e
            with self._lock:
                self._dispatch_failures += 1
            self._obs_failures.inc(engine=self.name)
            for r in live:
                if r.trace is not None:
                    r.trace.mark("failed", engine=self.name,
                                 error=type(e).__name__, batch=n)
                if not r.future.done():
                    r.future.set_exception(err)
            return
        t_done = time.monotonic()
        for r in traced:
            r.trace.mark("resolved", engine=self.name)
        for i, r in enumerate(live):
            r.future.bucket = bucket
            r.future.set_result(out[i])
        with self._lock:
            self._dispatches += 1
            self._boards += n
            self._padded_boards += bucket
            self._bucket_hits[bucket] = self._bucket_hits.get(bucket, 0) + 1
            self._latencies.extend(t_done - r.t_submit for r in live)
            self._dispatch_secs.append(t_done - t_fwd)
            if bucket == self.ladder.max_bucket:
                self._window_secs.append(t_done - t_fwd)
            occupancy = self._boards / self._padded_boards
            write_metrics = (
                self._metrics is not None
                and self._dispatches % self.config.metrics_interval == 0)
        self._obs_dispatch.observe(t_done - t_fwd, engine=self.name,
                                   bucket=bucket)
        for r in live:
            self._obs_request.observe(t_done - r.t_submit, engine=self.name)
        self._obs_dispatches.inc(engine=self.name)
        self._obs_boards.inc(n, engine=self.name)
        self._obs_occupancy.set(occupancy, engine=self.name)
        self._obs_depth.set(self._queue.qsize(), engine=self.name)
        if write_metrics:
            self._metrics.write("serving", engine=self.name, **self.stats())

    def _fail_pending(self, exc: BaseException) -> None:
        while self._solo:
            try:
                req = self._solo.popleft()
            except IndexError:  # concurrent drain
                break
            if not req.future.done():
                req.future.set_exception(exc)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if not req.future.done():
                req.future.set_exception(exc)

    def _dispatch_loop(self) -> None:
        batch = None
        try:
            while True:
                if self._cancel.is_set():
                    self._fail_pending(EngineClosed(
                        f"InferenceEngine[{self.name}] closed before "
                        "this request dispatched"))
                    return
                batch = self._collect()
                if batch is None:
                    return
                # dispatcher-death fault points: OUTSIDE the per-batch
                # containment, so an injected fault here takes the real
                # thread-death path (stashed error, failed futures, next
                # submit() raises) that the supervisor's restart absorbs;
                # the named form kills one replica of a fleet
                faults.check("serving_dispatch")
                faults.check(f"serving_dispatch.{self.name}")
                self._dispatch(batch)
        except BaseException as e:  # noqa: BLE001 — surfaced via submit()
            # stash the error, fail every in-flight future, and let the
            # next submit() re-raise it: never leave waiters blocked on
            # futures a dead thread owns
            self._error = e
            self._closing.set()
            for r in batch or ():
                if not r.future.done():
                    r.future.set_exception(e)
            self._fail_pending(e)

    # -- observability -----------------------------------------------------

    def queue_depth(self) -> int:
        """Requests waiting in the bounded queue right now (approximate:
        the dispatcher drains concurrently)."""
        return self._queue.qsize()

    def dispatch_p50_s(self) -> float | None:
        """Rolling median forward duration of recent successful dispatches
        (seconds), or None before the first one. The admission-control
        input: estimated queue wait = p50 x pending dispatch windows."""
        with self._lock:
            if not self._dispatch_secs:
                return None
            return float(np.median(self._dispatch_secs))

    def window_p50_s(self) -> float | None:
        """Rolling median duration of FULL (max-bucket) dispatch windows,
        falling back to the all-sizes median before the first full window.
        A backlog drains in max-bucket windows, and under a mixed workload
        the all-sizes p50 collapses toward the small interactive
        dispatches."""
        with self._lock:
            if self._window_secs:
                return float(np.median(self._window_secs))
            if not self._dispatch_secs:
                return None
            return float(np.median(self._dispatch_secs))

    def stats(self) -> dict:
        """Snapshot of the engine counters: request p50/p99 latency (ms,
        submit-to-result over the sliding window), mean batch occupancy
        (real boards / padded boards), per-bucket dispatch histogram,
        boards/sec since construction, and ``forwards``: every call of the
        forward, warmup and failed dispatches included."""
        with self._lock:
            lat = np.array(self._latencies, dtype=np.float64)
            dt = max(time.monotonic() - self._t_start, 1e-9)
            return {
                "forwards": self._forwards,
                "dispatches": self._dispatches,
                "boards": self._boards,
                "boards_per_sec": round(self._boards / dt, 1),
                "occupancy": round(
                    self._boards / self._padded_boards, 4)
                if self._padded_boards else None,
                "bucket_hits": {str(k): v for k, v in
                                sorted(self._bucket_hits.items())},
                "p50_ms": round(float(np.percentile(lat, 50)) * 1000, 3)
                if lat.size else None,
                "p99_ms": round(float(np.percentile(lat, 99)) * 1000, 3)
                if lat.size else None,
                "timeouts": self._timeouts,
                "dispatch_failures": self._dispatch_failures,
                "dispatcher_wedged": self._join_timed_out,
                "warm_shapes": self._warm_shapes,
            }
