"""Micro-batching inference engine: futures in, one padded dispatch out.

The port of the core of ``deepgo_tpu/serving/engine.py``. Callers submit
single-board requests and get ``concurrent.futures.Future``s. A dispatcher
thread coalesces up to ``max_bucket`` requests or ``max_wait_ms``, pads the
batch onto the bucket ladder (buckets.py), runs ONE forward, and scatters
result rows back to the futures. The queue is bounded (backpressure),
requests carry optional deadlines, a failed forward fails only its own
batch (``BatchDispatchError``), and dispatcher death surfaces on the next
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

Left for later slices of the port: the solo (isolation) lane and the
latency estimates the supervisor's admission control reads, the fault
injection sites, request tracing and workload capture, the static-analysis
recompile/transfer sentinel and the process metrics registry.

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

from .. import BOARD_SIZE
from ..features import PACKED_CHANNELS
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
    dispatch); the forward's exception rides as ``__cause__``.
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


class _Request:
    __slots__ = ("packed", "player", "rank", "future", "t_submit", "deadline")

    def __init__(self, packed, player, rank, deadline):
        self.packed = packed
        self.player = player
        self.rank = rank
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.deadline = deadline


class InferenceEngine:
    """One model, one dispatcher thread, many concurrent submitters.

    ``forward(params, packed, player, rank) -> (B, ...)`` is any
    row-independent forward taking and returning numpy arrays (the policy
    log-probs of ``models/serving.make_log_prob_fn``).
    """

    def __init__(self, forward, params, config: EngineConfig | None = None,
                 name: str = "policy"):
        self.config = config or EngineConfig()
        self.ladder = BucketLadder(self.config.buckets)
        self.name = name
        self._forward = forward
        self._params = params
        self._queue: queue.Queue[_Request] = queue.Queue(
            maxsize=self.config.max_queue)
        self._closing = threading.Event()   # no new submits
        self._cancel = threading.Event()    # fail pending instead of draining
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        self._latencies: deque[float] = deque(
            maxlen=self.config.latency_window)
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
        self._thread = threading.Thread(
            target=self._dispatch_loop, name=f"serving-{name}", daemon=True)
        self._thread.start()

    # -- lifecycle ---------------------------------------------------------

    def warmup(self) -> int:
        """Run one empty-board forward at every ladder rung, so the first
        live dispatch of each shape pays no first-call cost (cuDNN
        algorithm choice, allocator growth). Returns the rung count."""
        for b in self.ladder.buckets:
            packed = np.zeros((b, PACKED_CHANNELS, BOARD_SIZE, BOARD_SIZE),
                              dtype=np.uint8)
            ones = np.ones(b, dtype=np.int32)
            with self._lock:
                self._forwards += 1
            np.asarray(self._forward(self._params, packed, ones, ones))
        self._warm_shapes = len(self.ladder.buckets)
        return self._warm_shapes

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

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- submission --------------------------------------------------------

    def submit(self, packed: np.ndarray, player: int, rank: int,
               timeout_s: float | None = None, block: bool = True) -> Future:
        """Queue one board; returns a Future resolving to its result row.

        ``timeout_s`` (default: config.timeout_s) bounds queue-to-result
        time — an expired request fails with TimeoutError instead of
        occupying a dispatch. With ``block=False`` a full queue raises
        EngineBusy immediately; blocking submits wait for space but keep
        re-checking engine liveness."""
        self._check_alive()
        timeout_s = self.config.timeout_s if timeout_s is None else timeout_s
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        req = _Request(np.asarray(packed), int(player), int(rank), deadline)
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
        Returns None when closing and the queue is empty."""
        while True:
            try:
                first = self._queue.get(timeout=0.05)
                break
            except queue.Empty:
                if self._closing.is_set():
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
                r.future.set_exception(TimeoutError(
                    f"request expired after {now - r.t_submit:.3f}s in "
                    f"InferenceEngine[{self.name}] queue"))
                with self._lock:
                    self._timeouts += 1
            elif r.future.set_running_or_notify_cancel():
                live.append(r)
        if not live:
            return
        n = len(live)
        bucket = self.ladder.bucket_for(n)
        packed, players, ranks = self.ladder.pad(
            np.stack([r.packed for r in live]),
            np.array([r.player for r in live], dtype=np.int32),
            np.array([r.rank for r in live], dtype=np.int32), bucket)
        with self._lock:
            self._forwards += 1
        try:
            out = np.asarray(self._forward(self._params, packed, players,
                                           ranks))
        except Exception as e:  # noqa: BLE001 — typed onto the futures
            # contain the blast radius to THIS batch: its futures fail with
            # a typed wrapper (cause attached); the dispatcher keeps serving
            err = BatchDispatchError(
                f"dispatch of {n} request(s) failed in "
                f"InferenceEngine[{self.name}]: {e!r}", n)
            err.__cause__ = e
            with self._lock:
                self._dispatch_failures += 1
            for r in live:
                if not r.future.done():
                    r.future.set_exception(err)
            return
        t_done = time.monotonic()
        for i, r in enumerate(live):
            r.future.bucket = bucket
            r.future.set_result(out[i])
        with self._lock:
            self._dispatches += 1
            self._boards += n
            self._padded_boards += bucket
            self._bucket_hits[bucket] = self._bucket_hits.get(bucket, 0) + 1
            self._latencies.extend(t_done - r.t_submit for r in live)

    def _fail_pending(self, exc: BaseException) -> None:
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
