"""Resilience primitives for the serving path: typed shed/poison errors,
a closed/open/half-open circuit breaker, and full-jitter restart backoff.

The port's copy of ``deepgo_tpu/serving/resilience.py``. Large fleets treat component failure as
the steady state (FireCaffe, arXiv:1511.00175: failure frequency grows
linearly with worker count), so the serving layer needs the same discipline
as training. The pieces here are deliberately tiny, lock-protected state
machines with injectable clocks — the supervisor (serving/supervisor.py)
composes them, and the tests drive every transition deterministically
without sleeping.

Failure-handling vocabulary (every one is an ``EngineError``, so callers
that already catch the engine's typed failures keep working):

  EngineOverloaded   shed at submit(): the estimated queue wait already
                     exceeds the request's deadline — queueing it would
                     only manufacture a timeout later.
  CircuitOpen        shed at submit(): the engine is failing persistently
                     and the breaker fails callers fast instead of letting
                     each one discover the outage by timeout.
  PoisonedRequest    this request deterministically fails the forward on
                     its own (its batch neighbors succeeded without it);
                     the offending inputs are quarantined for postmortem.
  RestartsExhausted  the supervisor gave up rebuilding the engine after
                     ``max_restarts`` consecutive failed restarts.
"""

from __future__ import annotations

import time

from ..analysis.lockcheck import make_lock
from .engine import EngineError


class EngineOverloaded(EngineError):
    """submit() rejected by deadline-aware admission control."""


class CircuitOpen(EngineError):
    """submit() shed by an open circuit breaker (engine failing hard)."""


class PoisonedRequest(EngineError):
    """The request itself fails the forward; inputs quarantined."""


class RestartsExhausted(EngineError):
    """The supervisor's bounded restart budget ran out."""


def full_jitter_delay(attempt: int, base: float, cap: float, rng) -> float:
    """AWS-style full-jitter backoff: U(0, min(cap, base * 2**attempt)).

    Drawing the whole delay uniformly (not just +/- a fraction)
    decorrelates a herd of restarters/retriers that all observed the same
    failure at the same instant — the exponential envelope bounds the
    worst case, the jitter spreads the load. ``attempt`` counts from 0.
    """
    return rng.uniform(0.0, min(cap, base * (2.0 ** attempt)))


class CircuitBreaker:
    """Closed / open / half-open breaker with single-probe recovery.

    closed     normal operation; ``failures`` CONSECUTIVE failures open it
               (any success resets the count).
    open       ``allow()`` returns False — callers shed instantly — until
               ``reset_timeout_s`` has passed, then exactly one caller is
               let through as the probe (state moves to half-open).
    half-open  the probe is in flight; everyone else still sheds. The
               probe's success closes the breaker, its failure re-opens
               it (and restarts the recovery timer).

    ``clock`` is injectable (tests drive recovery without sleeping);
    ``on_transition(old, new)`` observes every state change — the
    supervisor turns those into MetricsWriter events.
    """

    def __init__(self, failures: int = 5, reset_timeout_s: float = 30.0,
                 clock=time.monotonic, on_transition=None,
                 name: str = "breaker"):
        if failures < 1:
            raise ValueError(f"failures must be >= 1, got {failures}")
        self.failures = failures
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._on_transition = on_transition
        self._lock = make_lock(name)
        self._state = "closed"
        self._consecutive = 0
        self._opened_at: float | None = None
        self._probe_ready = False   # open -> probe available immediately
        self._transitions = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _move(self, new: str) -> None:
        # lock held by caller
        old, self._state = self._state, new
        self._transitions += 1
        if self._on_transition is not None:
            self._on_transition(old, new)

    def allow(self) -> bool:
        """May a request proceed right now?

        In the open state, the first call at/after the recovery deadline
        is granted as THE probe (state -> half-open); in half-open, the
        probe is already out, so everyone sheds until it resolves."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                due = self._probe_ready or (
                    self._clock() - self._opened_at >= self.reset_timeout_s)
                if due:
                    self._probe_ready = False
                    self._move("half_open")
                    return True
                return False
            return False  # half_open: probe outstanding

    def cancel_probe(self) -> None:
        """The probe slot was granted but no request was actually sent
        (e.g. the submit then failed admission or backpressure): return
        to open with the probe immediately available to the next caller,
        so a shed probe can never wedge the breaker half-open forever."""
        with self._lock:
            if self._state == "half_open":
                self._probe_ready = True
                self._move("open")

    def record_success(self) -> None:
        """Any served request closes the breaker, whatever the state: a
        success is ground truth that the engine serves again. The probe
        dance exists for the no-traffic case — but the supervisor also
        replays parked requests after a restart, and those replays are
        real traffic whose success should not wait out reset_timeout_s."""
        with self._lock:
            self._consecutive = 0
            if self._state != "closed":
                self._opened_at = None
                self._probe_ready = False
                self._move("closed")

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half_open":
                self._opened_at = self._clock()
                self._move("open")
                return
            self._consecutive += 1
            if self._state == "closed" and self._consecutive >= self.failures:
                self._opened_at = self._clock()
                self._move("open")

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "transitions": self._transitions,
            }
