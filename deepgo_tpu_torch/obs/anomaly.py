"""Streaming anomaly detection over the telemetry sample stream.

The port's copy of ``deepgo_tpu/obs/anomaly.py``. The sampler
(obs/timeseries.py) turns the registry into a stream of
flattened samples; this module watches a *declared* list of series over
that stream and turns "something changed" into a typed signal the rest
of the stack already knows how to carry: a ``deepgo_anomaly_total``
counter increment, an ``anomaly`` JSONL event, a pinned series window in
the store (so retention never decimates the evidence), and a flight-
recorder dump whose ``series_window`` section carries the surrounding
samples — the postmortem shape of restarts and burns.

Detectors are streaming and robust (no history buffers, no percentile
sorts — O(1) state per series):

  * **step** — robust z-score of the new value against an EWMA mean,
    scaled by an EWMA of absolute deviation (the streaming stand-in for
    MAD; 1.4826 x MAD estimates sigma for a normal). A step change in a
    series that has settled fires immediately; gaussian noise around a
    stable mean stays far under the default z=6 floor.
  * **drift** — divergence between a fast and a slow EWMA, in the same
    robust units, required to persist ``drift_consecutive`` samples: a
    slow degradation the step detector tracks right past. Hysteresis
    re-arms only after the divergence halves.
  * **rate** — mode ``increase``: any positive delta on a failure
    counter (failovers, restarts, poisons, stalls) is anomalous by
    definition — no warmup, so a replica kill is flagged on the very
    next sample. Mode ``drop`` is the gauge mirror, optionally floored
    (``drop_to``): a replica's state gauge falling to 0 (= failed)
    fires, a planned drain to 0.5 does not.
  * mode ``counter_rate`` first differentiates a throughput counter
    into a per-second rate, then runs step+drift over the rate — this
    is how "when did boards/sec start degrading" becomes an event.

False-positive discipline: value detectors arm only after
``min_samples`` ticks (a ramping-up run is not an anomaly), every
detector has hysteresis (one incident = one event, not one per sample),
and flight dumps are additionally budgeted per detector instance.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from collections import deque

from .registry import MetricsRegistry, get_registry
from .sentinel import get_flight_recorder
from .timeseries import TimeSeriesStore, key_matches, series_key, split_key


@dataclasses.dataclass(frozen=True)
class Anomaly:
    """One typed detection: ``metric`` is the watch family, ``series``
    the exact key that fired, ``kind`` the detector (step|drift|rate)."""

    metric: str
    series: str
    kind: str
    value: float
    baseline: float
    score: float
    t: float

    def to_dict(self) -> dict:
        return {
            "metric": self.metric, "series": self.series,
            "detector": self.kind, "value": round(self.value, 6),
            "baseline": round(self.baseline, 6),
            "score": round(self.score, 3), "t": self.t,
        }


@dataclasses.dataclass(frozen=True)
class WatchSpec:
    """One declared watch: a metric family + how to judge it.

    ``mode``: ``value`` (step+drift over the sampled value),
    ``counter_rate`` (differentiate first), ``increase`` (any positive
    delta fires), ``drop`` (any negative delta fires). ``field`` selects
    a histogram snapshot field (``p99``/``p50``/``count``/``sum``)."""

    metric: str
    mode: str = "value"
    field: str | None = None
    z_threshold: float = 6.0
    drift_threshold: float = 4.0
    drift_consecutive: int = 3
    min_samples: int = 8
    # ``drop`` refinement: fire only when the new value lands at or
    # below this floor. A rolling reload legitimately dips a replica to
    # "draining" (0.5) — only the fall to "failed" (0) is anomalous.
    drop_to: float | None = None

    def matches(self, key: str) -> bool:
        if not key_matches(self.metric, key):
            return False
        _name, _label, field = split_key(key)
        return field == self.field


# the declared watchlist: the operator metrics the ROADMAP arcs steer by
# — serving throughput + tail latency, every fleet/supervisor failure
# counter, loop ingest rate, and the variant-quality gauges. Absent
# series are simply never matched, so one list serves every deployment
# shape (engine, fleet, loop, train).
DEFAULT_WATCHLIST: tuple[WatchSpec, ...] = (
    WatchSpec("deepgo_serving_boards_total", mode="counter_rate"),
    WatchSpec("deepgo_serving_dispatch_seconds", field="p99"),
    WatchSpec("deepgo_serving_restarts_total", mode="increase"),
    WatchSpec("deepgo_serving_poisoned_total", mode="increase"),
    WatchSpec("deepgo_serving_timeouts_total", mode="increase"),
    WatchSpec("deepgo_fleet_failovers_total", mode="increase"),
    WatchSpec("deepgo_fleet_respawns_total", mode="increase"),
    # the gray-failure defenses (serving/fleet.py + chaos/):
    # hedges ticking means a tail is being papered over — worth a look;
    # an ejection or canary failure is a replica judged bad while still
    # "healthy"; a breaker-state RISE (0 closed -> 1 half-open -> 2
    # open) is a replica's supervisor cutting traffic
    WatchSpec("deepgo_fleet_hedges_total", mode="increase"),
    WatchSpec("deepgo_fleet_ejections_total", mode="increase"),
    WatchSpec("deepgo_fleet_canary_failures_total", mode="increase"),
    WatchSpec("deepgo_fleet_integrity_failures_total", mode="increase"),
    WatchSpec("deepgo_fleet_breaker_state", mode="increase"),
    # per-replica, not the fleet total: a planned rolling reload dips
    # replicas_serving (drain is not an incident); a replica hitting the
    # FAILED state is one
    WatchSpec("deepgo_fleet_replica_state", mode="drop", drop_to=0.0),
    # per-tier arrival rate (the workload recorder's counter, one series
    # per tier label): the dash sparkline that shows WHO is hammering
    # the fleet, and a collapse in interactive arrivals is an incident
    # even when the fleet itself is healthy
    WatchSpec("deepgo_workload_requests_total", mode="counter_rate"),
    # the position cache: hit rate collapsing shows up as the
    # hits counter-rate stepping down while misses step up; ANY stale
    # hit is an incident — the counter is structurally zero (reload
    # bumps the cache generation and old-generation fills are refused),
    # so a single increment means that invariant broke
    WatchSpec("deepgo_cache_hits_total", mode="counter_rate"),
    WatchSpec("deepgo_cache_misses_total", mode="counter_rate"),
    WatchSpec("deepgo_cache_stale_hits_total", mode="increase"),
    WatchSpec("deepgo_loop_games_ingested_total", mode="counter_rate"),
    WatchSpec("deepgo_loop_stalls_total", mode="increase"),
    WatchSpec("deepgo_loop_component_restarts_total", mode="increase"),
    WatchSpec("deepgo_train_samples_per_sec"),
    WatchSpec("deepgo_quant_top1_agreement", mode="drop"),
)

_MAD_SIGMA = 1.4826  # MAD -> sigma for a normal distribution


class _SeriesState:
    """O(1) streaming state for one (spec, series) pair."""

    __slots__ = ("n", "ewma", "slow", "mad", "prev", "prev_t",
                 "drift_run", "step_armed", "drift_armed", "seen")

    def __init__(self):
        self.n = 0
        self.ewma = 0.0
        self.slow = 0.0
        self.mad = 0.0
        self.prev: float | None = None
        self.prev_t: float | None = None
        self.drift_run = 0
        self.step_armed = True
        self.drift_armed = True
        self.seen: float | None = None  # a quantile's histogram count


def _fresh(state: _SeriesState, key: str, values: dict) -> bool:
    """Does this tick carry new information for ``key``? A histogram
    quantile (``p50``/``p99``) moves only with new observations: on a
    tick where its series' ``count`` did not change it repeats the last
    value, and judged as a sample it shrinks the scale estimate toward
    zero until the next observation scores without bound (a series
    quiet for seconds then fired at z in the thousands on a 0.5 % move).
    Such ticks are skipped; every other key is judged on every tick."""
    name, label, field = split_key(key)
    if field not in ("p50", "p99"):
        return True
    count = values.get(series_key(name, label, "count"))
    if count is None:
        return True
    if count == state.seen:
        return False
    state.seen = count
    return True


class AnomalyDetector:
    """Watchlist evaluator; plug ``observe`` into a TelemetrySampler.

    ``sink`` (any ``.write(kind, **fields)`` stream — a JsonlSink or the
    MetricsWriter shim) receives one ``anomaly`` event per detection;
    ``store`` gets its surrounding window pinned and is registered as
    the flight recorder's ``series_window`` section so every dump — this
    detector's own anomaly dumps included — carries the evidence."""

    def __init__(self, watchlist=None, sink=None,
                 registry: MetricsRegistry | None = None,
                 store: TimeSeriesStore | None = None,
                 flight: bool = True, clock=time.time,
                 pin_window: int = 16, max_flight_dumps: int = 8,
                 fast_alpha: float = 0.3, slow_alpha: float = 0.03,
                 scale_alpha: float = 0.05, max_kept: int = 256):
        self.watchlist = tuple(watchlist
                               if watchlist is not None
                               else DEFAULT_WATCHLIST)
        self._sink = sink
        self._store = store
        self._flight = flight
        self._clock = clock
        self._pin_window = pin_window
        self._flight_budget = max_flight_dumps
        self._fast_alpha = fast_alpha
        self._slow_alpha = slow_alpha
        self._scale_alpha = scale_alpha
        self._states: dict[tuple[int, str], _SeriesState] = {}
        # set after the first tick: a labeled failure-counter series
        # often does not EXIST until its first increment, so a series
        # appearing mid-stream baselines at 0 (its implicit prior value)
        # — the first restart is detected, not swallowed as "new
        # series". Series present at the first tick baseline at their
        # observed value: attaching to a running process must not
        # re-announce its history.
        self._primed = False
        self.anomalies: deque = deque(maxlen=max_kept)
        self.count = 0
        self.by_kind: dict[str, int] = {}
        self.first: Anomaly | None = None
        self._obs_anomalies = (registry or get_registry()).counter(
            "deepgo_anomaly_total",
            "streaming-detector anomalies by watch metric and detector "
            "kind (step|drift|rate)")
        if store is not None and flight:
            get_flight_recorder().add_section(
                "series_window", lambda: store.recent_window())

    # -- the listener hook -------------------------------------------------

    def observe(self, t: float, values: dict) -> list[Anomaly]:
        """One sampler tick: run every watch over the sample, emit and
        return any detections. Never raises — the sampler's listener
        contract."""
        found: list[Anomaly] = []
        for idx, spec in enumerate(self.watchlist):
            for key, raw in values.items():
                if not spec.matches(key):
                    continue
                state = self._states.setdefault((idx, key), _SeriesState())
                if _fresh(state, key, values):
                    found.extend(self._judge(spec, key, state, float(raw),
                                             t))
        self._primed = True
        for a in found:
            self._emit(a)
        return found

    # -- per-sample judgement ----------------------------------------------

    def _judge(self, spec: WatchSpec, key: str, state: _SeriesState,
               x: float, t: float) -> list[Anomaly]:
        if spec.mode == "increase" or spec.mode == "drop":
            prev, state.prev, state.prev_t = state.prev, x, t
            if prev is None:
                if spec.mode == "increase" and self._primed:
                    prev = 0.0  # a counter series born mid-stream
                else:
                    return []
            delta = x - prev
            if spec.mode == "increase" and delta > 0:
                return [Anomaly(spec.metric, key, "rate", x, prev,
                                delta, t)]
            if spec.mode == "drop" and delta < 0 \
                    and (spec.drop_to is None or x <= spec.drop_to):
                return [Anomaly(spec.metric, key, "step", x, prev,
                                -delta, t)]
            return []
        if spec.mode == "counter_rate":
            prev, prev_t = state.prev, state.prev_t
            state.prev, state.prev_t = x, t
            if prev is None or prev_t is None or t <= prev_t:
                return []
            x = max(0.0, (x - prev) / (t - prev_t))  # the per-second rate
        return self._judge_value(spec, key, state, x, t)

    def _judge_value(self, spec: WatchSpec, key: str, state: _SeriesState,
                     x: float, t: float) -> list[Anomaly]:
        out: list[Anomaly] = []
        state.n += 1
        if state.n == 1:
            state.ewma = state.slow = x
            return out
        dev = abs(x - state.ewma)
        sigma = _MAD_SIGMA * state.mad + 1e-12 + 1e-6 * abs(state.ewma)
        warm = state.n > spec.min_samples
        if warm:
            score = dev / sigma
            if score >= spec.z_threshold and state.step_armed:
                state.step_armed = False
                out.append(Anomaly(spec.metric, key, "step", x,
                                   state.ewma, score, t))
                # a confirmed step RE-BASELINES the series: the level
                # moved, so both means jump to it (one incident = one
                # event — the drift detector must not re-announce the
                # same move while the slow mean catches up) and the
                # scale estimate is left alone (the firing deviation is
                # not noise to absorb)
                state.ewma = state.slow = x
                state.drift_run = 0
                return out
            elif score < spec.z_threshold / 2.0:
                state.step_armed = True
        # update AFTER scoring: the new value must not defend itself.
        # The scale estimate warms in fast (a near-zero MAD inflates
        # every early score) then adapts SLOWLY: a noise-speed scale
        # tracker makes robust-z heavy-tailed and fires on healthy jitter
        state.ewma += self._fast_alpha * (x - state.ewma)
        state.slow += self._slow_alpha * (x - state.slow)
        scale_alpha = (self._fast_alpha if state.n <= spec.min_samples
                       else self._scale_alpha)
        state.mad += scale_alpha * (dev - state.mad)
        if warm:
            drift_score = abs(state.ewma - state.slow) / sigma
            if drift_score >= spec.drift_threshold:
                state.drift_run += 1
                if state.drift_run >= spec.drift_consecutive \
                        and state.drift_armed:
                    state.drift_armed = False
                    out.append(Anomaly(spec.metric, key, "drift", x,
                                       state.slow, drift_score, t))
            else:
                state.drift_run = 0
                if drift_score < spec.drift_threshold / 2.0:
                    state.drift_armed = True
        return out

    # -- emission ----------------------------------------------------------

    def _emit(self, a: Anomaly) -> None:
        self.count += 1
        self.by_kind[a.kind] = self.by_kind.get(a.kind, 0) + 1
        if self.first is None:
            self.first = a
        self.anomalies.append(a)
        self._obs_anomalies.inc(1, metric=a.metric, kind=a.kind)
        if self._sink is not None:
            try:
                self._sink.write("anomaly", **a.to_dict())
            except Exception as e:  # noqa: BLE001 — a closed sink must not mask the detection
                print(f"anomaly detector: sink write failed: {e!r}",
                      file=sys.stderr, flush=True)
        if self._store is not None:
            self._store.pin_recent(self._pin_window)
        if self._flight and self._flight_budget > 0:
            self._flight_budget -= 1
            get_flight_recorder().dump("anomaly", **a.to_dict())

    # -- accounting --------------------------------------------------------

    def summary(self, t0: float | None = None) -> dict:
        """The bench/loop JSON block: counts, kinds, and how fast the
        first detection landed relative to ``t0``."""
        out: dict = {"count": self.count, "by_kind": dict(self.by_kind)}
        if self.first is not None:
            out["first"] = self.first.to_dict()
            if t0 is not None:
                out["first_detect_s"] = round(self.first.t - t0, 3)
        return out
