"""Declarative SLOs with multi-window error-budget burn rates.

The port's copy of ``deepgo_tpu/obs/slo.py``. The registry makes the
system observable; this module makes it *judgeable*: a set
of declared objectives — serving dispatch latency, training throughput
floor, endpoint availability — evaluated continuously against the live
registry, with the SRE-workbook multi-window burn-rate logic deciding
between "fine", "burning fast" (page-grade: the error budget dies within
hours), and "burning slow" (ticket-grade drift).

Mechanics: each objective reports cumulative (good, total) event counts.
The tracker samples those counts on every ``evaluate()``, keeps a
time-stamped ring of samples, and computes the bad-event fraction over a
short and a long window. The **burn rate** is that fraction divided by
the objective's error budget (1 - target): burn 1.0 spends the budget
exactly at the allowed pace, burn 14.4 exhausts a 30-day budget in 2
days. State machine per objective:

  fast_burn   short-window burn >= fast_burn threshold (default 14.4)
  slow_burn   long-window burn >= slow_burn threshold (default 6.0)
  ok          neither — recovery is automatic once the windows drain

Transitions emit ``slo_burn`` events (to the configured sink, else an
``SLO_BURN`` JSON line on stdout), every evaluation updates the
``deepgo_slo_burn_ratio{slo=...,window=fast|slow}`` gauge, and entering
``fast_burn`` trips the flight recorder — an incident ships with its
black box. ``health()`` is a health component that reports **degraded
without failing**: a burning SLO is a warning the operator reads, not a
reason for the load balancer to pull the replica.

Clocks are injectable; tests drive every window transition without
sleeping (the liveness/supervisor discipline).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass

from .registry import Histogram, MetricsRegistry, get_registry
from .sentinel import flight_dump


@dataclass(frozen=True)
class SLOConfig:
    """Window/threshold knobs shared by every objective in a tracker.
    Defaults are the SRE-workbook pairing scaled to this repo's runs:
    5-minute fast window at burn 14.4, 1-hour slow window at burn 6."""

    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn: float = 14.4
    slow_burn: float = 6.0


class Objective:
    """One SLO: a name, a compliance target, and a cumulative event feed.

    Subclasses implement ``sample() -> (good, total)`` as *cumulative*
    counts; the tracker differences consecutive samples, so feeds may be
    registry counters, histogram buckets, or per-tick probes that keep
    their own counters."""

    def __init__(self, name: str, target: float = 0.99):
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"SLO {name!r} target must be in (0, 1), got {target}")
        self.name = name
        self.target = target
        self.budget = max(1.0 - target, 1e-9)

    def sample(self) -> tuple[float, float]:  # pragma: no cover - abstract
        raise NotImplementedError

    def describe(self) -> dict:
        return {"name": self.name, "target": self.target,
                "kind": type(self).__name__}


class HistogramLatencyObjective(Objective):
    """"``target`` of observations complete within ``threshold_s``" over a
    registry histogram (e.g. serving p99 dispatch latency). Good events
    are counted from the cumulative bucket whose upper edge does not
    exceed the threshold — align thresholds to bucket edges
    (registry.DEFAULT_BUCKETS_S) for exact accounting; an off-edge
    threshold rounds down, i.e. judges *stricter*, never laxer."""

    def __init__(self, name: str, metric: str, threshold_s: float,
                 target: float = 0.99,
                 registry: MetricsRegistry | None = None, **labels):
        super().__init__(name, target)
        self.metric = metric
        self.threshold_s = float(threshold_s)
        self._registry = registry or get_registry()
        self._labels = {k: str(v) for k, v in labels.items()}

    def sample(self) -> tuple[float, float]:
        h = self._registry.histogram(self.metric)
        good = total = 0
        if isinstance(h, Histogram):
            for key, (counts, n, _) in h.collect_raw().items():
                labels = dict(key)
                if any(str(labels.get(k)) != v
                       for k, v in self._labels.items()):
                    continue
                total += n
                for edge, c in zip(h.buckets, counts):
                    if edge <= self.threshold_s + 1e-12:
                        good += c
        return float(good), float(total)

    def describe(self) -> dict:
        return {**super().describe(), "metric": self.metric,
                "threshold_s": self.threshold_s}


class GaugeFloorObjective(Objective):
    """"``target`` of evaluation ticks find the gauge at or above
    ``floor``" — the training samples/sec floor. Ticks taken before the
    gauge's first set are skipped (a run that has not produced its first
    window is not in violation of its throughput SLO)."""

    def __init__(self, name: str, metric: str, floor: float,
                 target: float = 0.99,
                 registry: MetricsRegistry | None = None, **labels):
        super().__init__(name, target)
        self.metric = metric
        self.floor = float(floor)
        self._registry = registry or get_registry()
        self._key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        self._good = 0
        self._total = 0

    def sample(self) -> tuple[float, float]:
        g = self._registry.gauge(self.metric)
        series = g.collect()
        if self._key not in series:
            return float(self._good), float(self._total)  # not yet set
        self._total += 1
        if series[self._key] >= self.floor:
            self._good += 1
        return float(self._good), float(self._total)

    def describe(self) -> dict:
        return {**super().describe(), "metric": self.metric,
                "floor": self.floor}


class HealthObjective(Objective):
    """"``target`` of probes find the component healthy" — availability
    over any health callable (an ObsExporter's ``check_health``, an
    engine's ``health()``). Probe exceptions count as bad: an unreachable
    health check *is* unavailability."""

    def __init__(self, name: str, check, target: float = 0.999):
        super().__init__(name, target)
        self._check = check
        self._good = 0
        self._total = 0

    def sample(self) -> tuple[float, float]:
        self._total += 1
        try:
            verdict = self._check()
            if isinstance(verdict, tuple):  # check_health -> (payload, ok)
                ok = bool(verdict[1])
            elif isinstance(verdict, dict):
                ok = bool(verdict.get("healthy", True))
            else:
                ok = bool(verdict)
        except Exception:  # noqa: BLE001 — a dead probe is unavailability
            ok = False
        if ok:
            self._good += 1
        return float(self._good), float(self._total)


class SloTracker:
    """Evaluate a set of objectives against time; emit burns, gauge,
    health. One ``evaluate()`` per tick (the background thread, a window
    hook, or a test's fake clock); all state is per-objective rings of
    (t, good, total) cumulative samples."""

    def __init__(self, objectives: list[Objective],
                 config: SLOConfig = SLOConfig(),
                 registry: MetricsRegistry | None = None,
                 sink=None, clock=time.time):
        self.config = config
        self.objectives = list(objectives)
        self._sink = sink
        self._clock = clock
        reg = registry or get_registry()
        self._gauge = reg.gauge(
            "deepgo_slo_burn_ratio",
            "error-budget burn rate per objective (window=fast|slow); "
            "1.0 spends the budget exactly at the allowed pace")
        self._samples: dict[str, deque] = {
            o.name: deque() for o in self.objectives}
        self.states: dict[str, str] = {o.name: "ok"
                                       for o in self.objectives}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- burn arithmetic ---------------------------------------------------

    def _window_burn(self, samples: deque, now: float, window_s: float,
                     budget: float) -> tuple[float, float]:
        """(burn, bad_fraction) over [now - window_s, now]. The oldest
        in-window sample anchors the delta; fewer than two in-window
        samples (or no events between them) reads as burn 0 — no data is
        not a violation."""
        anchor = None
        for t, good, total in samples:
            if t >= now - window_s:
                anchor = (good, total)
                break
        if anchor is None or not samples:
            return 0.0, 0.0
        g1, t1 = samples[-1][1], samples[-1][2]
        d_total = t1 - anchor[1]
        if d_total <= 0:
            return 0.0, 0.0
        d_bad = max(0.0, d_total - (g1 - anchor[0]))
        bad_frac = d_bad / d_total
        return bad_frac / budget, bad_frac

    def evaluate(self, now: float | None = None) -> dict:
        """One tick: sample every objective, update windows, gauge, and
        state; emit ``slo_burn`` on transitions. Returns the per-objective
        verdict dict (what ``health()`` also reports)."""
        now = self._clock() if now is None else now
        cfg = self.config
        out: dict = {}
        for obj in self.objectives:
            try:
                good, total = obj.sample()
            except Exception as e:  # noqa: BLE001 — a broken feed is a fact
                out[obj.name] = {"state": self.states[obj.name],
                                 "error": repr(e)}
                continue
            ring = self._samples[obj.name]
            ring.append((now, good, total))
            while ring and now - ring[0][0] > cfg.slow_window_s * 1.5:
                ring.popleft()
            fast, fast_bad = self._window_burn(
                ring, now, cfg.fast_window_s, obj.budget)
            slow, slow_bad = self._window_burn(
                ring, now, cfg.slow_window_s, obj.budget)
            self._gauge.set(round(fast, 4), slo=obj.name, window="fast")
            self._gauge.set(round(slow, 4), slo=obj.name, window="slow")
            if fast >= cfg.fast_burn:
                state = "fast_burn"
            elif slow >= cfg.slow_burn:
                state = "slow_burn"
            else:
                state = "ok"
            prev = self.states[obj.name]
            verdict = {
                "state": state,
                "burn_fast": round(fast, 4),
                "burn_slow": round(slow, 4),
                "bad_fraction_fast": round(fast_bad, 6),
                "target": obj.target,
            }
            out[obj.name] = verdict
            if state != prev:
                self.states[obj.name] = state
                self._emit(slo=obj.name, from_state=prev, to_state=state,
                           time=now, **{k: v for k, v in verdict.items()
                                        if k != "state"})
                if state == "fast_burn":
                    # page-grade: ship the black box with the incident
                    flight_dump("slo_fast_burn", slo=obj.name,
                                burn_fast=verdict["burn_fast"],
                                bad_fraction=verdict["bad_fraction_fast"])
        return out

    def _emit(self, **fields) -> None:
        if self._sink is not None:
            try:
                self._sink.write("slo_burn", **fields)
                return
            except (OSError, ValueError):
                pass
        print("SLO_BURN " + json.dumps({"kind": "slo_burn", **fields}),
              flush=True)

    # -- surfaces ----------------------------------------------------------

    def health(self) -> dict:
        """ObsExporter component: degraded-but-healthy while burning.
        ``healthy`` stays True by design — SLO burn is an operator signal
        on /healthz, not a 503 (the breaker/ledger components own hard
        unhealthiness)."""
        burning = {name: state for name, state in self.states.items()
                   if state != "ok"}
        return {
            "healthy": True,
            "degraded": bool(burning),
            "burning": burning,
            "objectives": [o.describe() for o in self.objectives],
        }

    def start(self, interval_s: float = 5.0, sleep=None) -> None:
        """Background evaluator: one evaluate() + flight-recorder tick per
        interval, as a daemon thread (the production wiring for
        ``cli train --slo`` and the serving bench)."""
        if self._thread is not None:
            return
        sleep = sleep or self._stop.wait

        def loop() -> None:
            from .sentinel import get_flight_recorder

            while not self._stop.is_set():
                try:
                    self.evaluate()
                    get_flight_recorder().tick()
                except Exception as e:  # noqa: BLE001 — keep evaluating
                    print(f"slo tracker: evaluate failed: {e}",
                          file=sys.stderr, flush=True)
                sleep(interval_s)

        self._thread = threading.Thread(target=loop, name="slo-tracker",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None


def parse_slo_spec(spec: str, registry: MetricsRegistry | None = None,
                   health_fn=None) -> list[Objective]:
    """The CLI grammar: comma-separated ``name=value[@target]`` pairs.

      dispatch_ms=50         serving dispatch p-latency: 99% of coalesced
                             dispatches within 50 ms
                             (deepgo_serving_dispatch_seconds)
      request_ms=250         end-to-end request latency, same shape
      train_sps=1000         training throughput floor: 99% of ticks find
                             deepgo_train_samples_per_sec >= 1000
      availability=0.999     health-probe availability (requires a health
                             callable — the CLI passes the exporter's)

    ``@target`` overrides the default compliance target:
    ``dispatch_ms=50@0.999``. Unknown names fail loudly — an SLO that is
    silently not tracked is worse than none."""
    objectives: list[Objective] = []
    for raw in (spec or "").split(","):
        raw = raw.strip()
        if not raw:
            continue
        name, sep, rest = raw.partition("=")
        if not sep:
            raise ValueError(f"bad SLO spec {raw!r}: expected name=value")
        value, _, target_s = rest.partition("@")
        try:
            value_f = float(value)
            target = float(target_s) if target_s else None
        except ValueError:
            raise ValueError(
                f"bad SLO spec {raw!r}: value/target must be numbers"
            ) from None
        if name == "dispatch_ms":
            objectives.append(HistogramLatencyObjective(
                "serving_dispatch", "deepgo_serving_dispatch_seconds",
                value_f / 1000.0, target=target or 0.99, registry=registry))
        elif name == "request_ms":
            objectives.append(HistogramLatencyObjective(
                "serving_request", "deepgo_serving_request_seconds",
                value_f / 1000.0, target=target or 0.99, registry=registry))
        elif name == "train_sps":
            objectives.append(GaugeFloorObjective(
                "train_throughput", "deepgo_train_samples_per_sec",
                floor=value_f, target=target or 0.99, registry=registry))
        elif name == "availability":
            if health_fn is None:
                raise ValueError(
                    "availability SLO needs a health endpoint — use it "
                    "with --obs-port")
            objectives.append(HealthObjective(
                "availability", health_fn, target=value_f))
        else:
            raise ValueError(
                f"unknown SLO {name!r}; known: dispatch_ms, request_ms, "
                "train_sps, availability")
    return objectives
