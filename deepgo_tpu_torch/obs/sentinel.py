"""Regression sentinel: the noise-aware bench gate + the crash flight
recorder.

The port's copy of ``deepgo_tpu/obs/sentinel.py``, its lock from the
lock-order checker as in the JAX package. Two enforcement tools that turn passive
observability into a gate and a black box:

  * **gate** — ``evaluate_gate`` compares a fresh bench result against a
    last-good record and returns a typed verdict, so a benchmark can fold
    it into its result and exit nonzero on ``fail``: a regression breaks
    loudly where it is made. Noise-aware three ways: a relative threshold sits
    above measured run-to-run jitter, a warn band below it flags drift
    without failing, and when either side of the comparison recorded its
    own repeat spread (``noise_frac``) the effective threshold widens to
    cover it. Cross-device comparisons are refused (``skip``): a CPU smoke
    value regressing against an accelerator capture is not a measurement.

  * **flight recorder** — a ring buffer of the last N seconds of registry
    snapshots plus the most recent completed spans, dumped atomically as
    ``flight-NNNN.json`` when an incident trips: a supervisor engine
    restart, an elastic ``HostLost``, an SLO fast burn, a telemetry
    anomaly (obs/anomaly.py — those dumps additionally carry the
    surrounding ``series_window`` section the detector registers), or an
    external watchdog about to fire (the watchdog child sends SIGUSR1 one second
    before the SIGKILL; ``install_signal_dump`` makes that signal dump —
    best-effort, since a C-level GIL-held wedge cannot run any Python,
    signal handlers included). Disabled by default (zero overhead);
    ``configure`` arms it with a dump directory. Every dump path is
    exception-proof: the postmortem must never mask the fault it records.
"""

from __future__ import annotations

import json
import os
import re
import signal
import sys
import time
from collections import deque
from dataclasses import dataclass

from ..analysis.lockcheck import make_lock
from .registry import MetricsRegistry, get_registry
from .spans import add_span_listener, remove_span_listener

# ---- the regression gate ----

# metrics where a LOWER fresh value is the improvement; everything else
# (throughput) is higher-is-better
LOWER_IS_BETTER = frozenset({
    "policy_inference_latency_ms",
    "distributed_elastic_recovery_latency_s",
})


@dataclass(frozen=True)
class GateConfig:
    """Knobs for one gate evaluation. ``threshold`` is the relative
    regression that fails (default 10 %); ``warn_threshold`` opens a
    warn-only band below it; ``noise_multiplier`` scales a recorded
    repeat spread into extra threshold headroom (2x: the fresh value and
    the baseline each wobble by up to one spread)."""

    threshold: float = 0.10
    warn_threshold: float = 0.05
    noise_multiplier: float = 2.0
    require_device_match: bool = True


def evaluate_gate(result: dict, last_good: dict | None,
                  config: GateConfig = GateConfig()) -> dict:
    """Compare one fresh bench result against its last-good record.

    Returns ``{"verdict": "pass"|"warn"|"fail"|"skip", "reason", ...}``
    with the regression arithmetic spelled out. ``skip`` (no baseline,
    device mismatch, stale/errored fresh run) deliberately does NOT fail:
    the gate enforces regressions it can measure, never punishes missing
    data."""
    metric = result.get("metric", "?")
    out: dict = {"metric": metric, "threshold": config.threshold}
    value = result.get("value")
    if result.get("stale") or result.get("error") or not value:
        out.update(verdict="skip",
                   reason="fresh run is stale/errored — nothing measured "
                          "to gate on")
        return out
    if not last_good or not last_good.get("value"):
        out.update(verdict="skip",
                   reason=f"no last-good record for {metric}")
        return out
    base = float(last_good["value"])
    fresh_dev, base_dev = result.get("device"), last_good.get("device")
    if config.require_device_match and fresh_dev != base_dev:
        out.update(verdict="skip",
                   reason=f"device mismatch: fresh {fresh_dev!r} vs "
                          f"last-good {base_dev!r} — cross-device ratios "
                          "are not regressions")
        return out
    if metric in LOWER_IS_BETTER:
        regression = (float(value) - base) / base
    else:
        regression = (base - float(value)) / base
    noise = max(float(result.get("noise_frac") or 0.0),
                float(last_good.get("noise_frac") or 0.0))
    effective = max(config.threshold, config.noise_multiplier * noise)
    out.update(baseline=base, value=value,
               regression=round(regression, 4),
               effective_threshold=round(effective, 4),
               baseline_timestamp=last_good.get("timestamp"),
               baseline_git_sha=last_good.get("git_sha"))
    if noise:
        out["noise_frac"] = round(noise, 4)
    if regression >= effective:
        out.update(verdict="fail",
                   reason=f"{regression:.1%} regression vs last-good "
                          f"{base:g} (threshold {effective:.1%})")
    elif regression >= min(config.warn_threshold, effective):
        out.update(verdict="warn",
                   reason=f"{regression:.1%} drift vs last-good {base:g} "
                          f"(within the {effective:.1%} gate, above the "
                          f"{config.warn_threshold:.1%} warn band)")
    else:
        out.update(verdict="pass",
                   reason=f"regression {regression:+.1%} vs last-good "
                          f"{base:g} (negative = improvement), within "
                          f"the {effective:.1%} gate")
    return out


# ---- the flight recorder ----

_FLIGHT_RE = re.compile(r"^flight-(\d+)\.json$")


class FlightRecorder:
    """In-memory black box: registry snapshots + spans, dumped on fault.

    ``tick()`` (called from the train-loop window boundary and the SLO
    evaluator thread) appends one registry snapshot to a time-bounded ring;
    completed spans stream in via the spans listener hook. ``dump()``
    freezes the ring — plus one final snapshot taken at dump time — into an
    atomically-written ``flight-NNNN.json``. Everything is a no-op until
    ``configure()`` arms it, so unconfigured processes pay nothing."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 window_s: float = 120.0, max_snapshots: int = 256,
                 max_spans: int = 512, clock=time.time):
        self._registry = registry or get_registry()
        self.window_s = window_s
        self.enabled = False
        self.dump_dir: str | None = None
        self._clock = clock
        self._lock = make_lock("obs.flight")
        self._snapshots: deque = deque(maxlen=max_snapshots)
        self._spans: deque = deque(maxlen=max_spans)
        # extra dump sections: name -> zero-arg callable returning JSON-
        # serializable data, evaluated at dump time (the request-tracing
        # exemplar ring registers here, so every incident postmortem
        # carries the slow/failed request anatomy, not just aggregates)
        self._sections: dict[str, object] = {}
        self.dumps: list[str] = []

    def configure(self, dump_dir: str, window_s: float | None = None,
                  registry: MetricsRegistry | None = None) -> "FlightRecorder":
        """Arm the recorder (idempotent; re-configuring moves the dump
        directory). Registers the span listener on first arm."""
        if window_s is not None:
            self.window_s = window_s
        if registry is not None:
            self._registry = registry
        self.dump_dir = dump_dir
        if not self.enabled:
            self.enabled = True
            add_span_listener(self.record_span)
        return self

    def close(self) -> None:
        if self.enabled:
            self.enabled = False
            remove_span_listener(self.record_span)

    def add_section(self, name: str, fn) -> None:
        """Register ``fn() -> json-serializable`` to ride in every dump
        under ``name``. Re-registering a name replaces the provider;
        a raising provider is reported inline, never masks the dump."""
        with self._lock:
            self._sections[name] = fn

    def remove_section(self, name: str) -> None:
        with self._lock:
            self._sections.pop(name, None)

    def record_span(self, record: dict) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._spans.append(record)

    def tick(self) -> None:
        """Capture one registry snapshot into the ring. Cheap enough for
        a per-print-window cadence; never raises (a dying registry must
        not take the loop down with it)."""
        if not self.enabled:
            return
        try:
            snap = self._registry.snapshot()
        except Exception:  # noqa: BLE001 — observers never raise out
            return
        now = self._clock()
        with self._lock:
            self._snapshots.append((now, snap))
            self._evict(now)

    def _evict(self, now: float) -> None:
        while self._snapshots and now - self._snapshots[0][0] > self.window_s:
            self._snapshots.popleft()

    def _next_path(self) -> str:
        taken = [-1]
        try:
            for name in os.listdir(self.dump_dir):
                m = _FLIGHT_RE.match(name)
                if m:
                    taken.append(int(m.group(1)))
        except OSError:
            pass
        return os.path.join(self.dump_dir,
                            f"flight-{max(taken) + 1:04d}.json")

    def dump(self, reason: str, **detail) -> str | None:
        """Freeze the ring to disk; returns the path, or None when the
        recorder is unarmed or the write itself failed (logged — a failed
        postmortem is a fact, not an exception)."""
        if not self.enabled or not self.dump_dir:
            return None
        try:
            final = self._registry.snapshot()
        except Exception:  # noqa: BLE001
            final = None
        with self._lock:
            # ring time LAST: the registry snapshot carries its own
            # "time" (its clock), which must not mask the ring position
            snapshots = [{**s, "time": t} for t, s in self._snapshots]
            spans = list(self._spans)
            sections = dict(self._sections)
        extra = {}
        for name, fn in sections.items():
            try:
                extra[name] = fn()
            except Exception as e:  # noqa: BLE001 — reported, not raised
                extra[name] = {"error": repr(e)}
        record = {
            "kind": "flight_recorder",
            "reason": reason,
            "time": self._clock(),
            "window_s": self.window_s,
            "detail": detail,
            "snapshots": snapshots,
            "final_snapshot": final,
            "spans": spans,
            **extra,
        }
        from ..utils.atomicio import atomic_write

        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = self._next_path()
            with atomic_write(path, mode="w") as f:
                json.dump(record, f, default=str)
        except (OSError, ValueError, TypeError) as e:
            print(f"flight recorder: dump for {reason!r} failed: {e}",
                  file=sys.stderr, flush=True)
            return None
        self.dumps.append(path)
        print(f"flight recorder: {reason} -> {path} "
              f"({len(snapshots)} snapshots, {len(spans)} spans)",
              file=sys.stderr, flush=True)
        return path


_recorder: FlightRecorder | None = None


def get_flight_recorder() -> FlightRecorder:
    """The process-wide recorder every trigger site dumps through.
    Unconfigured (the default) it is inert."""
    global _recorder
    if _recorder is None:
        _recorder = FlightRecorder()
    return _recorder


def configure_flight(dump_dir: str, **kw) -> FlightRecorder:
    """Arm the process-wide recorder. ``DEEPGO_FLIGHT=0`` vetoes — an
    operator's off switch that every wiring site honors."""
    rec = get_flight_recorder()
    if os.environ.get("DEEPGO_FLIGHT") == "0":
        return rec
    return rec.configure(dump_dir, **kw)


def flight_dump(reason: str, **detail) -> str | None:
    """Trigger-site convenience: dump the process-wide recorder (no-op
    while unarmed). Used by the serving supervisor (engine restart), the
    elastic loop (HostLost), the SLO tracker (fast burn), and the
    telemetry anomaly detector (obs/anomaly.py)."""
    return get_flight_recorder().dump(reason, **detail)


def install_signal_dump(signum: int = signal.SIGUSR1) -> bool:
    """Make ``signum`` dump the flight recorder — the external watchdog's
    pre-kill grace signal (utils/watchdog.arm(flight=True)) lands here.
    Returns False when the handler cannot be installed (non-main thread)
    or a caller already owns the signal; best-effort by design."""
    def _handler(sig, frame):  # noqa: ARG001 — signal contract
        flight_dump("signal", signum=sig)

    try:
        existing = signal.getsignal(signum)
        if existing not in (signal.SIG_DFL, signal.SIG_IGN, None,
                            signal.default_int_handler) \
                and getattr(existing, "__qualname__", "") != \
                _handler.__qualname__:
            return False
        signal.signal(signum, _handler)
        return True
    except (ValueError, OSError):  # non-main thread / unsupported platform
        return False
