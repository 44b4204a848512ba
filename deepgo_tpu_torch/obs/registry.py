"""Process-wide metrics registry: labeled counters, gauges, histograms.

The port's copy of ``deepgo_tpu/obs/registry.py``: monotonic counters,
last-value gauges, and fixed-bucket histograms with percentile snapshots,
snapshottable as one dict. ``tests/test_torch_variants.py`` holds its
snapshots equal to the JAX package's after the same operations. One change:
the JAX file takes its locks from the lock-order checker
(``analysis.lockcheck.make_lock``), which is not ported yet; here every
lock is a plain ``threading.Lock``.

Design rules, as in the JAX package:

  * thread-safe — one lock per metric family keeps contention off the hot
    path (no global lock);
  * injectable clock — `Histogram.time()` and snapshot timestamps take
    the registry's clock, so tests drive every duration with a fake
    clock and never sleep;
  * labels are kwargs — `counter.inc(engine="policy")` — and each label
    combination is an independent series (the Prometheus data model);
  * fixed buckets — histograms never allocate per-observation; the
    percentile snapshot interpolates inside the owning bucket, with the
    observed min/max pinning the edge buckets.

A process-wide default registry (`get_registry()`) is what the built-in
instrumentation uses (the serving variants' tolerance gauges); tests that
need isolation construct private `MetricsRegistry` instances.
"""

from __future__ import annotations

import bisect
import re
import threading
import time


# seconds-scale latency ladder: sub-millisecond loader waits up to
# multi-second recoveries land in distinct buckets
DEFAULT_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Metric:
    """Base: one named family of label-keyed series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not _NAME_RE.match(name):
            # typed, never assert: a bad metric name must fail at
            # registration under ``python -O`` too, not at scrape time
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    def labelnames(self) -> list[tuple]:
        with self._lock:
            return list(self._series)


class Counter(Metric):
    """Monotonically increasing count per label set."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def collect(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)


class Gauge(Metric):
    """Last-set value per label set; ``set_function`` registers a live
    callable read at collect time (queue depths, breaker states)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            current = self._series.get(key, 0.0)
            if callable(current):
                raise ValueError(
                    f"gauge {self.name}{dict(key)} is callback-backed")
            self._series[key] = float(current) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_function(self, fn, **labels) -> None:
        """Collect-time callback: the scrape reads ``fn()`` live. A raising
        callback reads as the last resort value 0.0 — a scrape must never
        crash on a dying component (that is what /healthz is for)."""
        with self._lock:
            self._series[_label_key(labels)] = fn

    def value(self, **labels) -> float:
        with self._lock:
            v = self._series.get(_label_key(labels), 0.0)
        if callable(v):
            try:
                return float(v())
            except Exception:
                return 0.0
        return float(v)

    def collect(self) -> dict[tuple, float]:
        with self._lock:
            items = list(self._series.items())
        out = {}
        for key, v in items:
            if callable(v):
                try:
                    v = float(v())
                except Exception:
                    v = 0.0
            out[key] = float(v)
        return out


class _HistSeries:
    __slots__ = ("counts", "total", "sum", "vmin", "vmax")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf overflow bucket
        self.total = 0
        self.sum = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")


class Histogram(Metric):
    """Fixed-bucket distribution per label set.

    ``observe()`` is O(log buckets) and allocation-free — cheap enough for
    the loader-wait and dispatch-latency hot paths. Percentiles come from
    bucket interpolation: exact to within one bucket's width, with the
    running min/max tightening the estimate at the edges (a dataset that
    fits one bucket still reports a sane spread)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS_S):
        super().__init__(name, help)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name} buckets must be a sorted "
                             f"non-empty sequence, got {buckets!r}")
        self.buckets = tuple(float(b) for b in buckets)

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = _label_key(labels)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            s.counts[i] += 1
            s.total += 1
            s.sum += value
            s.vmin = min(s.vmin, value)
            s.vmax = max(s.vmax, value)

    def time(self, clock=None, **labels):
        """Context manager observing the wrapped block's duration."""
        return _Timer(self, clock or time.monotonic, labels)

    def _percentile(self, s: _HistSeries, q: float) -> float:
        """Interpolated q-quantile (0 < q <= 1) from the bucket counts."""
        target = q * s.total
        edges = self.buckets
        cum = 0
        for i, c in enumerate(s.counts):
            if c == 0:
                continue
            lo = edges[i - 1] if i > 0 else min(s.vmin, edges[0])
            hi = edges[i] if i < len(edges) else s.vmax
            # clamp both edges by the observed extremes: a bucket's
            # occupants cannot lie outside [vmin, vmax]
            lo = max(lo, s.vmin)
            hi = min(hi, s.vmax)
            if cum + c >= target:
                frac = (target - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return s.vmax

    def snapshot(self, **labels) -> dict | None:
        """count / sum / min / max / p50 / p95 / p99 for one label set,
        or None before the first observation."""
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None or s.total == 0:
                return None
            counts = list(s.counts)
            frozen = _HistSeries(len(self.buckets))
            frozen.counts, frozen.total = counts, s.total
            frozen.sum, frozen.vmin, frozen.vmax = s.sum, s.vmin, s.vmax
        return {
            "count": frozen.total,
            "sum": round(frozen.sum, 9),
            "min": frozen.vmin,
            "max": frozen.vmax,
            "mean": frozen.sum / frozen.total,
            "p50": self._percentile(frozen, 0.50),
            "p95": self._percentile(frozen, 0.95),
            "p99": self._percentile(frozen, 0.99),
        }

    def collect(self) -> dict[tuple, dict]:
        with self._lock:
            keys = list(self._series)
        return {k: self.snapshot(**dict(k)) for k in keys}

    def collect_raw(self) -> dict[tuple, tuple[list[int], int, float]]:
        """(bucket counts, total, sum) per series — the exporter's
        cumulative ``_bucket`` rendering needs the raw counts."""
        with self._lock:
            return {k: (list(s.counts), s.total, s.sum)
                    for k, s in self._series.items()}


class _Timer:
    def __init__(self, hist: Histogram, clock, labels: dict):
        self._hist = hist
        self._clock = clock
        self._labels = labels

    def __enter__(self):
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc):
        self._hist.observe(self._clock() - self._t0, **self._labels)


class MetricsRegistry:
    """One namespace of metrics; get-or-create semantics per name.

    Re-registering an existing name returns the existing metric when the
    kind matches (instrumented modules can be imported in any order) and
    raises when it doesn't (two subsystems fighting over one name is a
    bug, not a race to tolerate)."""

    def __init__(self, clock=time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, requested {cls.kind}")
                return existing
            metric = self._metrics[name] = cls(name, help, **kw)
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS_S) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def metrics(self) -> list[Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """Everything the registry knows, as one JSON-serializable dict:
        {name: {kind, help, series: {label-string: value-or-histogram}}}.
        This is what bench attaches to its JSON artifacts and what the
        train loop writes as the final ``obs_snapshot`` metrics event."""
        out: dict = {"time": self._clock(), "metrics": {}}
        for m in self.metrics():
            series = {}
            for key, value in m.collect().items():
                label = ",".join(f"{k}={v}" for k, v in key) or ""
                series[label] = value
            out["metrics"][m.name] = {
                "kind": m.kind, "help": m.help, "series": series}
        return out


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every built-in instrumentation point
    uses; the exporter scrapes it and bench snapshots it."""
    return _default
