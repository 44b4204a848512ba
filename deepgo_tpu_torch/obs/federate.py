"""Cross-host federation: N telemetry sources, one labeled view.

The port's copy of ``deepgo_tpu/obs/federate.py``. A fleet is never one
process: serving replicas, elastic hosts, and the
loop service each own a registry and (optionally) a time-series store.
This module joins them — live ``/metrics`` endpoints scraped over HTTP,
or run-directory stores read offline — into one keyspace where every
series carries a ``host`` label, so the dashboard and the run report
can render the fleet as one system.

Failure discipline: a dead endpoint is *data*, not an exception. One
failed scrape becomes a labeled ``ts_scrape_failed`` event plus a
``deepgo_ts_scrape_failed_total{host}`` increment and an ``ok: false``
row in the collected view; the other hosts' series are unaffected. The
federation layer must keep working while the thing it observes is
half-dead — that is the only time anybody needs it.

The scrape side parses Prometheus text exposition 0.0.4 (what
``obs/exporter.render_prometheus`` renders — but any conformant exporter
works): counters
and gauges pass through, histogram ``_bucket``/``_sum``/``_count``
ladders are re-folded into the same ``:count``/``:sum``/``:p50``/
``:p99`` series keys the local flattener produces, with quantiles
interpolated from the cumulative bucket ladder."""

from __future__ import annotations

import math
import re
import time
import urllib.request

from .registry import MetricsRegistry, get_registry
from .timeseries import (key_matches, load_samples, series_from_samples,
                         series_key)

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return (value.replace(r"\"", '"').replace(r"\n", "\n")
            .replace("\\\\", "\\"))


def _quantile_from_buckets(buckets: list[tuple[float, float]],
                           q: float) -> float | None:
    """Interpolated q-quantile from a cumulative (le, count) ladder."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    target = q * total
    prev_edge, prev_cum = 0.0, 0.0
    for edge, cum in buckets:
        if cum >= target:
            if math.isinf(edge):
                return prev_edge  # the overflow bucket has no upper edge
            span = cum - prev_cum
            frac = (target - prev_cum) / span if span > 0 else 1.0
            return prev_edge + (edge - prev_edge) * frac
        prev_edge, prev_cum = edge, cum
    return prev_edge


def parse_prometheus(text: str) -> dict[str, float]:
    """Prometheus text -> the flattened ``{series_key: value}`` sample
    format of obs/timeseries.flatten_snapshot. Unparseable lines are
    skipped (a half-written scrape is a degraded sample, not a crash)."""
    plain: dict[tuple[str, str], float] = {}
    hists: dict[tuple[str, str], dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labelstr, raw = m.group(1), m.group(2) or "", m.group(3)
        try:
            value = float(raw)
        except ValueError:
            continue
        labels = {k: _unescape(v) for k, v in _LABEL_RE.findall(labelstr)}
        if name.endswith("_bucket") and "le" in labels:
            le = labels.pop("le")
            edge = float("inf") if le in ("+Inf", "inf") else float(le)
            key = (name[:-len("_bucket")], _label_string(labels))
            hists.setdefault(key, {"buckets": []})["buckets"].append(
                (edge, value))
        elif name.endswith("_sum"):
            plain[(name, _label_string(labels))] = value
        elif name.endswith("_count"):
            plain[(name, _label_string(labels))] = value
        else:
            plain[(name, _label_string(labels))] = value
    out: dict[str, float] = {}
    for (base, label), h in hists.items():
        buckets = sorted(h["buckets"])
        count = plain.pop((base + "_count", label), None)
        total_sum = plain.pop((base + "_sum", label), None)
        if count is not None:
            out[series_key(base, label, "count")] = count
        if total_sum is not None:
            out[series_key(base, label, "sum")] = total_sum
        for q, field in ((0.50, "p50"), (0.99, "p99")):
            v = _quantile_from_buckets(buckets, q)
            if v is not None:
                out[series_key(base, label, field)] = v
    for (name, label), value in plain.items():
        out[series_key(name, label)] = value
    return out


def _label_string(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def with_labels(values: dict, **extra) -> dict[str, float]:
    """Fold labels (``host=...``, ``replica=...``) into every series key
    — the federation stamp that keeps N sources distinct in one view."""
    from .timeseries import split_key

    out: dict[str, float] = {}
    for key, value in values.items():
        name, labelstr, field = split_key(key)
        labels = dict(kv.split("=", 1)
                      for kv in labelstr.split(",") if "=" in kv)
        labels.update({k: str(v) for k, v in extra.items()})
        out[series_key(name, _label_string(labels), field)] = value
    return out


def scrape_series(url: str, timeout_s: float = 2.0) -> dict[str, float]:
    """One flattened sample from a live exporter. ``url`` may be the
    exporter base or the full ``/metrics`` path."""
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return parse_prometheus(r.read().decode("utf-8", "replace"))


class FederatedView:
    """N named sources -> one host-labeled sample per ``collect()``.

    Sources are scrape endpoints (live replicas/hosts), on-disk stores
    (offline run dirs), or arbitrary getters (tests). A source that
    raises is reported — event + counter + ``ok: false`` — and skipped;
    ``collect`` itself never raises on a source failure."""

    def __init__(self, sink=None, registry: MetricsRegistry | None = None,
                 clock=time.time, timeout_s: float = 2.0):
        self._sources: list[tuple[str, str, object]] = []
        self._sink = sink
        self._clock = clock
        self.timeout_s = timeout_s
        self._obs_failed = (registry or get_registry()).counter(
            "deepgo_ts_scrape_failed_total",
            "federation scrapes that failed, by host label")

    def add_scrape(self, host: str, url: str) -> "FederatedView":
        self._sources.append(
            (host, "scrape",
             lambda url=url: scrape_series(url, self.timeout_s)))
        return self

    def add_store(self, host: str, ts_dir: str) -> "FederatedView":
        """Offline source: the LATEST sample of a run directory's
        time-series store (the store itself keeps the history —
        ``store_series`` reads it per-metric)."""
        self._sources.append(
            (host, "store", lambda d=ts_dir: _latest_store_sample(d)))
        return self

    def add_getter(self, host: str, fn) -> "FederatedView":
        self._sources.append((host, "getter", fn))
        return self

    @property
    def hosts(self) -> list[str]:
        return [h for h, _, _ in self._sources]

    def collect(self) -> dict:
        """One federated sample: ``values`` merges every healthy source
        with ``host=`` folded into each key; ``hosts`` reports per-
        source health including the failure that excused an absence."""
        hosts: dict[str, dict] = {}
        values: dict[str, float] = {}
        for host, kind, fn in self._sources:
            try:
                sample = fn()
            except Exception as e:  # noqa: BLE001 — a dead endpoint is data, not a crash
                self._obs_failed.inc(1, host=host)
                if self._sink is not None:
                    try:
                        self._sink.write("ts_scrape_failed", host=host,
                                         source=kind,
                                         error=repr(e)[:200])
                    except Exception:  # noqa: BLE001 — best-effort event
                        pass
                hosts[host] = {"ok": False, "kind": kind,
                               "error": repr(e)[:200]}
                continue
            hosts[host] = {"ok": True, "kind": kind,
                           "series": len(sample)}
            values.update(with_labels(sample, host=host))
        return {"time": self._clock(), "hosts": hosts, "values": values}


def _latest_store_sample(ts_dir: str) -> dict[str, float]:
    samples = load_samples(ts_dir)
    if not samples:
        raise FileNotFoundError(f"no ts-*.jsonl samples under {ts_dir}")
    return dict(samples[-1].get("values") or {})


def store_series(run_dirs: dict[str, str],
                 metric: str) -> dict[str, list[tuple[float, float]]]:
    """Offline federation of full histories: ``{host: ts_dir}`` ->
    host-labeled (t, value) series for one metric family. Missing or
    empty stores contribute nothing (and never raise) — the offline
    mirror of the dead-endpoint rule."""
    out: dict[str, list[tuple[float, float]]] = {}
    for host, ts_dir in sorted(run_dirs.items()):
        per_key = series_from_samples(load_samples(ts_dir), metric)
        for key, points in per_key.items():
            labeled = next(iter(with_labels({key: 0.0}, host=host)))
            out[labeled] = points
    return out


def federated_series(collected: dict, metric: str) -> dict[str, float]:
    """Filter one ``FederatedView.collect()`` sample down to a metric
    family (host labels preserved) — the dash health-grid helper."""
    return {k: v for k, v in (collected.get("values") or {}).items()
            if key_matches(metric, k)}
