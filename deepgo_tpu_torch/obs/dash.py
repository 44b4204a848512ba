"""The operator surface: the live fleet view (dash) and the trend table.

The port's copy of ``deepgo_tpu/obs/dash.py``: the same frames and the same
``--json`` dict for the same store.

``dash`` renders one screenful an operator can actually steer by:
sparklines over the declared watchlist (obs/anomaly.DEFAULT_WATCHLIST),
a per-host/per-replica fleet health grid, the active anomaly tail, and
SLO burn state — from a run directory's on-disk time-series store
(offline / tailing a live run's directory) or from live ``/metrics``
endpoints federated client-side (obs/federate.py; series history
accumulates across refreshes in a ``DashHistory``). ``--once`` renders
a single frame and ``--json`` emits the underlying dict
(``collect_dash``).

``trend`` answers "what has the bench been saying all along": it joins
every committed ``BENCH_r*.json`` round (both artifact shapes — the
r01–r05 capture ``{n, parsed}`` and the r06+ ``{round,
captures}``) with ``BENCH_LAST_GOOD.json`` into a per-metric trajectory
table, stale captures marked, so the regression gate's verdicts finally
have a visible history.

Rendering is stdlib-only and terminal-greppable (the report.py
discipline): fixed-width tables, unicode block sparklines.
"""

from __future__ import annotations

import glob
import json
import os
import time
from collections import deque

from .anomaly import DEFAULT_WATCHLIST
from .federate import FederatedView
from .timeseries import (chunk_paths, key_field, load_samples,
                         series_from_samples, split_key)

SPARK_CHARS = "▁▂▃▄▅▆▇█"

# watch families whose value reads better in ms on the dash
_MS_FIELDS = (":p50", ":p99")


def sparkline(points: list[tuple[float, float]], width: int = 40) -> str:
    """(t, value) points -> one unicode sparkline, newest right."""
    values = [v for _, v in points][-width:]
    if not values:
        return ""
    lo, hi = min(values), max(values)
    span = hi - lo
    if span <= 0:
        return SPARK_CHARS[0] * len(values)
    return "".join(
        SPARK_CHARS[min(len(SPARK_CHARS) - 1,
                        int((v - lo) / span * len(SPARK_CHARS)))]
        for v in values)


def find_store_dir(run_dir: str) -> str:
    """Where a run keeps its chunks: the run dir itself (loop/train
    runs) or a ``ts/`` subdirectory (bench runs)."""
    if chunk_paths(run_dir):
        return run_dir
    sub = os.path.join(run_dir, "ts")
    return sub if chunk_paths(sub) else run_dir


class DashHistory:
    """Client-side sample accumulation for live scrape mode: each
    refresh's federated sample appends here, so sparklines grow across
    refreshes without any server-side store."""

    def __init__(self, window: int = 240):
        self._samples: deque = deque(maxlen=window)

    def add(self, collected: dict) -> None:
        self._samples.append({"t": collected["time"],
                              "values": collected["values"]})

    def samples(self) -> list[dict]:
        return list(self._samples)


def _rate_points(points: list[tuple[float, float]]
                 ) -> list[tuple[float, float]]:
    """Cumulative counter samples -> per-second rate points (successive
    differences over the sample gap; a counter reset clamps at 0)."""
    out = []
    for (t0, v0), (t1, v1) in zip(points, points[1:]):
        dt = t1 - t0
        if dt > 0:
            out.append((t1, max(v1 - v0, 0.0) / dt))
    return out


def _watch_section(samples: list[dict], window: int) -> dict:
    tail = samples[-window:]
    out: dict = {}
    for spec in DEFAULT_WATCHLIST:
        metric = spec.metric if spec.field is None \
            else f"{spec.metric}:{spec.field}"
        # counter families sparkline as RATES (boards/sec, requests/sec
        # per tier) — a monotone cumulative count hides exactly the
        # "when did it change" signal a sparkline exists to show
        rate = spec.mode == "counter_rate"
        if rate:
            metric = f"{spec.metric}:rate"
        per_key = {k: v for k, v in series_from_samples(
            tail, spec.metric).items() if key_field(k) == spec.field}
        if not per_key:
            continue
        rows = {}
        for key, points in sorted(per_key.items()):
            if rate:
                points = _rate_points(points)
                if not points:
                    continue
            values = [v for _, v in points]
            rows[key] = {
                "points": points,
                "last": values[-1],
                "min": min(values),
                "max": max(values),
            }
        if rows:
            out[metric] = rows
    return out


def _latest_values(samples: list[dict]) -> dict:
    return dict(samples[-1]["values"]) if samples else {}


def _fleet_section(latest: dict) -> dict:
    """Per-host fleet rows from the newest sample: replica count, the
    per-replica state gauge, and the failure counters."""
    hosts: dict[str, dict] = {}

    def row(host: str) -> dict:
        return hosts.setdefault(host, {"replica_state": {},
                                       "restarts": {}})

    for key, value in latest.items():
        name, labelstr, field = split_key(key)
        if field is not None:
            continue
        labels = dict(kv.split("=", 1)
                      for kv in labelstr.split(",") if "=" in kv)
        host = labels.get("host", "local")
        if name == "deepgo_fleet_replicas_serving":
            row(host)["replicas_serving"] = value
        elif name == "deepgo_fleet_replica_state":
            row(host)["replica_state"][labels.get("replica", "?")] = value
        elif name == "deepgo_fleet_failovers_total":
            row(host)["failovers"] = row(host).get("failovers", 0) + value
        elif name == "deepgo_fleet_respawns_total":
            row(host)["respawns"] = row(host).get("respawns", 0) + value
        elif name == "deepgo_serving_restarts_total":
            row(host)["restarts"][labels.get("engine", "?")] = value
        elif name == "deepgo_loop_learner_step":
            row(host)["learner_step"] = value
    return {h: r for h, r in sorted(hosts.items())
            if r.get("replicas_serving") is not None
            or r["replica_state"] or r["restarts"]
            or r.get("learner_step") is not None}


def _slo_section(latest: dict) -> dict:
    return {key: value for key, value in sorted(latest.items())
            if split_key(key)[0] == "deepgo_slo_burn_ratio"}


def _anomaly_totals(latest: dict) -> dict:
    return {key: value for key, value in sorted(latest.items())
            if key.startswith("deepgo_anomaly_total") and value > 0}


def _store_anomalies(run_dir: str, limit: int = 20) -> list[dict]:
    from .report import read_events

    events: list[dict] = []
    for stream in ("metrics.jsonl", "loop.jsonl", "trace.jsonl"):
        events.extend(r for r in read_events(
            os.path.join(run_dir, stream)) if r.get("kind") == "anomaly")
    events.sort(key=lambda r: r.get("t") or r.get("time") or 0.0)
    return [{k: r.get(k) for k in ("metric", "series", "detector",
                                   "value", "baseline", "score", "t")}
            for r in events[-limit:]]


def collect_dash(run_dir: str | None = None, urls: dict | None = None,
                 history: DashHistory | None = None, window: int = 240,
                 view: FederatedView | None = None,
                 clock=time.time) -> dict:
    """One dash frame as data. Exactly one of ``run_dir`` (store mode)
    or ``urls`` (``{host: url}`` scrape mode) drives it; scrape mode
    needs a ``DashHistory`` to grow sparklines across calls and accepts
    a pre-built ``FederatedView`` (tests inject getters)."""
    if run_dir is not None:
        samples = load_samples(find_store_dir(run_dir))[-window:]
        data: dict = {"mode": "store", "run_dir": run_dir,
                      "hosts": {"local": {"ok": bool(samples),
                                          "kind": "store",
                                          "series": len(_latest_values(
                                              samples))}},
                      "anomalies": _store_anomalies(run_dir)}
    elif urls or view is not None:
        if view is None:
            view = FederatedView()
            for host, url in sorted((urls or {}).items()):
                view.add_scrape(host, url)
        collected = view.collect()
        if history is not None:
            history.add(collected)
            samples = history.samples()[-window:]
        else:
            samples = [{"t": collected["time"],
                        "values": collected["values"]}]
        data = {"mode": "scrape", "hosts": collected["hosts"],
                "anomalies": []}
    else:
        raise ValueError("collect_dash needs run_dir or scrape urls")
    latest = _latest_values(samples)
    data.update(
        time=clock(),
        samples=len(samples),
        watchlist=_watch_section(samples, window),
        fleet=_fleet_section(latest),
        slo=_slo_section(latest),
        anomaly_totals=_anomaly_totals(latest),
    )
    return data


# -- rendering ---------------------------------------------------------------


def _fmt(value: float, key: str = "") -> str:
    if any(key.endswith(f) for f in _MS_FIELDS):
        return f"{value * 1000:.2f}ms"
    if value == int(value) and abs(value) < 1e12:
        return str(int(value))
    return f"{value:.4g}"


def render_dash(data: dict, width: int = 40) -> str:
    lines: list[str] = []
    src = data.get("run_dir") or ",".join(
        f"{h}{'' if v.get('ok') else '(DEAD)'}"
        for h, v in sorted(data.get("hosts", {}).items()))
    lines.append(f"deepgo dash · {data['mode']} · {src} · "
                 f"{data['samples']} samples · "
                 f"{time.strftime('%H:%M:%S', time.localtime(data['time']))}")
    dead = [h for h, v in sorted(data.get("hosts", {}).items())
            if not v.get("ok")]
    if dead:
        lines.append(f"  !! unreachable: {', '.join(dead)} "
                     "(ts_scrape_failed — serving the survivors)")
    watch = data.get("watchlist", {})
    if watch:
        lines.append("")
        lines.append("watchlist:")
        label_w = max((len(k) for rows in watch.values() for k in rows),
                      default=0)
        label_w = min(label_w, 72)
        for metric, rows in watch.items():
            # rate-derived families (":rate") show per-second values
            unit = "/s" if metric.endswith(":rate") else ""
            for key, row in rows.items():
                lines.append(
                    f"  {key[:72].ljust(label_w)}  "
                    f"{sparkline(row['points'], width).ljust(width)}  "
                    f"last {_fmt(row['last'], key)}{unit}  "
                    f"[{_fmt(row['min'], key)} .. "
                    f"{_fmt(row['max'], key)}{unit}]")
    fleet = data.get("fleet", {})
    if fleet:
        lines.append("")
        lines.append("fleet health:")
        for host, row in fleet.items():
            states = row.get("replica_state", {})
            grid = " ".join(
                f"r{rid}:{'UP' if v >= 1.0 else 'DRAIN' if v > 0 else 'DOWN'}"
                for rid, v in sorted(states.items())) or "-"
            extras = []
            for k in ("replicas_serving", "failovers", "respawns",
                      "learner_step"):
                if row.get(k) is not None:
                    extras.append(f"{k}={_fmt(row[k])}")
            restarts = row.get("restarts", {})
            if restarts and sum(restarts.values()):
                extras.append("restarts=" + ",".join(
                    f"{e}:{_fmt(v)}" for e, v in sorted(restarts.items())
                    if v))
            lines.append(f"  {host}: {grid}  {' '.join(extras)}")
    anomalies = data.get("anomalies") or []
    totals = data.get("anomaly_totals") or {}
    lines.append("")
    if anomalies:
        lines.append(f"anomalies (last {len(anomalies)}):")
        for a in anomalies:
            t = a.get("t")
            stamp = time.strftime("%H:%M:%S", time.localtime(t)) \
                if t else "?"
            lines.append(
                f"  {stamp}  {a.get('detector', '?'):5s}  "
                f"{a.get('series') or a.get('metric')}  "
                f"value {_fmt(float(a.get('value') or 0.0))} vs baseline "
                f"{_fmt(float(a.get('baseline') or 0.0))} "
                f"(score {a.get('score')})")
    elif totals:
        lines.append("anomalies (counters — events live in the run dir):")
        for key, value in totals.items():
            lines.append(f"  {key}: {_fmt(value)}")
    else:
        lines.append("anomalies: none")
    slo = data.get("slo", {})
    if slo:
        lines.append("")
        lines.append("slo burn:")
        for key, value in slo.items():
            state = "BURNING" if value >= 1.0 else "ok"
            lines.append(f"  {key}: {value:.3g} ({state})")
    return "\n".join(lines)


# -- trend -------------------------------------------------------------------


def _round_captures(payload: dict) -> tuple[int | None, list[dict]]:
    """Both committed artifact shapes -> (round number, result dicts)."""
    if "captures" in payload:
        return payload.get("round"), [r for r in payload["captures"]
                                      .values() if isinstance(r, dict)]
    if "parsed" in payload:
        parsed = payload["parsed"]
        return payload.get("n"), [parsed] if isinstance(parsed, dict) else []
    return None, []


def collect_trend(root: str = ".") -> dict:
    """Every ``BENCH_r*.json`` round + the last-good table, joined into
    ``{metrics: {metric: {round: {value, stale}}}}``. Unreadable files
    are skipped with a note (history outlives format churn)."""
    rounds: list[int] = []
    metrics: dict[str, dict] = {}
    skipped: list[str] = []
    for path in sorted(glob.glob(os.path.join(root, "BENCH_r*.json"))):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            skipped.append(os.path.basename(path))
            continue
        rnd, captures = _round_captures(payload)
        if rnd is None or not captures:
            skipped.append(os.path.basename(path))
            continue
        rounds.append(int(rnd))
        for res in captures:
            metric = res.get("metric")
            if not metric or res.get("value") is None:
                continue
            metrics.setdefault(metric, {})[int(rnd)] = {
                "value": res["value"],
                "stale": bool(res.get("stale")),
                "unit": res.get("unit"),
                "device": res.get("device")
                or (res.get("last_good") or {}).get("device"),
            }
    last_good: dict[str, dict] = {}
    try:
        with open(os.path.join(root, "BENCH_LAST_GOOD.json")) as f:
            table = json.load(f)
        for metric, entry in table.items():
            if isinstance(entry, dict) and entry.get("value") is not None:
                last_good[metric] = {
                    "value": entry["value"],
                    "device": entry.get("device"),
                    "timestamp": entry.get("timestamp"),
                }
    except (OSError, ValueError):
        pass
    return {"rounds": sorted(set(rounds)), "metrics": metrics,
            "last_good": last_good, "skipped": skipped}


def render_trend(data: dict) -> str:
    rounds = data["rounds"]
    if not rounds and not data["last_good"]:
        return "no BENCH_r*.json rounds found"
    cols = ["metric"] + [f"r{r:02d}" for r in rounds] + ["last-good"]
    names = sorted(set(data["metrics"]) | set(data["last_good"]))
    rows = []
    for metric in names:
        per_round = data["metrics"].get(metric, {})
        row = [metric]
        for r in rounds:
            cell = per_round.get(r)
            if cell is None:
                row.append("-")
            else:
                row.append(f"{cell['value']:g}"
                           + ("*" if cell["stale"] else ""))
        lg = data["last_good"].get(metric)
        row.append(f"{lg['value']:g}" if lg else "-")
        rows.append(row)
    widths = [max(len(c), *(len(r[i]) for r in rows))
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths)),
             "  ".join("-" * w for w in widths)]
    lines.extend("  ".join(v.ljust(w) for v, w in zip(r, widths))
                 for r in rows)
    lines.append("")
    lines.append("* = stale capture (the committed last-good value, "
                 "re-quoted because that round measured nothing live)")
    if data["skipped"]:
        lines.append(f"skipped unreadable: {', '.join(data['skipped'])}")
    return "\n".join(lines)
