"""The rotating JSONL sink, its reader, and the live HTTP endpoint.

The port's copy of ``deepgo_tpu/obs/exporter.py`` (and of ``read_events``
from ``deepgo_tpu/obs/report.py``): ``JsonlSink`` and ``sink_files``, the
Prometheus text renderer ``render_prometheus`` that federation reads, and
``ObsExporter`` — a daemon-thread HTTP server (stdlib ``http.server``):
``/metrics`` renders the registry in Prometheus text format, ``/healthz``
composes registered health callables into one JSON verdict (HTTP 200 when
every component is healthy, 503 the moment one is not), ``/trace`` the
live tail-exemplar ring, ``/cost`` the cost ledger and ``/series`` the
recent window of the live time-series store (``?metric=NAME`` for aligned
(t, value) points). Port 0 binds an ephemeral port; ``exporter.port``
reports the real one. ``close()`` is idempotent.

``JsonlSink`` is an append-only JSONL event stream: idempotent close,
context-manager support, thread-safe writes, and size-based rotation
(``path`` -> ``path.1`` -> ``path.2`` ...) so a long run cannot grow one
file without bound. ``read_events`` reads a (possibly rotated) stream back,
oldest first, skipping torn lines.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..analysis.lockcheck import make_lock
from .registry import Counter, Gauge, Histogram, MetricsRegistry, get_registry


class JsonlSink:
    """Append-only JSONL event stream with size-based rotation."""

    def __init__(self, path: str, max_bytes: int = 0, max_files: int = 5,
                 buffering: int = 1):
        """``max_bytes=0`` disables rotation (the historical MetricsWriter
        behavior). With rotation on, a write that would push the current
        file past ``max_bytes`` first shifts ``path.N`` -> ``path.N+1``
        (dropping anything past ``max_files``) and renames ``path`` to
        ``path.1`` — newest-first numbering, logrotate-style, so readers
        concatenate ``path.N .. path.1, path`` for the full stream.
        ``buffering`` is the underlying file mode: 1 (default) flushes
        per line — every record durable the instant write() returns;
        high-rate streams (the workload recorder) pass a block size and
        ``flush()`` on idle instead, trading bounded staleness for not
        paying a syscall per record (readers are torn-line-tolerant
        either way)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.max_bytes = max_bytes
        self.max_files = max_files
        self._buffering = buffering
        self._lock = make_lock(f"obs.sink.{os.path.basename(path)}")
        self._f = open(path, "a", buffering=buffering)
        self._size = self._f.tell()

    def write(self, kind: str, **fields) -> None:
        record = {"kind": kind, "time": time.time(), **fields}
        line = json.dumps(record) + "\n"
        with self._lock:
            if self._f.closed:
                raise ValueError(f"JsonlSink({self.path}) is closed")
            if (self.max_bytes > 0 and self._size > 0
                    and self._size + len(line) > self.max_bytes):
                self._rotate()
            self._f.write(line)
            self._size += len(line)

    def _rotate(self) -> None:
        self._f.close()
        for n in range(self.max_files - 1, 0, -1):
            src = f"{self.path}.{n}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{n + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a", buffering=self._buffering)
        self._size = 0

    def flush(self) -> None:
        """Push buffered records to the OS (block-buffered sinks)."""
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        """Idempotent: the supervisor, the experiment, and an atexit hook
        may all reasonably close the same sink."""
        with self._lock:
            if not self._f.closed:
                self._f.close()

    @property
    def closed(self) -> bool:
        return self._f.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def sink_files(path: str, max_files: int | None = None) -> list[str]:
    """Every existing file of a (possibly rotated) sink, oldest first —
    what read-side consumers concatenate for the full stream. Rotations
    are discovered on disk (``path.N``), so readers need not know the
    writer's retention setting; ``max_files`` optionally caps how many
    rotations to include (newest-first)."""
    import glob as _glob
    import re as _re

    numbered = []
    pattern = _re.compile(_re.escape(os.path.basename(path)) + r"\.(\d+)$")
    for p in _glob.glob(path + ".*"):
        m = pattern.match(os.path.basename(p))
        if m:
            numbered.append((int(m.group(1)), p))
    numbered.sort()  # .1 is newest; oldest = highest N
    if max_files is not None:
        numbered = numbered[:max_files]
    out = [p for _, p in reversed(numbered)]
    if os.path.exists(path):
        out.append(path)
    return out


def read_events(path: str) -> list[dict]:
    """Every record of a (possibly rotated) JSONL stream, oldest first.
    Corrupt lines are skipped — a report over a killed run must work on
    a stream whose final line was torn mid-write."""
    out: list[dict] = []
    for p in sink_files(path):
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    return out


# ---- Prometheus text rendering ----


def _escape_label(value: object) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(key: tuple, extra: tuple = ()) -> str:
    items = list(key) + list(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + inner + "}"


def render_prometheus(registry: MetricsRegistry) -> str:
    """The registry in Prometheus text exposition format 0.0.4."""
    lines: list[str] = []
    for m in registry.metrics():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for key, (counts, total, total_sum) in sorted(
                    m.collect_raw().items()):
                cum = 0
                for edge, c in zip(m.buckets, counts):
                    cum += c
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(key, (('le', f'{edge:g}'),))} {cum}")
                cum += counts[-1]
                lines.append(
                    f"{m.name}_bucket{_fmt_labels(key, (('le', '+Inf'),))} "
                    f"{cum}")
                lines.append(f"{m.name}_sum{_fmt_labels(key)} {total_sum:g}")
                lines.append(f"{m.name}_count{_fmt_labels(key)} {total}")
        elif isinstance(m, (Counter, Gauge)):
            for key, value in sorted(m.collect().items()):
                lines.append(f"{m.name}{_fmt_labels(key)} {value:g}")
    return "\n".join(lines) + "\n"


# ---- the live endpoint ----


def health_from_engine(engine):
    """Health callable over a SupervisedEngine (or anything exposing
    ``health()`` with a ``state`` field): healthy while serving."""

    def check() -> dict:
        h = engine.health()
        return {"healthy": h.get("state") == "serving", **h}

    return check


def health_from_ledger(ledger, expected):
    """Health callable over a HeartbeatLedger: healthy while no expected
    peer's silence exceeds the miss budget. ``expected`` is a callable
    returning the peer ids to watch (the surviving set shrinks as the
    elastic loop recovers, so it must be read live, not captured)."""

    def check() -> dict:
        from ..parallel.liveness import HostLost

        try:
            ledger.check_liveness(expected())
        except HostLost as e:
            return {"healthy": False, "error": str(e),
                    "lost_process_id": e.process_id,
                    "silent_for_s": round(e.silent_for_s, 3),
                    "budget_s": e.budget_s}
        snap = ledger.snapshot()
        return {"healthy": True, "budget_s": snap["budget_s"],
                "hosts": {str(k): v for k, v in snap["hosts"].items()}}

    return check


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        exporter: ObsExporter = self.server.exporter  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = render_prometheus(exporter.registry).encode()
            self._reply(200, body, "text/plain; version=0.0.4")
        elif path == "/healthz":
            payload, healthy = exporter.check_health()
            self._json(200 if healthy else 503, payload)
        elif path == "/trace":
            # the live tail-exemplar view: the request-tracing ring and
            # its accounting, while the process serves (obs/tracing.py)
            from .tracing import get_trace_recorder

            rec = get_trace_recorder()
            payload = {"enabled": rec is not None}
            if rec is not None:
                payload["stats"] = rec.stats()
                payload["exemplars"] = rec.exemplars()
            self._json(200, payload)
        elif path == "/cost":
            # the cost ledger (obs/costmodel.py) as installed by cli cost
            # or the train loop
            from .costmodel import get_cost_ledger

            ledger = get_cost_ledger()
            payload = {"enabled": ledger is not None}
            if ledger is not None:
                payload["ledger"] = ledger.to_dict()
            self._json(200, payload)
        elif path == "/series":
            # the recent telemetry window from the live time-series store
            # (obs/timeseries.py): ?metric=NAME[&n=POINTS] returns aligned
            # (t, value) points per matching series key; without
            # ?metric=, the known keys. Served from the store's in-memory
            # tail: a scrape never touches the chunk files.
            from urllib.parse import parse_qs

            from .timeseries import get_live_store

            qs = parse_qs(self.path.partition("?")[2])
            store = get_live_store()
            payload = {"enabled": store is not None}
            if store is not None:
                metric = qs.get("metric", [None])[0]
                try:
                    n = max(1, int(qs.get("n", ["240"])[0]))
                except ValueError:
                    n = 240
                if metric:
                    payload["metric"] = metric
                    payload["series"] = store.recent_series(metric, n)
                else:
                    payload["keys"] = sorted(
                        {k for rec in store.recent_window(n)
                         for k in (rec.get("values") or {})})
            self._json(200, payload)
        else:
            self._reply(404, b"not found\n", "text/plain")

    def _json(self, code: int, payload: dict) -> None:
        body = (json.dumps(payload, default=str) + "\n").encode()
        self._reply(code, body, "application/json")

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args) -> None:
        pass  # scrapes are high-frequency; stderr is for failures


class ObsExporter:
    """Daemon-thread HTTP endpoint over one registry + health callables."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: MetricsRegistry | None = None):
        self.registry = registry or get_registry()
        self._health_fns: dict[str, object] = {}
        self._lock = make_lock("obs.exporter")
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._server.exporter = self  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-exporter",
            daemon=True)
        self._thread.start()
        self._closed = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def add_health(self, name: str, fn) -> None:
        """Register one component check: ``fn() -> dict`` with a boolean
        ``healthy`` key (missing reads as healthy). Re-registering a name
        replaces the check."""
        with self._lock:
            self._health_fns[name] = fn

    def remove_health(self, name: str) -> None:
        with self._lock:
            self._health_fns.pop(name, None)

    def check_health(self) -> tuple[dict, bool]:
        """(payload, overall): overall is the AND over components; a
        raising check reads as unhealthy with the error in the payload."""
        with self._lock:
            fns = dict(self._health_fns)
        components = {}
        healthy = True
        degraded = False
        for name, fn in sorted(fns.items()):
            try:
                detail = dict(fn())
            except Exception as e:  # noqa: BLE001 — reported, not raised
                detail = {"healthy": False, "error": repr(e)}
            ok = bool(detail.get("healthy", True))
            detail["healthy"] = ok
            healthy = healthy and ok
            # degraded (an SLO burning, a breaker half-open) is an
            # operator signal, not a 503: load balancers keep the replica
            degraded = degraded or bool(detail.get("degraded"))
            components[name] = detail
        return ({"healthy": healthy, "degraded": degraded,
                 "time": time.time(), "components": components}, healthy)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_exporter(port: int, host: str = "127.0.0.1",
                   registry: MetricsRegistry | None = None) -> ObsExporter:
    """The CLI's ``--obs-port`` paths: start an exporter and print the
    bound URL once, so an operator watching stdout knows where to curl."""
    exporter = ObsExporter(port=port, host=host, registry=registry)
    print(f"obs: serving /metrics and /healthz at {exporter.url}",
          flush=True)
    return exporter
