"""The rotating JSONL sink and its reader.

The port's copy of ``JsonlSink`` and ``sink_files`` from
``deepgo_tpu/obs/exporter.py`` and of ``read_events`` from
``deepgo_tpu/obs/report.py``, and the Prometheus text renderer
``render_prometheus`` that federation reads. The HTTP exporter
(``/metrics``, ``/healthz``) is not ported yet.

``JsonlSink`` is an append-only JSONL event stream: idempotent close,
context-manager support, thread-safe writes, and size-based rotation
(``path`` -> ``path.1`` -> ``path.2`` ...) so a long run cannot grow one
file without bound. ``read_events`` reads a (possibly rotated) stream back,
oldest first, skipping torn lines.
"""

from __future__ import annotations

import json
import os
import time

from ..analysis.lockcheck import make_lock
from .registry import Counter, Gauge, Histogram, MetricsRegistry


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
