"""Metrics and run-registry logging.

The port's copy of ``deepgo_tpu/utils/metrics.py``: a per-run append-only
JSONL event stream (``MetricsWriter``: one ``{"kind", "time", ...}`` record
per line, flushed per line, thread-safe, idempotent ``close()``) and a
JSONL run registry with one line per completed run. The JAX
``MetricsWriter`` is a shim over the ``JsonlSink`` of its ``obs`` package,
whose size-based rotation no caller of the port sets; here it is one class
without rotation, with a plain ``threading.Lock``.
"""

from __future__ import annotations

import json
import os
import threading
import time


class MetricsWriter:
    """Append-only JSONL metrics stream for one run."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1)

    def write(self, kind: str, **fields) -> None:
        line = json.dumps({"kind": kind, "time": time.time(), **fields})
        with self._lock:
            if self._f.closed:
                raise ValueError(f"MetricsWriter({self.path}) is closed")
            self._f.write(line + "\n")

    def close(self) -> None:
        """Idempotent."""
        with self._lock:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def append_registry(registry_path: str, record: dict) -> None:
    """One line per completed run."""
    os.makedirs(os.path.dirname(registry_path) or ".", exist_ok=True)
    with open(registry_path, "a") as f:
        f.write(json.dumps(record) + "\n")


def read_jsonl(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
