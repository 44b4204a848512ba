"""Metrics and run-registry logging.

The port's copy of ``deepgo_tpu/utils/metrics.py``: a per-run append-only
JSONL event stream (``MetricsWriter``: one ``{"kind", "time", ...}`` record
per line, flushed per line, thread-safe, idempotent ``close()``) and a
JSONL run registry with one line per completed run. As in the JAX package,
``MetricsWriter`` is a thin shim over the ``JsonlSink`` of the ``obs``
package (optional size-based rotation included).
"""

from __future__ import annotations

import json
import os

from ..obs.exporter import JsonlSink


class MetricsWriter(JsonlSink):
    """Append-only JSONL metrics stream for one run (obs JsonlSink shim)."""

    def __init__(self, path: str, max_bytes: int = 0, max_files: int = 5):
        super().__init__(path, max_bytes=max_bytes, max_files=max_files)


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
