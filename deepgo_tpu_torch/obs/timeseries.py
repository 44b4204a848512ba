"""On-disk time-series store + background registry sampler.

The port's copy of ``deepgo_tpu/obs/timeseries.py``; a store written by
either package reads in the other. The registry alone is either *live*
(what a scrape sees right now) or *terminal* (the close-time
``obs_snapshot`` event); to ask "when did boards/sec start degrading" about
an always-on loop run, something must write the registry down over time.
This module does, with two pieces:

  * ``TimeSeriesStore`` — an append-only, chunked, on-disk history of
    flattened registry snapshots: ``ts-NNNN.jsonl`` chunk files (each a
    ``JsonlSink``), one ``ts_sample`` record per sampling tick. Disk is
    bounded two ways: chunks roll at a fixed sample count, and once the
    chunk count exceeds the retention budget the two *oldest* chunks are
    merged with power-of-two decimation (every other unpinned sample is
    dropped, survivors carry a ``ds`` generation counter) — so a
    multi-hour run keeps its full recent resolution while older history
    degrades gracefully instead of being truncated. Samples *pinned* by
    the anomaly detector (the series window around an incident) are
    never decimated. Reads are torn-line tolerant like ``report.py``:
    a store being written by a SIGKILLed process stays queryable.
  * ``TelemetrySampler`` — the background thread that snapshots the
    registry into the store on a fixed cadence (injectable clock, the
    liveness/supervisor discipline — cadence is unit-testable without
    sleeping) and fans each flattened sample out to listeners (the
    anomaly detector, obs/anomaly.py). Each tick also ``tick()``s the
    flight recorder, so the black-box ring advances at telemetry
    cadence even outside the train loop.

Series are keyed ``name{label}`` for counters/gauges and
``name{label}:field`` (``count``/``sum``/``p50``/``p99``) for
histograms — the same label-string format the registry snapshot uses,
which is what lets obs/federate.py merge scraped and stored views into
one keyspace.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import threading
import time
from collections import deque

from ..analysis.lockcheck import make_lock
from .exporter import JsonlSink
from .registry import MetricsRegistry, get_registry
from .sentinel import get_flight_recorder

_CHUNK_RE = re.compile(r"^ts-(\d+)\.jsonl$")

# histogram snapshot fields worth keeping per tick (the full bucket
# ladder stays scrape-side; the history wants the operator numbers)
HIST_FIELDS = ("count", "sum", "p50", "p99")


def series_key(name: str, label: str = "", field: str | None = None) -> str:
    """The canonical series key: ``name{label}:field`` with empty parts
    elided. ``label`` is the registry snapshot's sorted ``k=v,...``
    string."""
    key = name if not label else f"{name}{{{label}}}"
    return key if field is None else f"{key}:{field}"


def split_key(key: str) -> tuple[str, str, str | None]:
    """Inverse of ``series_key`` -> (name, label, field). The field
    suffix is whatever follows the CLOSING brace — label values may
    legitimately contain colons (``host=127.0.0.1:9090``), so parsing
    by first-colon would corrupt every federated key."""
    if "{" in key:
        name, _, rest = key.partition("{")
        label, _, tail = rest.rpartition("}")
        field = tail[1:] if tail.startswith(":") else None
        return name, label, field or None
    base, _, field = key.partition(":")
    return base, "", (field or None)


def key_base(key: str) -> str:
    """The key without its histogram-field suffix: ``name{label}``."""
    name, label, _field = split_key(key)
    return name if not label else f"{name}{{{label}}}"


def key_field(key: str) -> str | None:
    return split_key(key)[2]


def flatten_snapshot(metrics: dict) -> dict[str, float]:
    """A registry snapshot's ``metrics`` dict -> one flat
    ``{series_key: value}`` sample (what the store appends per tick)."""
    out: dict[str, float] = {}
    for name, m in metrics.items():
        kind = m.get("kind")
        for label, value in (m.get("series") or {}).items():
            if kind in ("counter", "gauge"):
                out[series_key(name, label)] = float(value)
            elif kind == "histogram" and value:
                for field in HIST_FIELDS:
                    if value.get(field) is not None:
                        out[series_key(name, label, field)] = \
                            float(value[field])
    return out


def chunk_paths(ts_dir: str) -> list[str]:
    """Every chunk file of a store directory, oldest first."""
    found = []
    for p in glob.glob(os.path.join(ts_dir, "ts-*.jsonl")):
        m = _CHUNK_RE.match(os.path.basename(p))
        if m:
            found.append((int(m.group(1)), p))
    return [p for _, p in sorted(found)]


def _read_chunk(path: str) -> list[dict]:
    """One chunk's samples, torn-line tolerant (a live writer or a
    SIGKILL mid-append must not make the store unreadable)."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("kind") == "ts_sample" and "t" in rec:
                    out.append(rec)
    except OSError:
        pass
    return out


def load_samples(ts_dir: str) -> list[dict]:
    """Every sample of an on-disk store, oldest first."""
    out: list[dict] = []
    for p in chunk_paths(ts_dir):
        out.extend(_read_chunk(p))
    out.sort(key=lambda r: r["t"])
    return out


def list_keys(samples: list[dict]) -> set[str]:
    keys: set[str] = set()
    for rec in samples:
        keys.update(rec.get("values") or {})
    return keys


def key_matches(metric: str, key: str) -> bool:
    """Does ``key`` belong to the ``metric`` family? ``metric`` may be a
    bare name (matches every labelset + histogram field), a full
    ``name{label}`` base, or an exact key."""
    if key == metric:
        return True
    name, _label, _field = split_key(key)
    return name == metric or key_base(key) == metric


def series_from_samples(samples: list[dict],
                        metric: str) -> dict[str, list[tuple[float, float]]]:
    """Aligned (t, value) points per matching series key."""
    out: dict[str, list[tuple[float, float]]] = {}
    for rec in samples:
        t = rec["t"]
        for key, value in (rec.get("values") or {}).items():
            if key_matches(metric, key):
                out.setdefault(key, []).append((t, float(value)))
    return out


class TimeSeriesStore:
    """Chunked, retention-bounded, append-only sample store.

    ``chunk_samples`` bounds one ``ts-NNNN.jsonl`` file; once more than
    ``max_chunks`` chunks exist the two oldest are merged with
    power-of-two decimation. Pinned samples (``pin=True`` at append, or
    ``pin_recent()`` after the fact) always survive decimation — they
    are the anomaly windows the postmortem needs at full resolution."""

    def __init__(self, ts_dir: str, chunk_samples: int = 256,
                 max_chunks: int = 16, clock=time.time,
                 registry: MetricsRegistry | None = None,
                 recent_samples: int = 512):
        if chunk_samples < 2 or max_chunks < 2:
            raise ValueError(
                f"TimeSeriesStore needs chunk_samples >= 2 and "
                f"max_chunks >= 2, got {chunk_samples}/{max_chunks}")
        self.dir = ts_dir
        os.makedirs(ts_dir, exist_ok=True)
        self.chunk_samples = chunk_samples
        self.max_chunks = max_chunks
        self._clock = clock
        self._lock = make_lock("obs.tsstore")
        self._recent: deque = deque(maxlen=recent_samples)
        self._pinned: set[float] = set()
        self._sink: JsonlSink | None = None
        self._count = 0
        existing = chunk_paths(ts_dir)
        self._next_index = 0
        if existing:
            # resume appending into the newest chunk (a restarted loop
            # keeps one continuous history)
            tail = existing[-1]
            self._next_index = int(
                _CHUNK_RE.match(os.path.basename(tail)).group(1)) + 1
            records = _read_chunk(tail)
            if len(records) < chunk_samples:
                self._sink = JsonlSink(tail)
                self._count = len(records)
        reg = registry or get_registry()
        self._obs_samples = reg.counter(
            "deepgo_ts_samples_total",
            "telemetry samples appended to the on-disk time-series store")

    # -- write side --------------------------------------------------------

    def append(self, values: dict, t: float | None = None,
               pin: bool = False) -> float:
        """Append one flattened sample; returns its timestamp."""
        t = self._clock() if t is None else float(t)
        with self._lock:
            if self._sink is None or self._count >= self.chunk_samples:
                self._roll()
            self._sink.write("ts_sample", t=t, pin=bool(pin), values=values)
            self._count += 1
            if pin:
                self._pinned.add(t)
            self._recent.append({"t": t, "pin": bool(pin),
                                 "values": values})
        self._obs_samples.inc()
        return t

    def pin_recent(self, n: int = 8) -> int:
        """Pin the last ``n`` samples (the anomaly detector's series
        window): they survive every future decimation pass. The current
        chunk is re-stamped on disk so the pins are durable — an offline
        reader of a killed run still sees which window an anomaly
        protected. Returns how many were pinned."""
        with self._lock:
            tail = list(self._recent)[-n:]
            for rec in tail:
                self._pinned.add(rec["t"])
            self._stamp_current_chunk()
            return len(tail)

    def _stamp_current_chunk(self) -> None:
        """Rewrite the (bounded-size) current chunk with ``pin: true``
        on every pinned sample — atomic, append resumes after."""
        if self._sink is None:
            return
        from ..utils.atomicio import atomic_write

        path = self._sink.path
        records = _read_chunk(path)
        if not any(not r.get("pin") and r["t"] in self._pinned
                   for r in records):
            return
        self._sink.close()
        for rec in records:
            if rec["t"] in self._pinned:
                rec["pin"] = True
        try:
            with atomic_write(path, mode="w") as f:
                for rec in records:
                    f.write(json.dumps(rec) + "\n")
        except OSError as e:
            print(f"timeseries: pin stamp of {path} failed: {e}",
                  file=sys.stderr, flush=True)
        self._sink = JsonlSink(path)

    def _roll(self) -> None:
        if self._sink is not None:
            self._sink.close()
        path = os.path.join(self.dir, f"ts-{self._next_index:04d}.jsonl")
        self._next_index += 1
        self._sink = JsonlSink(path)
        self._count = 0
        chunks = chunk_paths(self.dir)
        if len(chunks) > self.max_chunks:
            self._downsample_oldest(chunks)

    def _downsample_oldest(self, chunks: list[str]) -> None:
        """Merge the two oldest chunks, dropping every other unpinned
        sample (power-of-two decimation): old history halves in
        resolution instead of vanishing. The merged chunk is written
        atomically over the first chunk's name; the second is removed
        only after the replacement is durable."""
        from ..utils.atomicio import atomic_write

        first, second = chunks[0], chunks[1]
        merged = _read_chunk(first) + _read_chunk(second)
        merged.sort(key=lambda r: r["t"])
        kept = []
        for i, rec in enumerate(merged):
            if rec.get("pin") or rec["t"] in self._pinned or i % 2 == 0:
                if rec.get("pin") or rec["t"] in self._pinned:
                    rec["pin"] = True  # durable across process restarts
                else:
                    rec["ds"] = int(rec.get("ds", 0)) + 1
                kept.append(rec)
        try:
            with atomic_write(first, mode="w") as f:
                for rec in kept:
                    f.write(json.dumps(rec) + "\n")
            os.remove(second)
        except OSError as e:
            # retention is bookkeeping: a full disk must degrade to
            # "kept more than budgeted", never to a crashed sampler
            print(f"timeseries: downsample of {first} failed: {e}",
                  file=sys.stderr, flush=True)

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- read side ---------------------------------------------------------

    def samples(self) -> list[dict]:
        """Everything on disk (oldest first), torn-line tolerant."""
        return load_samples(self.dir)

    def series(self, metric: str) -> dict[str, list[tuple[float, float]]]:
        return series_from_samples(self.samples(), metric)

    def keys(self) -> set[str]:
        return list_keys(self.samples())

    def recent_window(self, n: int | None = None) -> list[dict]:
        """The in-memory tail (newest last) — the flight-recorder
        ``series_window`` section and the live ``/series`` route read
        this so neither ever touches the disk on a hot path."""
        with self._lock:
            tail = list(self._recent)
        return tail if n is None else tail[-n:]

    def recent_series(self, metric: str,
                      n: int | None = None) -> dict[str, list]:
        out: dict[str, list] = {}
        for rec in self.recent_window(n):
            for key, value in (rec.get("values") or {}).items():
                if key_matches(metric, key):
                    out.setdefault(key, []).append((rec["t"], float(value)))
        return out


class TelemetrySampler:
    """Background registry sampler: snapshot -> flatten -> store +
    listeners, on a fixed cadence with an injectable clock.

    The cadence contract lives in ``maybe_sample()`` (due-time
    arithmetic over ``clock()``, fixed-rate, catch-up skips forward
    instead of bursting) so tests drive it with a fake clock and never
    sleep; the daemon thread is just ``maybe_sample`` in a short-wait
    loop."""

    def __init__(self, store: TimeSeriesStore,
                 registry: MetricsRegistry | None = None,
                 interval_s: float = 1.0, clock=time.time,
                 listeners=(), flight_tick: bool = True):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.store = store
        self.interval_s = interval_s
        self._registry = registry or get_registry()
        self._clock = clock
        self._listeners = list(listeners)
        self._flight_tick = flight_tick
        self._due: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples_taken = 0

    def add_listener(self, fn) -> None:
        """``fn(t, values)`` called after every sample lands."""
        self._listeners.append(fn)

    def sample_once(self) -> dict:
        """Take one sample now, regardless of cadence."""
        t = self._clock()
        values = flatten_snapshot(self._registry.snapshot()["metrics"])
        self.store.append(values, t=t)
        self.samples_taken += 1
        for fn in self._listeners:
            try:
                fn(t, values)
            except Exception as e:  # noqa: BLE001 — a listener must not kill the sampler
                print(f"telemetry sampler: listener {fn!r} raised: {e!r}",
                      file=sys.stderr, flush=True)
        if self._flight_tick:
            get_flight_recorder().tick()
        return values

    def maybe_sample(self) -> bool:
        """Sample iff the cadence says one is due. A long stall (a GC
        pause, a wedged snapshot) does NOT backfill missed ticks — the
        due time skips forward so the store never gets a burst of
        identical samples stamped with stale intent."""
        now = self._clock()
        if self._due is None:
            self._due = now + self.interval_s
            self.sample_once()
            return True
        if now < self._due:
            return False
        while self._due <= now:
            self._due += self.interval_s
        self.sample_once()
        return True

    def start(self) -> "TelemetrySampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="obs-ts-sampler", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        wait = min(0.05, self.interval_s / 4.0)
        while not self._stop.is_set():
            try:
                self.maybe_sample()
            except Exception as e:  # noqa: BLE001 — the sampler must outlive a dying registry
                print(f"telemetry sampler: tick failed: {e!r}",
                      file=sys.stderr, flush=True)
            self._stop.wait(wait)

    def stop(self, final_sample: bool = False) -> None:
        """Idempotent. ``final_sample`` appends one last snapshot after
        the thread is down (the close-time state, like obs_snapshot)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        if final_sample:
            self.sample_once()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# -- the process-wide live store (what the exporter's /series serves) ----

_live_store: TimeSeriesStore | None = None


def set_live_store(store: TimeSeriesStore | None) -> None:
    """Install the store the live ``/series`` route reads. One per
    process (like the cost ledger / trace recorder)."""
    global _live_store
    _live_store = store


def get_live_store() -> TimeSeriesStore | None:
    return _live_store
