"""Host liveness for multi-host training: heartbeats, a ledger, stragglers.

The port's copy of ``deepgo_tpu/parallel/liveness.py``:

  * ``HeartbeatWriter`` — one atomically written JSON file per host
    (``heartbeat-NNNN.json`` in a directory every host can reach). Beats
    carry the host's training step and its recent per-step latency; hard
    write failures are logged and absorbed (the peers' miss budget covers
    them).
  * ``HeartbeatLedger`` — the read side: each host's newest beat (corrupt
    files skipped with a logged reason), a host declared lost once its
    silence exceeds ``interval_s * miss_budget``, stragglers flagged from
    rolling per-host step latencies.
  * a typed error family (``HostLost``, ``StragglerDetected``, ...) that
    the elastic loop (``parallel/elastic.py``) routes on.

Clocks are injectable; heartbeat times are wall times because they are
compared across processes.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from collections import deque

from ..obs import get_registry
from ..utils.atomicio import atomic_write
from ..utils.retry import retry_with_backoff
from ..utils import faults


# ---- typed error family (mirrors serving/resilience.py) ----


class DistributedError(RuntimeError):
    """Base for the multi-host failure vocabulary. Every distributed
    failure the elastic layer can detect or recover from is one of these,
    so callers route on type, never on message text."""


class ConfigError(DistributedError, ValueError):
    """A distributed configuration that cannot work (indivisible batch,
    empty surviving-process set, ...). Typed — never ``assert``, which
    vanishes under ``python -O``."""


class HostLost(DistributedError):
    """A participating host's heartbeat silence exceeded the miss budget.

    Carries everything recovery needs: ``process_id``, ``last_seen`` (wall
    time of the newest beat), ``silent_for_s``, the ``budget_s`` that was
    exceeded, and ``last_step`` (None if the host never beat at all)."""

    def __init__(self, process_id: int, last_seen: float, silent_for_s: float,
                 budget_s: float, last_step: int | None = None):
        self.process_id = process_id
        self.last_seen = last_seen
        self.silent_for_s = silent_for_s
        self.budget_s = budget_s
        self.last_step = last_step
        super().__init__(
            f"host {process_id} lost: silent for {silent_for_s:.2f}s "
            f"(miss budget {budget_s:.2f}s; last step "
            f"{'never beat' if last_step is None else last_step})")


class StragglerDetected(DistributedError):
    """A host's rolling median step latency exceeds ``factor`` x the fleet
    median — alive, but slowing every synchronous step. Advisory by
    default (the elastic loop logs it); policy decides whether to evict."""

    def __init__(self, process_id: int, latency_s: float,
                 fleet_median_s: float, factor: float):
        self.process_id = process_id
        self.latency_s = latency_s
        self.fleet_median_s = fleet_median_s
        self.factor = factor
        super().__init__(
            f"host {process_id} straggling: median step latency "
            f"{latency_s * 1000:.1f}ms vs fleet median "
            f"{fleet_median_s * 1000:.1f}ms (threshold {factor:g}x)")


class CoordinatorUnreachable(DistributedError, ConnectionError):
    """The process-group rendezvous could not be reached within the
    retry budget. Subclasses ConnectionError (an OSError) so generic
    transient-I/O retry policies treat it as retryable."""


_HB_RE = re.compile(r"^heartbeat-(\d+)\.json$")


def heartbeat_name(process_id: int) -> str:
    return f"heartbeat-{process_id:04d}.json"


class HeartbeatWriter:
    """One host's pulse: atomically rewrite ``heartbeat-NNNN.json``.

    ``beat()`` is called from the training loop (once per print window —
    windows are the loop's natural cadence and complete in well under a
    miss budget at any sane configuration). The ``heartbeat`` fault site
    fires inside the retried write, so the chaos grammar can exercise both
    the absorbed-transient and the logged-hard-failure paths."""

    def __init__(self, directory: str, process_id: int,
                 clock=time.time, attempts: int = 3):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.process_id = process_id
        self.path = os.path.join(directory, heartbeat_name(process_id))
        self._clock = clock
        self._attempts = attempts
        self.beats = 0      # beats successfully written
        self.misses = 0     # beats absorbed after a hard write failure

    def beat(self, step: int, step_latency_s: float | None = None) -> bool:
        """Write one beat; returns False (and logs) on a hard failure.

        A heartbeat is advisory — a failed write must never kill a healthy
        trainer (the peers' miss budget absorbs it), so hard faults are
        swallowed after the bounded retry, loudly."""
        record = {
            "process_id": self.process_id,
            "beat": self.beats + self.misses,
            "step": int(step),
            "time": self._clock(),
        }
        if step_latency_s is not None:
            record["step_latency_s"] = float(step_latency_s)

        def write() -> None:
            faults.check("heartbeat")
            with atomic_write(self.path, mode="w") as f:
                json.dump(record, f)

        try:
            retry_with_backoff(write, attempts=self._attempts,
                               base_delay=0.01, max_delay=0.1)
        except (OSError, RuntimeError) as e:
            self.misses += 1
            print(f"heartbeat: write for host {self.process_id} failed ({e}); "
                  f"absorbed (miss {self.misses}) — peers' miss budget covers "
                  f"occasional silence", file=sys.stderr, flush=True)
            return False
        self.beats += 1
        return True


class HeartbeatLedger:
    """The read side: who is alive, who is lost, who is straggling.

    ``interval_s * miss_budget`` is the silence budget: a host whose newest
    beat is older than that is declared lost (``check_liveness`` raises a
    typed ``HostLost``). A host that never wrote a beat at all is measured
    against the ledger's first-poll time, so a peer that dies during
    bootstrap is still detected instead of waited on forever.

    Straggler detection folds each beat's ``step_latency_s`` into a rolling
    per-host window (keyed on the beat sequence number, so re-reading the
    same file does not double count) and compares each host's median
    against the median of its peers'."""

    def __init__(self, directory: str, interval_s: float = 1.0,
                 miss_budget: int = 3, clock=time.time,
                 latency_window: int = 32, log=None, registry=None):
        if interval_s <= 0:
            raise ConfigError(f"interval_s must be > 0, got {interval_s}")
        if miss_budget < 1:
            raise ConfigError(f"miss_budget must be >= 1, got {miss_budget}")
        # live straggler surface: each straggler_report() refreshes a
        # per-host gauge (host median / peers' median; 1.0 = fleet-
        # typical), so a slow host shows on /metrics without anyone
        # calling the report — the scrape IS the call
        self._obs_ratio = (registry or get_registry()).gauge(
            "deepgo_straggler_ratio",
            "per-host rolling median step latency over the peers' median "
            "(1.0 = fleet-typical; above the straggler factor = flagged)")
        self.directory = directory
        self.interval_s = interval_s
        self.miss_budget = miss_budget
        self.budget_s = interval_s * miss_budget
        self._clock = clock
        self._t0: float | None = None  # first-poll time: never-seen grace
        self._latencies: dict[int, deque] = {}
        self._last_beat_seq: dict[int, int] = {}
        self._window = latency_window
        if log is None:
            def log(msg):
                print(msg, file=sys.stderr, flush=True)
        self._log = log

    def read(self) -> dict[int, dict]:
        """Newest beat per host. Corrupt or torn files are skipped with a
        logged reason — the writer is atomic, so these only appear when
        storage itself misbehaves, and a garbled beat must read as silence
        (detectable), never as a crash of the *reader*. The first read
        starts the never-seen grace window: any observation of the world
        is the moment silent peers begin accruing silence."""
        if self._t0 is None:
            self._t0 = self._clock()
        try:
            names = os.listdir(self.directory)
        except (FileNotFoundError, NotADirectoryError):
            return {}
        out: dict[int, dict] = {}
        for name in names:
            m = _HB_RE.match(name)
            if not m:
                continue
            path = os.path.join(self.directory, name)
            try:
                with open(path) as f:
                    record = json.load(f)
                pid = int(record["process_id"])
                float(record["time"])
            except (OSError, ValueError, KeyError, TypeError) as e:
                self._log(f"heartbeat ledger: skipping {path}: {e}")
                continue
            out[pid] = record
        return out

    def poll(self) -> dict[int, dict]:
        """read() + fold new beats' latencies into the rolling windows."""
        records = self.read()
        for pid, rec in records.items():
            seq = rec.get("beat")
            if seq is None or seq == self._last_beat_seq.get(pid):
                continue  # already folded (or unversioned beat)
            self._last_beat_seq[pid] = seq
            latency = rec.get("step_latency_s")
            if latency is not None:
                self._latencies.setdefault(
                    pid, deque(maxlen=self._window)).append(float(latency))
        return records

    def check_liveness(self, expected, now: float | None = None) -> None:
        """Raise ``HostLost`` for the longest-silent expected host whose
        silence exceeds the budget; return normally when all are live.
        ``expected`` is an iterable of process ids (exclude yourself)."""
        if self._t0 is None:
            self._t0 = self._clock()
        now = self._clock() if now is None else now
        records = self.read()
        lost: list[HostLost] = []
        for pid in expected:
            rec = records.get(pid)
            last_seen = rec["time"] if rec else self._t0
            silent = now - last_seen
            if silent > self.budget_s:
                lost.append(HostLost(
                    pid, last_seen, silent, self.budget_s,
                    last_step=None if rec is None else rec.get("step")))
        if lost:
            # deterministic: report the longest-silent host first; the
            # elastic loop re-checks after recovery and picks up the rest
            raise max(lost, key=lambda e: e.silent_for_s)

    def straggler_report(self, factor: float = 3.0,
                         min_beats: int = 3) -> list[StragglerDetected]:
        """Hosts whose rolling median step latency exceeds ``factor`` x the
        median of their *peers'* medians (hosts with >= min_beats samples
        only). Excluding the candidate from its own baseline matters: one
        slow host in a small fleet would otherwise drag the fleet median
        toward itself and hide under its own weight — a 2-host fleet could
        never convict either half. Returned, not raised: straggling is
        advisory — policy belongs to the caller."""
        import statistics

        medians = {pid: statistics.median(lat)
                   for pid, lat in self._latencies.items()
                   if len(lat) >= min_beats}
        if len(medians) < 2:
            return []  # a baseline needs at least one peer to compare
        report = []
        for pid, med in sorted(medians.items()):
            peers = statistics.median(
                [m for p, m in medians.items() if p != pid])
            ratio = med / peers if peers > 0 else 0.0
            self._obs_ratio.set(round(ratio, 4), host=str(pid))
            if peers > 0 and med > factor * peers:
                report.append(StragglerDetected(pid, med, peers, factor))
        return report

    def snapshot(self) -> dict:
        """Observability: everything the ledger currently believes."""
        import statistics

        records = self.read()
        now = self._clock()
        return {
            "budget_s": self.budget_s,
            "hosts": {
                pid: {
                    "step": rec.get("step"),
                    "silent_for_s": now - rec["time"],
                    "median_latency_s": (
                        statistics.median(self._latencies[pid])
                        if self._latencies.get(pid) else None),
                }
                for pid, rec in sorted(records.items())
            },
        }
