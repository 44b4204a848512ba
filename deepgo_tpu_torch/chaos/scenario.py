"""Declarative fault timelines, executed against the live fault plan.

The port's copy of ``deepgo_tpu/chaos/scenario.py``: a scenario and its
schedule are the JAX package's, event for event.

A ``Scenario`` is a named, seeded list of ``FaultEvent``s — *what
breaks, where, when, for how long* — serializable to JSON so a
campaign is reproducible from its report alone. The
``ScenarioScheduler`` is the small thread that walks the timeline and
mutates the process-wide fault plan (utils/faults ``add``/``remove``)
at the scheduled moments:

  kill      arm ``serving_dispatch.<replica>:fail@1`` — the next
            coalescing window of that replica's dispatcher dies (the
            supervisor-restart / fleet-respawn path)
  slow      open ``serving_slow.<replica>:slow@MS`` at ``at_s`` and
            close it ``duration_s`` later — a brownout window: the
            replica stays "healthy" while every batch it serves eats
            MS milliseconds
  corrupt   open ``serving_corrupt.<replica>:corrupt@N`` — the next N
            batches return silently wrong output (the canary-probe
            prey); closed early when ``duration_s`` > 0
  saturate  submit ``arg`` junk batch-tier requests in one burst
            through the campaign's ``submit_burst`` hook — queue
            pressure, not replica damage
  reload    fire the campaign's ``reload_params`` hook — a rolling
            weight reload mid-trace (the position cache's invalidation
            path). Spawned on its own thread: a reload blocks on the
            per-replica drain, and the timeline must keep walking
  wal       open ``session_wal:transient@N`` — the next N session-store
            WAL appends fail transiently (the ack barrier's retry
            path); closed early when ``duration_s`` > 0. Process-wide:
            the session store is not a replica
  reply     open ``session_reply:transient@N`` — the next N engine-reply
            submits fail transiently (the deadline-tier escalation
            path); closed early when ``duration_s`` > 0

Events target replicas by index; the scheduler maps an index to the
engine name (``<fleet>-<idx>`` by convention, overridable) because the
fault plan is keyed by the *engine's* name — which survives respawn,
so a recycled replica re-enters any still-open fault window, exactly
like a bad host re-entering rotation.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..analysis.lockcheck import make_lock
from ..obs.spans import span
from ..utils import faults

EVENT_KINDS = ("kill", "slow", "corrupt", "saturate", "reload",
               "wal", "reply")

# wal/reply target the session layer's process-wide fault sites, not a
# replica-indexed engine site
_SESSION_SITE_OF = {"wal": "session_wal", "reply": "session_reply"}


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``arg`` is kind-specific: slow = delay in
    milliseconds per batch, corrupt = number of corrupted batches,
    saturate = burst size; kill ignores it. ``duration_s`` bounds the
    open window for slow (required) and corrupt (optional)."""

    at_s: float
    kind: str
    replica: int = 0
    duration_s: float = 0.0
    arg: int = 1

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}: expected one of "
                f"{EVENT_KINDS}")
        if self.at_s < 0:
            raise ValueError(f"at_s must be >= 0, got {self.at_s}")
        if self.kind != "saturate" and self.replica < 0:
            raise ValueError(f"replica must be >= 0, got {self.replica}")
        if self.kind == "slow" and self.duration_s <= 0:
            raise ValueError("slow events need duration_s > 0: an "
                             "unbounded brownout is a config bug, not "
                             "a scenario")
        if (self.kind in ("slow", "corrupt", "saturate", "wal", "reply")
                and self.arg < 1):
            raise ValueError(
                f"{self.kind} events need arg >= 1, got {self.arg}")

    def to_dict(self) -> dict:
        return {"at_s": self.at_s, "kind": self.kind,
                "replica": self.replica, "duration_s": self.duration_s,
                "arg": self.arg}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(at_s=float(d["at_s"]), kind=str(d["kind"]),
                   replica=int(d.get("replica", 0)),
                   duration_s=float(d.get("duration_s", 0.0)),
                   arg=int(d.get("arg", 1)))


@dataclass(frozen=True)
class Scenario:
    """A named fault timeline plus the seed that makes the whole
    campaign (trace, schedule, grading) reproducible."""

    name: str
    events: tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        return cls(name=str(d["name"]), seed=int(d.get("seed", 0)),
                   events=tuple(FaultEvent.from_dict(e)
                                for e in d.get("events", ())))

    def span_s(self) -> float:
        """When the last fault window closes, relative to t=0."""
        return max((e.at_s + e.duration_s for e in self.events),
                   default=0.0)


class ScenarioScheduler:
    """Execute a scenario's timeline against the active fault plan.

    One daemon thread sleeps to each action's offset and fires it;
    ``start()`` stamps t=0. Actions are derived up front: each slow
    (and bounded corrupt) event contributes an *open* and a *close*
    action, so stopping the scheduler early (or a crashed campaign)
    can still sweep every window shut via ``stop()`` — chaos must
    never outlive its campaign. ``executed`` records what actually
    fired, with offsets, for the campaign report."""

    def __init__(self, scenario: Scenario, fleet_name: str = "fleet",
                 engine_name_of=None, submit_burst=None,
                 reload_params=None, clock=time.monotonic):
        self.scenario = scenario
        self._engine_name_of = (engine_name_of
                                or (lambda i: f"{fleet_name}-{i}"))
        self._submit_burst = submit_burst
        self._reload_params = reload_params
        self._clock = clock
        self._stop = threading.Event()
        self._lock = make_lock("chaos.scheduler")
        self._thread: threading.Thread | None = None
        self._opened: list[tuple[str, str]] = []  # (site, kind) to sweep
        self.executed: list[dict] = []
        self._actions = self._expand()

    # -- timeline expansion --------------------------------------------------

    def _expand(self) -> list[tuple]:
        acts: list[tuple] = []
        for ev in self.scenario.events:
            name = self._engine_name_of(ev.replica)
            if ev.kind == "kill":
                site = f"serving_dispatch.{name}"
                acts.append((ev.at_s, ev, "open",
                             lambda s=site: faults.add(f"{s}:fail@1")))
            elif ev.kind == "slow":
                site = f"serving_slow.{name}"
                acts.append((ev.at_s, ev, "open",
                             lambda s=site, a=ev.arg:
                             self._open(s, "slow", a)))
                acts.append((ev.at_s + ev.duration_s, ev, "close",
                             lambda s=site: self._close(s, "slow")))
            elif ev.kind == "corrupt":
                site = f"serving_corrupt.{name}"
                acts.append((ev.at_s, ev, "open",
                             lambda s=site, a=ev.arg:
                             self._open(s, "corrupt", a)))
                if ev.duration_s > 0:
                    acts.append((ev.at_s + ev.duration_s, ev, "close",
                                 lambda s=site:
                                 self._close(s, "corrupt")))
            elif ev.kind in _SESSION_SITE_OF:
                site = _SESSION_SITE_OF[ev.kind]
                acts.append((ev.at_s, ev, "open",
                             lambda s=site, a=ev.arg:
                             self._open(s, "transient", a)))
                if ev.duration_s > 0:
                    acts.append((ev.at_s + ev.duration_s, ev, "close",
                                 lambda s=site:
                                 self._close(s, "transient")))
            elif ev.kind == "saturate":
                acts.append((ev.at_s, ev, "open",
                             lambda n=ev.arg: self._saturate(n)))
            elif ev.kind == "reload":
                acts.append((ev.at_s, ev, "open", self._reload))
        acts.sort(key=lambda a: a[0])
        return acts

    def _open(self, site: str, kind: str, arg: int) -> None:
        faults.add(f"{site}:{kind}@{arg}")
        with self._lock:
            self._opened.append((site, kind))

    def _close(self, site: str, kind: str) -> None:
        faults.remove(site, kind)
        with self._lock:
            self._opened = [(s, k) for s, k in self._opened
                            if (s, k) != (site, kind)]

    def _saturate(self, n: int) -> None:
        if self._submit_burst is not None:
            self._submit_burst(n)

    def _reload(self) -> None:
        # a rolling reload blocks on every replica's drain — fired on
        # its own thread so the fault timeline keeps walking behind it
        if self._reload_params is not None:
            threading.Thread(target=self._reload_params,
                             name=f"chaos-reload-{self.scenario.name}",
                             daemon=True).start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ScenarioScheduler":
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._thread = threading.Thread(
            target=self._run, name=f"chaos-{self.scenario.name}",
            daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        t0 = self._clock()
        for at_s, ev, phase, fn in self._actions:
            while not self._stop.is_set():
                lead = at_s - (self._clock() - t0)
                if lead <= 0:
                    break
                self._stop.wait(min(lead, 0.05))
            if self._stop.is_set():
                return
            with span("chaos_event", kind=ev.kind, phase=phase,
                      replica=ev.replica, scenario=self.scenario.name):
                fn()
            self.executed.append({
                "t_s": round(self._clock() - t0, 4), "kind": ev.kind,
                "phase": phase, "replica": ev.replica, "arg": ev.arg})

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def stop(self, timeout: float = 5.0) -> None:
        """Halt the timeline and sweep every still-open fault window
        shut. Idempotent; always safe to call from ``finally``."""
        self._stop.set()
        self.join(timeout=timeout)
        with self._lock:
            opened, self._opened = self._opened, []
        for site, kind in opened:
            faults.remove(site, kind)
