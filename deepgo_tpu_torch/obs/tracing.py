"""Request-scoped tracing: per-request timelines, tail exemplars, lineage.

The port's copy of ``deepgo_tpu/obs/tracing.py`` (the offline readers
take ``read_events`` from the port's ``obs/exporter.py``). Aggregates (histograms, burn rates) say nothing of
one request: a p99 outlier, a failover hop, or a champion's provenance is
invisible below the histogram. This module adds the per-request (and
per-champion) anatomy:

  * ``TraceContext`` — one request's identity (trace id + the submitting
    thread's span, via ``spans.capture_context()``) and its live
    timeline. The serving layers stamp it as the request moves:
    ``queued`` (fleet door / engine queue) → ``routed`` (placement, with
    the replica id) → ``coalesced`` (batch formed, with bucket) →
    ``dispatched`` (forward begins) → ``resolved`` — plus the failure
    vocabulary: ``hop`` (failover off a dead replica, with the error),
    ``replayed`` (supervisor restart replay), ``isolated`` (poison
    bisection solo retry), ``failed`` / ``expired``. One trace id
    survives restarts and failovers end to end; the timeline is the
    proof.
  * ``TraceRecorder`` — bounded-memory exemplar sampling over completed
    timelines: always keep the slowest-k per window, p99+ outliers
    (against a rolling duration window), and every *notable* trace
    (error status, failover hops, replay/isolation events). Kept
    exemplars stream as ``trace_request`` JSONL records to the
    configured sink and sit in a fixed-size ring that the crash flight
    recorder (obs/sentinel.py) folds into every dump — a restart/SLO-
    burn/HostLost postmortem carries the actual anatomy of the slow or
    failed requests that preceded it, not just aggregate snapshots.
  * **lineage** — the same id discipline extended to the expert-
    iteration loop as durable ``lineage_*`` events: actors tag ingested
    games (``lineage_game``), the buffer records game→segment at seal
    (``lineage_segment``), the learner records extent→window→checkpoint
    ``params_digest`` (``lineage_window``), and the gatekeeper records
    checkpoint→gate-verdict→champion-publish (``lineage_gate`` /
    ``lineage_champion``) — so ``cli trace RUN_DIR champion`` walks the
    chain backwards and answers "which games trained the champion
    currently serving".

Tracing is OFF by default and every plumbing site is a ``trace is None``
check. ``trace_report(run_dir, id)`` reconstructs either view offline: a
request waterfall from ``trace_request`` records, or a champion's
provenance from the ``lineage_*`` stream.
"""

from __future__ import annotations

import heapq
import time
import uuid

import numpy as np

from ..analysis.lockcheck import make_lock
from .registry import get_registry
from .spans import capture_context

# timeline event names that make a trace "notable" (kept as an exemplar
# regardless of duration: they are the failure anatomy)
NOTABLE_EVENTS = frozenset({"hop", "replayed", "isolated", "failed",
                            "expired"})

# the event grammar a COMPLETE successful timeline must contain, in
# order — what the no-orphan acceptance check verifies per request
REQUIRED_OK_EVENTS = ("queued", "dispatched", "resolved")


class TraceContext:
    """One request's trace id + live timeline.

    Created by the outermost serving layer the caller entered (fleet
    router, supervisor, or bare engine — whichever sees the request
    first owns ``finish``); inner layers stamp events on the SAME
    context, so the id survives failovers, restarts, and replays.
    Marks are list appends (GIL-atomic); ``finish`` is idempotent —
    exactly one resolution reaches the recorder."""

    __slots__ = ("trace_id", "parent_span", "t0_wall", "t0_mono",
                 "events", "hops", "fields", "_recorder", "_finished")

    def __init__(self, recorder: "TraceRecorder", **fields):
        self.trace_id = uuid.uuid4().hex[:16]
        self.parent_span = capture_context()
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()
        self.events: list[dict] = []
        self.hops: list[dict] = []
        self.fields = {k: v for k, v in fields.items() if v is not None}
        self._recorder = recorder
        self._finished = False

    def _t_ms(self) -> float:
        return round((time.monotonic() - self.t0_mono) * 1000.0, 3)

    def mark(self, name: str, **fields) -> None:
        """Stamp one timeline event at now (ms offset from creation)."""
        self.events.append({"name": name, "t_ms": self._t_ms(), **fields})

    def hop(self, replica, error: str) -> None:
        """Record one failover hop: the request fled ``replica`` after
        ``error``. Hops ride both the hop list (the failover anatomy)
        and the merged timeline."""
        t = self._t_ms()
        self.hops.append({"replica": replica, "error": error, "t_ms": t})
        self.events.append({"name": "hop", "t_ms": t, "replica": replica,
                            "error": error})

    def set(self, **fields) -> None:
        """Merge request-level fields (tier, bucket, replica, engine)."""
        for k, v in fields.items():
            if v is not None:
                self.fields[k] = v

    def finish(self, status: str = "ok", error: str | None = None) -> None:
        if self._finished:
            return
        self._finished = True
        duration = time.monotonic() - self.t0_mono
        rec = self._recorder
        if rec is not None:
            rec.record(self, duration, status, error)

    def finish_future(self, f) -> None:
        """The owner's done-callback target: classify the resolved
        future into a trace status. Never raises — a tracing bug must
        not strand the future's waiter."""
        try:
            exc = f.exception()
        except BaseException:  # noqa: BLE001 — cancelled future
            exc = None
        if exc is None:
            self.finish("ok")
        else:
            self.finish("error", error=type(exc).__name__)

    def to_record(self, duration_s: float, status: str,
                  error: str | None) -> dict:
        record = {
            "trace_id": self.trace_id,
            "parent_span": self.parent_span,
            "t_start": self.t0_wall,
            "duration_s": round(duration_s, 9),
            "status": status,
            **self.fields,
            "hops": list(self.hops),
            "events": list(self.events),
        }
        if error is not None:
            record["error"] = error
        return record


class TraceRecorder:
    """Bounded-memory exemplar sampler over completed request timelines.

    Keep policy (all three independent, all bounded):

      * the slowest-k of the current sampling window (a min-heap of
        size k, reset every ``window_s``);
      * p99+ outliers against a rolling window of recent durations
        (percentile recomputed every ``p99_refresh`` finishes, so the
        hot path pays a deque append, not a sort);
      * every notable trace — error status, failover hops, replay or
        isolation events (the failure anatomy is always worth a slot).

    Kept exemplars land in a fixed-size ring (``exemplars()``, what the
    flight recorder folds into dumps) and stream as ``trace_request``
    JSONL records when a sink is configured. Memory is bounded by
    ``ring_size + p99_window + slowest_k`` records regardless of load —
    pinned by the sustained-load test."""

    def __init__(self, sink=None, slowest_k: int = 8,
                 window_s: float = 30.0, ring_size: int = 256,
                 p99_window: int = 2048, p99_refresh: int = 128,
                 clock=time.monotonic):
        self.sink = sink
        self.slowest_k = slowest_k
        self.window_s = window_s
        self.enabled = True
        self._clock = clock
        self._lock = make_lock("obs.trace")
        self._ring: list[dict] = []
        self._ring_size = ring_size
        self._durations: list[float] = []   # rolling p99 window
        self._p99_window = p99_window
        self._p99_refresh = p99_refresh
        self._p99: float | None = None
        self._window_heap: list[tuple[float, str]] = []  # (duration, id)
        self._window_t0 = clock()
        # accounting for the no-orphan acceptance check
        self.started = 0
        self.finished = 0
        self.incomplete = 0       # ok-status traces missing timeline events
        self.multi_hop = 0        # traces that failed over at least once
        self.errors = 0
        self.kept = 0
        reg = get_registry()
        self._obs_started = reg.counter(
            "deepgo_trace_requests_total",
            "requests that entered the serving path with tracing on")
        self._obs_kept = reg.counter(
            "deepgo_trace_exemplars_total",
            "traced requests kept as exemplars (slowest-k, p99+, notable)")

    # -- the hot path ------------------------------------------------------

    def start(self, **fields) -> TraceContext:
        with self._lock:
            self.started += 1
        self._obs_started.inc(1)
        return TraceContext(self, **fields)

    def record(self, ctx: TraceContext, duration_s: float, status: str,
               error: str | None) -> None:
        """One finished timeline: update accounting, decide exemplar."""
        notable = bool(ctx.hops) or any(
            e["name"] in NOTABLE_EVENTS for e in ctx.events)
        names = None
        if status == "ok":
            names = {e["name"] for e in ctx.events}
        with self._lock:
            self.finished += 1
            if ctx.hops:
                self.multi_hop += 1
            if status != "ok":
                self.errors += 1
            if names is not None and not names.issuperset(REQUIRED_OK_EVENTS):
                self.incomplete += 1
            keep = notable or status != "ok"
            # rolling p99 window + outlier check
            self._durations.append(duration_s)
            if len(self._durations) > self._p99_window:
                del self._durations[:len(self._durations) - self._p99_window]
            if self._p99 is None or self.finished % self._p99_refresh == 0:
                self._p99 = float(np.percentile(self._durations, 99))
            if duration_s >= self._p99:
                keep = True
            # slowest-k of the current window
            now = self._clock()
            if now - self._window_t0 > self.window_s:
                self._window_heap = []
                self._window_t0 = now
            if len(self._window_heap) < self.slowest_k:
                heapq.heappush(self._window_heap,
                               (duration_s, ctx.trace_id))
                keep = True
            elif duration_s > self._window_heap[0][0]:
                heapq.heapreplace(self._window_heap,
                                  (duration_s, ctx.trace_id))
                keep = True
            if not keep:
                return
            record = ctx.to_record(duration_s, status, error)
            self._ring.append(record)
            if len(self._ring) > self._ring_size:
                del self._ring[:len(self._ring) - self._ring_size]
            self.kept += 1
            sink = self.sink
        self._obs_kept.inc(1)
        if sink is not None:
            try:
                sink.write("trace_request", **record)
            except (OSError, ValueError):
                pass  # a full disk must not fail the traced request

    # -- read side ---------------------------------------------------------

    def exemplars(self) -> list[dict]:
        """The exemplar ring, oldest first — what the flight recorder
        dumps and ``/trace`` serves."""
        with self._lock:
            return list(self._ring)

    def stats(self) -> dict:
        with self._lock:
            return {
                "started": self.started,
                "finished": self.finished,
                "orphans": self.started - self.finished,
                "incomplete": self.incomplete,
                "multi_hop": self.multi_hop,
                "errors": self.errors,
                "exemplars_kept": self.kept,
                "ring": len(self._ring),
            }


# ---------------------------------------------------------------------------
# the process-wide recorder (the serving layers' entry point)

_recorder: TraceRecorder | None = None


def configure_tracing(sink=None, **kw) -> TraceRecorder:
    """Arm process-wide request tracing (idempotent — reconfiguring
    replaces the recorder). Registers the exemplar ring as a flight-
    recorder dump section, so every incident postmortem carries the
    slow/failed request anatomy that preceded it."""
    global _recorder
    _recorder = TraceRecorder(sink=sink, **kw)
    from .sentinel import get_flight_recorder

    get_flight_recorder().add_section(
        "trace_exemplars",
        lambda: {"stats": _recorder.stats() if _recorder else None,
                 "exemplars": _recorder.exemplars() if _recorder else []})
    return _recorder


def disable_tracing() -> None:
    """Disarm: ``start_request`` returns None again and every plumbing
    site reverts to its zero-cost ``trace is None`` branch."""
    global _recorder
    _recorder = None
    from .sentinel import get_flight_recorder

    get_flight_recorder().remove_section("trace_exemplars")


def tracing_enabled() -> bool:
    return _recorder is not None and _recorder.enabled


def get_trace_recorder() -> TraceRecorder | None:
    return _recorder


def start_request(**fields) -> TraceContext | None:
    """The serving layers' creation point: a live TraceContext when
    tracing is armed, None (the zero-overhead path) otherwise."""
    rec = _recorder
    if rec is None or not rec.enabled:
        return None
    return rec.start(**fields)


# ---------------------------------------------------------------------------
# offline reconstruction: `cli trace RUN_DIR ID`

def load_trace_events(run_dir: str) -> dict:
    """Everything `cli trace` joins: ``trace_request`` records from the
    run's trace stream plus ``lineage_*`` events from the loop/metrics
    streams (rotation-aware, torn lines skipped)."""
    import os

    from .exporter import read_events

    requests: list[dict] = []
    lineage: list[dict] = []
    searches: list[dict] = []
    for name in ("trace.jsonl", "metrics.jsonl", "loop.jsonl"):
        for r in read_events(os.path.join(run_dir, name)):
            kind = r.get("kind")
            if kind == "trace_request":
                requests.append(r)
            elif isinstance(kind, str) and kind.startswith("lineage_"):
                lineage.append(r)
            elif isinstance(kind, str) and kind.startswith("search_"):
                searches.append(r)
    return {"requests": requests, "lineage": lineage,
            "searches": searches}


def find_request(events: dict, ident: str) -> dict | None:
    """The trace_request record whose id starts with ``ident`` (newest
    wins when a short prefix is ambiguous)."""
    hits = [r for r in events["requests"]
            if str(r.get("trace_id", "")).startswith(ident)]
    return hits[-1] if hits else None


def format_waterfall(record: dict) -> str:
    """The human rendering of one request timeline: one line per event,
    ms offsets from submit, hops merged in chronological order."""
    head = [f"trace {record.get('trace_id')}  status={record.get('status')}"]
    for k in ("tier", "replica", "bucket", "error"):
        if record.get(k) is not None:
            head.append(f"{k}={record[k]}")
    dur = record.get("duration_s")
    if dur is not None:
        head.append(f"duration={float(dur) * 1000:.3f}ms")
    if record.get("hops"):
        head.append(f"hops={len(record['hops'])}")
    lines = ["  ".join(head)]
    if record.get("parent_span"):
        lines.append(f"  parent span: {record['parent_span']}")
    events = sorted(record.get("events", []),
                    key=lambda e: float(e.get("t_ms", 0.0)))
    width = max((len(e.get("name", "")) for e in events), default=0)
    for e in events:
        detail = "  ".join(f"{k}={v}" for k, v in e.items()
                           if k not in ("name", "t_ms"))
        lines.append(f"  +{float(e.get('t_ms', 0.0)):9.3f}ms  "
                     f"{e.get('name', '?'):<{width}}  {detail}".rstrip())
    return "\n".join(lines)


def find_search(events: dict, ident: str) -> dict | None:
    """The search_request record whose search id starts with ``ident``
    (newest wins when a short prefix is ambiguous)."""
    hits = [r for r in events.get("searches", [])
            if str(r.get("search_id", "")).startswith(ident)]
    return hits[-1] if hits else None


def _point(move) -> str:
    if move is None or int(move) < 0:
        return "pass"
    x, y = divmod(int(move), 19)
    return f"({x},{y})"


def format_search(record: dict) -> str:
    """The human rendering of one search verdict: the move, the anytime
    accounting (simulations done vs lost, deadline compliance), wave
    occupancy, and the principal variation reconstructed from the
    tree's visit counts."""
    head = [f"search {record.get('search_id')}  "
            f"move={_point(record.get('move'))}"]
    if record.get("value") is not None:
        head.append(f"value={float(record['value']):+.4f}")
    if record.get("tier") is not None:
        head.append(f"tier={record['tier']}")
    if record.get("fallback"):
        head.append("FALLBACK")
    lines = ["  ".join(head)]
    lines.append(
        f"  simulations {record.get('simulations')}  "
        f"lost {record.get('lost', 0)}  waves {record.get('waves')}  "
        f"occupancy {record.get('wave_occupancy')}")
    deadline = record.get("deadline_s")
    lines.append(
        f"  duration {float(record.get('duration_s', 0)) * 1000:.1f}ms"
        + (f"  deadline {float(deadline) * 1000:.0f}ms"
           f"  met={record.get('deadline_met')}"
           if deadline is not None else ""))
    if record.get("digest"):
        lines.append(f"  root digest {str(record['digest'])[:16]}")
    pv = record.get("pv") or []
    if pv:
        lines.append("  pv: " + " ".join(_point(m) for m in pv))
    return "\n".join(lines)


def _latest(records: list[dict]) -> dict | None:
    return records[-1] if records else None


def build_lineage(events: dict, ident: str) -> dict | None:
    """Walk the lineage chain backwards from a champion (or a window
    digest / window number): champion → gate verdict → window → extent →
    segments → games. Returns the joined chain, or None when ``ident``
    matches nothing."""
    lineage = events["lineage"]
    champions = [r for r in lineage if r["kind"] == "lineage_champion"]
    gates = [r for r in lineage if r["kind"] == "lineage_gate"]
    windows = [r for r in lineage if r["kind"] == "lineage_window"]
    segments = [r for r in lineage if r["kind"] == "lineage_segment"]
    games = [r for r in lineage if r["kind"] == "lineage_game"]

    champion = gate = window = None
    if ident in ("champion", "latest"):
        champion = _latest(champions)
        if champion is not None:
            digest = champion.get("digest")
            gate = _latest([g for g in gates
                            if g.get("digest") == digest]) or _latest(gates)
        window = _latest([w for w in windows
                          if champion is not None
                          and w.get("digest") == champion.get("digest")])
        if window is None and gate is not None:
            window = _latest([w for w in windows
                              if w.get("digest") == gate.get("digest")])
    elif ident.startswith("window:") or ident.isdigit():
        num = int(ident.split(":", 1)[-1])
        window = _latest([w for w in windows if w.get("window") == num])
    else:
        window = _latest([w for w in windows
                          if str(w.get("digest", "")).startswith(ident)])
        if window is None:
            champion = _latest([c for c in champions
                                if str(c.get("digest", ""))
                                .startswith(ident)])
            if champion is not None:
                window = _latest([w for w in windows
                                  if w.get("digest")
                                  == champion.get("digest")])
    if window is None and champion is None:
        return None
    if gate is None and window is not None:
        gate = _latest([g for g in gates
                        if g.get("digest") == window.get("digest")])
    lo = hi = None
    if window is not None and window.get("extent"):
        lo, hi = int(window["extent"][0]), int(window["extent"][1])
    segs = [s for s in segments
            if lo is not None and int(s.get("hi", 0)) > lo
            and int(s.get("lo", 0)) < hi]
    gids = set()
    for s in segs:
        gids.update(range(int(s.get("first_gid", 0)),
                          int(s.get("last_gid", -1)) + 1))
    chain_games = [g for g in games if g.get("gid") in gids]
    return {"champion": champion, "gate": gate, "window": window,
            "segments": segs, "games": chain_games}


def format_lineage(chain: dict) -> str:
    """The provenance rendering: champion → gate → window → segments →
    games, one level per block."""
    lines = []
    champ = chain.get("champion")
    if champ is not None:
        lines.append(
            f"champion  step={champ.get('step')}  "
            f"digest={str(champ.get('digest', ''))[:16]}  "
            f"source={champ.get('source', 'gate')}")
    gate = chain.get("gate")
    if gate is not None:
        lines.append(
            f"  gate    {gate.get('outcome')}  "
            f"win_rate={gate.get('win_rate')}  "
            f"games={gate.get('games')}  "
            f"digest={str(gate.get('digest', ''))[:16]}")
    window = chain.get("window")
    if window is not None:
        lines.append(
            f"  window  {window.get('window')}  "
            f"steps {window.get('step0')}->{window.get('step1')}  "
            f"extent={window.get('extent')}  "
            f"version={window.get('version')}  "
            f"digest={str(window.get('digest', ''))[:16]}")
    segs = chain.get("segments") or []
    for s in segs:
        lines.append(
            f"    segment {s.get('segment')}  "
            f"[{s.get('lo')},{s.get('hi')})  "
            f"gids {s.get('first_gid')}..{s.get('last_gid')}  "
            f"games={s.get('games')}")
    games = chain.get("games") or []
    if games:
        by_source: dict[str, int] = {}
        for g in games:
            by_source[g.get("source", "?")] = \
                by_source.get(g.get("source", "?"), 0) + 1
        summary = ", ".join(f"{src} ({n})"
                            for src, n in sorted(by_source.items()))
        lines.append(f"    games   {len(games)} ingested by {summary}")
    if not lines:
        lines.append("(empty chain)")
    return "\n".join(lines)


def trace_report(run_dir: str, ident: str) -> str:
    """The `cli trace` body: a request waterfall when ``ident`` matches
    a sampled trace id, else the lineage chain, else a listing of what
    IS available (so a typo'd id still tells the operator where to
    look)."""
    events = load_trace_events(run_dir)
    if ident:
        record = find_request(events, ident)
        if record is not None:
            return format_waterfall(record)
        search = find_search(events, ident)
        if search is not None:
            return format_search(search)
        chain = build_lineage(events, ident)
        if chain is not None:
            return format_lineage(chain)
        lines = [f"no trace or lineage matches {ident!r} in {run_dir}"]
    else:
        lines = [f"traces available in {run_dir}:"]
    if events["requests"]:
        lines.append("sampled request exemplars:")
        for r in sorted(events["requests"],
                        key=lambda r: -float(r.get("duration_s", 0)))[:10]:
            lines.append(
                f"  {r.get('trace_id')}  "
                f"{float(r.get('duration_s', 0)) * 1000:9.3f}ms  "
                f"status={r.get('status')}  hops={len(r.get('hops', []))}")
    if events.get("searches"):
        lines.append("search verdicts:")
        for r in events["searches"][-10:]:
            lines.append(
                f"  {r.get('search_id')}  move={_point(r.get('move'))}  "
                f"sims={r.get('simulations')}  "
                f"{float(r.get('duration_s', 0)) * 1000:8.1f}ms")
    if events["lineage"]:
        windows = [r for r in events["lineage"]
                   if r["kind"] == "lineage_window"]
        if windows:
            lines.append("lineage windows:")
            for w in windows[-10:]:
                lines.append(f"  window {w.get('window')}  "
                             f"digest={str(w.get('digest', ''))[:16]}")
        lines.append("(try `champion`, a window number, or a digest "
                     "prefix)")
    if not events["requests"] and not events["lineage"]:
        lines.append("(no trace_request or lineage events found — was "
                     "tracing armed? obs/tracing.configure_tracing or "
                     "`cli loop --trace`)")
    return "\n".join(lines)
