"""Workload observatory: what the fleet is actually asked to serve.

The port's copy of ``deepgo_tpu/obs/workload.py``: the same capture
format, so a capture written by either package loads in the other. The
capture readers take ``read_events``
and ``JsonlSink`` from the port's ``obs/exporter.py``. Metrics and traces
observe the SYSTEM; this module observes the TRAFFIC: which positions
arrive, how duplicated they are, and how bursty the arrival process is
(what the position cache's hit rate depends on):

  * ``WorkloadRecorder`` — tapped into ``FleetRouter.submit`` /
    ``SupervisedEngine.submit`` / ``InferenceEngine.submit`` exactly
    like request tracing: OFF by default, every plumbing site a
    ``workload is None`` check. Each request
    streams one ``workload_request`` JSONL record — arrival wall time,
    tier, bucket, outcome, latency — keyed by TWO content digests of
    the packed feature planes: the exact digest and the 8-fold-symmetry
    CANONICAL digest (all dihedral views of a position share one key —
    the identity the position cache coalesces on). Digests are
    computed on the recorder's writer thread, never on the submit path;
    the hot path pays one ~3.2KB ``tobytes`` copy and a bounded-queue
    put. Each distinct exact digest additionally writes one
    ``workload_position`` record carrying the packed payload (base64),
    so a capture is REPLAYABLE: the position store is content-addressed
    and deduplicated — an opening-heavy hour of traffic stores each
    opening once.
  * the **analyzer** (``analyze_capture``) — joins a capture into the
    characterization report: unique-vs-total positions, the
    symmetry-dedup gain, popularity skew (top-k mass, Zipf fit),
    inter-arrival burstiness, tier/bucket/outcome mix, and the
    **projected cache hit rate**.
  * the replay side (``serving/replay.py``: ``WorkloadReplayer`` and the
    synthetic opening-heavy generator) reads the same format.

Capture layout: one directory holding ``workload.jsonl`` (the request
stream) and ``positions.jsonl`` (the deduplicated position store), both
rotation-aware ``JsonlSink`` streams read back through the torn-line-
tolerant ``read_events``.
"""

from __future__ import annotations

import base64
import os
import queue
import threading
import time

import numpy as np

from ..analysis.lockcheck import make_lock
from ..utils import digest as _digest
from .registry import get_registry

# digest math lives in utils/digest.py — ONE implementation shared with
# the position cache (serving/cache.py) and training augmentation
# (ops/augment.py); the names below stay re-exported because captures,
# tools, and tests address them through this module
PACKED_SHAPE = _digest.PACKED_SHAPE
_NUM_POINTS = _digest.NUM_POINTS

_DIGEST_HEX = _digest.DIGEST_HEX

# request outcomes a capture distinguishes (the replay side reproduces
# the submit mix; outcomes re-resolve live)
OUTCOMES = ("ok", "shed", "timeout", "poisoned", "failed")

_SHED_ERRORS = frozenset({"EngineOverloaded", "CircuitOpen", "EngineBusy",
                          "FleetUnavailable"})
_POISON_ERRORS = frozenset({"PoisonedRequest"})


class WorkloadCaptureError(RuntimeError):
    """A capture directory is missing, unreadable, or not a capture."""


_dihedral_perms = _digest.dihedral_perms
_PERMS = _digest.PERMS
NUM_SYMMETRIES = _digest.NUM_SYMMETRIES

_digest_bytes = _digest.digest_bytes
exact_digest = _digest.exact_digest
canonical_digest = _digest.canonical_digest
dihedral_views = _digest.dihedral_views


def encode_packed(packed: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(np.asarray(packed, dtype=np.uint8))
        .tobytes()).decode("ascii")


def decode_packed(payload: str) -> np.ndarray:
    raw = base64.b64decode(payload)
    arr = np.frombuffer(raw, dtype=np.uint8)
    if arr.size != int(np.prod(PACKED_SHAPE)):
        raise WorkloadCaptureError(
            f"position payload has {arr.size} bytes, expected "
            f"{int(np.prod(PACKED_SHAPE))}")
    return arr.reshape(PACKED_SHAPE).copy()


class WorkloadToken:
    """One request's tap: created by the OUTERMOST serving layer the
    caller entered (fleet router, supervisor, or bare engine — the same
    ownership discipline as tracing.TraceContext), handed down so the
    engine can stamp the bucket the request coalesced into. ``finish``
    is idempotent; exactly one record reaches the recorder."""

    __slots__ = ("payload", "player", "rank", "tier", "fields", "t_wall",
                 "t_mono", "bucket", "_recorder", "_finished")

    def __init__(self, recorder: "WorkloadRecorder", payload: bytes,
                 player: int, rank: int, tier: str | None, **fields):
        self.payload = payload
        self.player = int(player)
        self.rank = int(rank)
        self.tier = tier
        self.fields = {k: v for k, v in fields.items() if v is not None}
        self.t_wall = time.time()
        self.t_mono = time.monotonic()
        self.bucket: int | None = None
        self._recorder = recorder
        self._finished = False

    def finish(self, outcome: str) -> None:
        if self._finished:
            return
        self._finished = True
        latency = time.monotonic() - self.t_mono
        rec = self._recorder
        if rec is not None:
            rec.commit(self, outcome, latency)

    def finish_future(self, f) -> None:
        """The owner's done-callback target: classify the resolved
        future into a workload outcome. Never raises — a recording bug
        must not strand the future's waiter."""
        try:
            exc = f.exception()
        except BaseException:  # noqa: BLE001 — cancelled future
            exc = None
        if exc is None:
            self.finish("ok")
            return
        name = type(exc).__name__
        if isinstance(exc, TimeoutError):
            self.finish("timeout")
        elif name in _SHED_ERRORS:
            self.finish("shed")
        elif name in _POISON_ERRORS:
            self.finish("poisoned")
        else:
            self.finish("failed")


class WorkloadRecorder:
    """Streams the capture: a bounded hand-off queue feeds one writer
    thread that computes both digests, deduplicates the position store,
    and writes the two JSONL streams. The submit path never hashes and
    never touches disk; a full queue DROPS (counted — a flooded
    recorder backs off rather than backpressuring the serving path)."""

    def __init__(self, sink, position_sink=None, max_queue: int = 4096,
                 store_positions: bool = True):
        self.sink = sink
        self.position_sink = position_sink if position_sink is not None \
            else sink
        self.store_positions = store_positions
        self.enabled = True
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._lock = make_lock("obs.workload")
        self._seen: set[str] = set()        # exact digests already stored
        self._canonical: set[str] = set()
        # exact -> canonical memo: a duplicate request (the common case
        # in the opening-heavy workloads this exists to measure) costs
        # the writer ONE content hash, not the nine of a fresh orbit
        self._canon_of: dict[str, str] = {}
        self.started = 0
        self.finished = 0
        self.dropped = 0
        self.by_tier: dict[str, int] = {}
        self.by_outcome: dict[str, int] = {}
        reg = get_registry()
        self._obs_requests = reg.counter(
            "deepgo_workload_requests_total",
            "requests entering the serving path with the workload "
            "recorder armed, by priority tier")
        self._closing = threading.Event()
        self._thread = threading.Thread(
            target=self._writer_loop, name="workload-writer", daemon=True)
        self._thread.start()

    # -- the hot path ------------------------------------------------------

    def note(self, packed, player: int, rank: int, tier: str | None = None,
             **fields) -> WorkloadToken:
        token = WorkloadToken(
            self, np.ascontiguousarray(np.asarray(packed, dtype=np.uint8))
            .tobytes(), player, rank, tier, **fields)
        with self._lock:
            self.started += 1
        return token

    def commit(self, token: WorkloadToken, outcome: str,
               latency_s: float) -> None:
        try:
            self._queue.put_nowait((token, outcome, latency_s))
        except queue.Full:
            with self._lock:
                self.dropped += 1

    # -- the writer thread -------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                self._flush_sinks()
                if self._closing.is_set():
                    return
                continue
            try:
                self._write_one(*item)
            except (OSError, ValueError):
                pass  # a full disk must not kill the serving path

    def _flush_sinks(self) -> None:
        """Idle flush for block-buffered sinks: records become durable
        within one poll interval of the stream going quiet."""
        for sink in (self.sink, self.position_sink):
            flush = getattr(sink, "flush", None)
            if flush is not None:
                try:
                    flush()
                except (OSError, ValueError):
                    pass

    def _write_one(self, token: WorkloadToken, outcome: str,
                   latency_s: float) -> None:
        digest = _digest_bytes(token.payload, token.player, token.rank)
        canonical = self._canon_of.get(digest)
        if canonical is None:
            arr = np.frombuffer(token.payload, dtype=np.uint8) \
                .reshape(PACKED_SHAPE)
            canonical = canonical_digest(arr, token.player, token.rank)
        with self._lock:
            fresh = digest not in self._seen
            if fresh:
                self._seen.add(digest)
                self._canon_of[digest] = canonical
            self._canonical.add(canonical)
            self.finished += 1
            tier = token.tier or "untiered"
            self.by_tier[tier] = self.by_tier.get(tier, 0) + 1
            self.by_outcome[outcome] = self.by_outcome.get(outcome, 0) + 1
        # the arrival counter rides the writer, not the submit path —
        # the scrape lags by at most the hand-off queue's depth
        self._obs_requests.inc(tier=tier)
        if fresh and self.store_positions:
            self.position_sink.write(
                "workload_position", digest=digest, canonical=canonical,
                player=token.player, rank=token.rank,
                packed=base64.b64encode(token.payload).decode("ascii"))
        record = {
            "t": token.t_wall,
            "digest": digest,
            "canonical": canonical,
            "player": token.player,
            "rank": token.rank,
            "outcome": outcome,
            "latency_s": round(latency_s, 9),
            **token.fields,
        }
        if token.tier is not None:
            record["tier"] = token.tier
        if token.bucket is not None:
            record["bucket"] = int(token.bucket)
        self.sink.write("workload_request", **record)

    # -- read side ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "started": self.started,
                "finished": self.finished,
                "pending": self.started - self.finished - self.dropped,
                "dropped": self.dropped,
                "unique": len(self._seen),
                "canonical_unique": len(self._canonical),
                "by_tier": dict(self.by_tier),
                "by_outcome": dict(self.by_outcome),
            }

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Block until every committed record is on disk (bounded)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._queue.empty():
                return True
            time.sleep(0.005)
        return self._queue.empty()

    def close(self, timeout_s: float = 10.0) -> dict:
        """Drain, stamp the ``workload_capture`` summary record, stop
        the writer. Returns the final stats. Idempotent."""
        self.drain(timeout_s)
        self._closing.set()
        self._thread.join(timeout=timeout_s)
        stats = self.stats()
        if self.enabled:
            self.enabled = False
            try:
                self.sink.write("workload_capture", **{
                    k: v for k, v in stats.items() if k != "pending"})
            except (OSError, ValueError):
                pass
        return stats


# ---------------------------------------------------------------------------
# the process-wide recorder (the serving layers' entry point)

_recorder: WorkloadRecorder | None = None
_owned_sinks: list = []


def configure_workload(capture_dir: str | None = None, sink=None,
                       position_sink=None, **kw) -> WorkloadRecorder:
    """Arm process-wide workload capture (idempotent — reconfiguring
    replaces the recorder). ``capture_dir`` builds the standard layout
    (``workload.jsonl`` + ``positions.jsonl``); alternatively pass
    explicit sinks (tests, bench A/B arms)."""
    global _recorder
    disable_workload()
    if sink is None:
        if capture_dir is None:
            raise ValueError("configure_workload needs capture_dir or sink")
        from .exporter import JsonlSink

        os.makedirs(capture_dir, exist_ok=True)
        # block-buffered: the writer thread flushes on idle instead of
        # paying a syscall per record — at serving rates the per-line
        # flush is most of the recorder's measured overhead
        sink = JsonlSink(os.path.join(capture_dir, "workload.jsonl"),
                         buffering=1 << 16)
        position_sink = JsonlSink(os.path.join(capture_dir,
                                               "positions.jsonl"),
                                  buffering=1 << 16)
        _owned_sinks.extend([sink, position_sink])
    _recorder = WorkloadRecorder(sink, position_sink=position_sink, **kw)
    return _recorder


def disable_workload() -> None:
    """Disarm: ``note_request`` returns None again and every plumbing
    site reverts to its zero-cost ``workload is None`` branch. Closes
    the recorder (capture summary stamped) and any owned sinks."""
    global _recorder
    rec, _recorder = _recorder, None
    if rec is not None:
        rec.close()
    while _owned_sinks:
        try:
            _owned_sinks.pop().close()
        except (OSError, ValueError):  # pragma: no cover — close race
            pass


def workload_enabled() -> bool:
    return _recorder is not None and _recorder.enabled


def get_workload_recorder() -> WorkloadRecorder | None:
    return _recorder


def note_request(packed, player: int, rank: int, tier: str | None = None,
                 **fields) -> WorkloadToken | None:
    """The serving layers' creation point: a live WorkloadToken when the
    recorder is armed, None (the zero-overhead path) otherwise."""
    rec = _recorder
    if rec is None or not rec.enabled:
        return None
    return rec.note(packed, player, rank, tier=tier, **fields)


# ---------------------------------------------------------------------------
# capture reading + the characterization report

def _capture_paths(path: str) -> tuple[str, str]:
    """(requests stream, positions stream) for a capture directory or a
    direct workload.jsonl path."""
    if os.path.isdir(path):
        return (os.path.join(path, "workload.jsonl"),
                os.path.join(path, "positions.jsonl"))
    return path, os.path.join(os.path.dirname(path), "positions.jsonl")


def load_capture(path: str) -> dict:
    """Read one capture back: requests oldest-first (by arrival stamp),
    the position store keyed by exact digest, and the close-time
    summary when the capture was cleanly closed. Torn lines are skipped
    (read_events); a missing stream is a typed error."""
    from .exporter import read_events

    req_path, pos_path = _capture_paths(path)
    if not os.path.exists(req_path):
        raise WorkloadCaptureError(
            f"no workload capture at {path!r} (expected {req_path})")
    requests = []
    captures = []
    positions: dict[str, dict] = {}
    for r in read_events(req_path):
        kind = r.get("kind")
        if kind == "workload_request":
            requests.append(r)
        elif kind == "workload_capture":
            captures.append(r)
        elif kind == "workload_position":
            positions[r["digest"]] = r
    for r in read_events(pos_path):
        if r.get("kind") == "workload_position":
            positions[r["digest"]] = r
    requests.sort(key=lambda r: float(r.get("t", 0.0)))
    return {"requests": requests, "positions": positions,
            "summary": captures[-1] if captures else None}


def _zipf_fit(counts: list[int]) -> float | None:
    """Least-squares slope of log(freq) on log(rank) over the sorted
    popularity counts — the Zipf exponent estimate (negated, so ~1.0
    is classic Zipf). None below 3 distinct positions."""
    if len(counts) < 3:
        return None
    ranks = np.arange(1, len(counts) + 1, dtype=np.float64)
    freqs = np.array(sorted(counts, reverse=True), dtype=np.float64)
    x, y = np.log(ranks), np.log(freqs)
    slope = float(np.polyfit(x, y, 1)[0])
    return round(-slope, 4)


def _characterize_sessions(by_session: dict[str, list[float]],
                           top_n: int = 8) -> dict:
    """The per-session view of a labeled capture: how many distinct
    sessions, how much of the traffic carries a label, and — for the
    busiest ``top_n`` — each session's own arrival burstiness (Goh &
    Barabasi, same convention as the global interarrival block), which
    is what distinguishes session-shaped traffic (think-time gaps) from
    scan-shaped saturation."""
    top = {}
    busiest = sorted(by_session.items(),
                     key=lambda kv: (-len(kv[1]), kv[0]))[:top_n]
    for sid, times in busiest:
        entry: dict = {"requests": len(times)}
        inter = np.diff(np.array(sorted(times)))
        if inter.size >= 2:
            mean = float(inter.mean())
            cv = float(inter.std()) / mean if mean > 0 else None
            entry["burstiness"] = (round((cv - 1) / (cv + 1), 4)
                                   if cv is not None else None)
        top[sid] = entry
    return {
        "count": len(by_session),
        "labeled_requests": sum(len(t) for t in by_session.values()),
        "top": top,
    }


def characterize(requests: list[dict]) -> dict:
    """The analyzer core over already-loaded request records (the
    capture-file-free entry bench and tests use)."""
    total = len(requests)
    if total == 0:
        return {"requests": 0}
    exact: dict[str, int] = {}
    canon: dict[str, int] = {}
    by_tier: dict[str, int] = {}
    by_bucket: dict[str, int] = {}
    by_outcome: dict[str, int] = {}
    by_session: dict[str, list[float]] = {}
    latencies: list[float] = []
    search_canon: dict[str, int] = {}
    search_sessions: set[str] = set()
    for r in requests:
        d = r.get("digest")
        c = r.get("canonical", d)
        exact[d] = exact.get(d, 0) + 1
        canon[c] = canon.get(c, 0) + 1
        if r.get("session") is not None:
            sid = str(r["session"])
            by_session.setdefault(sid, []).append(float(r.get("t", 0.0)))
            if sid.startswith("search:"):
                search_canon[c] = search_canon.get(c, 0) + 1
                search_sessions.add(sid)
        tier = str(r.get("tier") or "untiered")
        by_tier[tier] = by_tier.get(tier, 0) + 1
        if r.get("bucket") is not None:
            b = str(r["bucket"])
            by_bucket[b] = by_bucket.get(b, 0) + 1
        outcome = str(r.get("outcome") or "unknown")
        by_outcome[outcome] = by_outcome.get(outcome, 0) + 1
        if r.get("latency_s") is not None:
            latencies.append(float(r["latency_s"]))
    unique = len(exact)
    canonical_unique = len(canon)
    counts = sorted(canon.values(), reverse=True)
    top_mass = {
        str(k): round(sum(counts[:k]) / total, 4)
        for k in (1, 10, 100) if k <= len(counts) or k == 1}
    times = sorted(float(r.get("t", 0.0)) for r in requests)
    span = times[-1] - times[0] if total > 1 else 0.0
    inter = np.diff(np.array(times)) if total > 1 else np.array([])
    interarrival = None
    if inter.size:
        mean = float(inter.mean())
        std = float(inter.std())
        cv = std / mean if mean > 0 else None
        interarrival = {
            "mean_ms": round(mean * 1000, 4),
            "p99_ms": round(float(np.percentile(inter, 99)) * 1000, 4),
            "cv": round(cv, 4) if cv is not None else None,
            # Goh & Barabasi burstiness: -1 periodic, 0 Poisson, ->1 bursty
            "burstiness": round((cv - 1) / (cv + 1), 4)
            if cv is not None else None,
        }
    out = {
        "requests": total,
        "unique": unique,
        "canonical_unique": canonical_unique,
        "dup_ratio": round(1.0 - unique / total, 4),
        "symmetry_dedup_gain": round(unique / canonical_unique, 4),
        # the cache-PR gate numbers: an infinite exact-hit cache serves
        # dup requests for free; the canonical variant also folds all 8
        # dihedral views of a position onto one entry
        "projected_hit_rate": round(1.0 - unique / total, 4),
        "projected_hit_rate_canonical": round(
            1.0 - canonical_unique / total, 4),
        "top_mass": top_mass,
        "zipf_exponent": _zipf_fit(list(canon.values())),
        "span_s": round(span, 4),
        "requests_per_sec": round(total / span, 2) if span > 0 else None,
        "tiers": {t: by_tier[t] for t in sorted(by_tier)},
        "outcomes": {o: by_outcome[o] for o in sorted(by_outcome)},
    }
    if by_bucket:
        out["buckets"] = {b: by_bucket[b]
                          for b in sorted(by_bucket, key=int)}
    if by_session:
        out["sessions"] = _characterize_sessions(by_session)
    if search_canon:
        # the search-shaped slice: leaf evaluations labeled
        # ``search:<id>`` by the PUCT searcher. The transposition dup
        # ratio is how much of the search's leaf traffic the
        # transposition table / canonical cache serves for free —
        # the measured justification for keying the tree on the
        # content-addressed digests
        s_total = sum(search_canon.values())
        out["search"] = {
            "requests": s_total,
            "searches": len(search_sessions),
            "canonical_unique": len(search_canon),
            "transposition_dup_ratio": round(
                1.0 - len(search_canon) / s_total, 4),
        }
    if interarrival is not None:
        out["interarrival"] = interarrival
    if latencies:
        lat = np.array(latencies)
        out["latency_ms"] = {
            "p50": round(float(np.percentile(lat, 50)) * 1000, 3),
            "p99": round(float(np.percentile(lat, 99)) * 1000, 3),
        }
    return out


def analyze_capture(path: str) -> dict:
    """The full characterization report for one capture directory."""
    cap = load_capture(path)
    out = characterize(cap["requests"])
    out["capture"] = path
    out["positions_stored"] = len(cap["positions"])
    replayable = bool(cap["positions"]) and all(
        r.get("digest") in cap["positions"] for r in cap["requests"])
    out["replayable"] = replayable
    if cap["summary"] is not None:
        out["recorder_dropped"] = cap["summary"].get("dropped", 0)
    return out


def format_workload(stats: dict) -> str:
    """Terminal rendering of one characterization report."""
    if not stats.get("requests"):
        return "(empty capture: no workload_request records)"
    lines = []
    if stats.get("capture"):
        lines.append(f"capture: {stats['capture']}")
    lines.append(
        f"requests {stats['requests']}  unique {stats['unique']}  "
        f"canonical {stats['canonical_unique']}  "
        f"dup_ratio {stats['dup_ratio']:.2%}")
    lines.append(
        f"projected cache hit rate: exact {stats['projected_hit_rate']:.2%}"
        f"  canonical {stats['projected_hit_rate_canonical']:.2%}  "
        f"(symmetry dedup gain {stats['symmetry_dedup_gain']:.2f}x)")
    top = stats.get("top_mass", {})
    if top:
        lines.append("popularity: " + "  ".join(
            f"top-{k} mass {v:.2%}" for k, v in top.items())
            + (f"  zipf~{stats['zipf_exponent']}"
               if stats.get("zipf_exponent") is not None else ""))
    inter = stats.get("interarrival")
    if inter:
        lines.append(
            f"arrivals: {stats.get('requests_per_sec')}/s over "
            f"{stats.get('span_s')}s  interarrival mean "
            f"{inter['mean_ms']}ms p99 {inter['p99_ms']}ms  "
            f"cv {inter['cv']}  burstiness {inter['burstiness']}")
    sess = stats.get("sessions")
    if sess:
        parts = []
        for sid, entry in sess["top"].items():
            b = entry.get("burstiness")
            parts.append(f"{sid}={entry['requests']}"
                         + (f" (B {b})" if b is not None else ""))
        lines.append(
            f"sessions: {sess['count']} distinct  "
            f"{sess['labeled_requests']} labeled requests  "
            + "  ".join(parts))
    search = stats.get("search")
    if search:
        lines.append(
            f"search: {search['requests']} leaf evals across "
            f"{search['searches']} searches  canonical "
            f"{search['canonical_unique']}  transposition dup ratio "
            f"{search['transposition_dup_ratio']:.2%}")
    for name in ("tiers", "buckets", "outcomes"):
        mix = stats.get(name)
        if mix:
            total = sum(mix.values())
            lines.append(f"{name}: " + "  ".join(
                f"{k}={v} ({v / total:.1%})" for k, v in mix.items()))
    if stats.get("latency_ms"):
        lines.append(f"latency: p50 {stats['latency_ms']['p50']}ms  "
                     f"p99 {stats['latency_ms']['p99']}ms")
    if "replayable" in stats:
        lines.append(
            f"positions stored: {stats.get('positions_stored')}  "
            f"replayable: {stats['replayable']}"
            + (f"  recorder_dropped: {stats['recorder_dropped']}"
               if stats.get("recorder_dropped") else ""))
    return "\n".join(lines)
