"""High-fidelity workload replay: a captured trace, re-served live.

The port's copy of ``deepgo_tpu/serving/replay.py`` over the port's
``obs/workload``, ``sgf``, ``go.replay`` and serving errors; captures
written by either package replay in the other.

The workload observatory (obs/workload.py) records what the fleet was
asked; this module plays it back — the other half of "measure before
you optimize": a cache or surge-tier PR proves its ">2x under a
realistic opening-heavy trace" claim by replaying the SAME trace
against both arms, and a chaos bench stresses the fleet with the shape
of real traffic instead of uniform-random boards.

  * ``load_trace`` — a capture directory back as submittable items:
    each ``workload_request`` joined with its packed payload from the
    content-addressed position store (missing payloads are a typed
    error — a digest-only capture characterizes but cannot replay).
  * ``WorkloadReplayer`` — OPEN-LOOP arrival fidelity: requests are
    submitted at the recorded inter-arrival offsets (scaled by
    ``speed``), never gated on earlier responses — a slow fleet makes
    queues grow, exactly like production, instead of silently slowing
    the generator. The report quantifies fidelity (span error, mean/p99
    scheduling lag vs the recorded timeline) next to the served
    outcomes; the acceptance bar is the replayed timeline within 10%.
  * ``build_synthetic_requests`` / ``write_synthetic_capture`` — the
    opening-heavy generator for when no capture exists: real game
    openings replayed through the ``go/`` rules engine into packed
    positions, sampled with a Zipf-style popularity skew (early moves
    dominate — every game starts from the same opening tree) over
    Poisson arrivals, all derived from one seed, so two runs of the
    same spec replay the identical trace.
"""

from __future__ import annotations

import inspect
import os
import time

import numpy as np

from ..obs import workload as workload_mod
from ..obs.workload import WorkloadCaptureError
from .engine import EngineBusy
from .fleet import FleetUnavailable
from .resilience import CircuitOpen, EngineOverloaded, PoisonedRequest

DEFAULT_TIERS = ("interactive", "selfplay", "batch")


def load_trace(path: str, strict: bool = True) -> list[dict]:
    """A capture directory as replayable items, oldest first: ``{t,
    packed, player, rank, tier, session}`` per recorded request. ``strict``
    raises when any request's payload is missing from the position
    store; otherwise those requests are dropped (reported by len)."""
    cap = workload_mod.load_capture(path)
    items: list[dict] = []
    missing = 0
    for r in cap["requests"]:
        pos = cap["positions"].get(r.get("digest"))
        if pos is None or not pos.get("packed"):
            missing += 1
            continue
        items.append({
            "t": float(r.get("t", 0.0)),
            "packed": workload_mod.decode_packed(pos["packed"]),
            "player": int(r.get("player", pos.get("player", 1))),
            "rank": int(r.get("rank", pos.get("rank", 1))),
            "tier": r.get("tier"),
            "session": r.get("session"),
        })
    if missing and strict:
        raise WorkloadCaptureError(
            f"{missing}/{len(cap['requests'])} recorded request(s) have "
            f"no stored payload in {path!r} — capture is not replayable "
            "(recorded with store_positions=False?)")
    return items


class WorkloadReplayer:
    """Replay one trace against a live engine/fleet at ``speed``x.

    ``engine`` is anything with the serving ``submit`` surface — a bare
    ``InferenceEngine``, a ``SupervisedEngine``, or a ``FleetRouter``
    (tier-aware submit detected by signature, so recorded tiers travel
    when the target understands them). The scheduler is one thread (the
    caller's): it sleeps to each request's target offset, submits, and
    moves on — responses resolve concurrently on the serving side and
    are collected after the send loop (open loop). Clock and sleep are
    injectable; the fidelity tests drive a fake clock."""

    def __init__(self, engine, trace: list[dict], speed: float = 1.0,
                 timeout_s: float | None = None,
                 collect_timeout_s: float = 60.0, on_result=None,
                 clock=time.monotonic, sleep=time.sleep):
        if speed <= 0:
            raise ValueError(f"speed must be > 0, got {speed}")
        if not trace:
            raise ValueError("empty trace: nothing to replay")
        self.engine = engine
        self.trace = sorted(trace, key=lambda r: float(r.get("t", 0.0)))
        self.speed = float(speed)
        self.timeout_s = timeout_s
        self.collect_timeout_s = float(collect_timeout_s)
        # per-request observer: on_result(item, outcome, value, exc) —
        # the chaos campaign's wrong-answer and lost-future accounting
        # rides here instead of a second pass over private state
        self.on_result = on_result
        self._clock = clock
        self._sleep = sleep
        params = inspect.signature(engine.submit).parameters
        self._accepts_tier = "tier" in params
        self._accepts_session = "session" in params

    def run(self) -> dict:
        t_base = float(self.trace[0].get("t", 0.0))
        targets = [(float(r.get("t", 0.0)) - t_base) / self.speed
                   for r in self.trace]
        actuals: list[float] = []
        futures: list = []
        # "lost" extends the capture-outcome vocabulary for replay only:
        # a future nobody resolved within collect_timeout_s — the
        # integrity invariant chaos campaigns exist to check
        outcomes = {o: 0 for o in (*workload_mod.OUTCOMES, "lost")}
        tiers: dict[str, int] = {}
        t0 = self._clock()
        for item, target in zip(self.trace, targets):
            now = self._clock() - t0
            if now < target:
                self._sleep(target - now)
            kw = {}
            if self._accepts_tier and item.get("tier") is not None:
                kw["tier"] = item["tier"]
            if self._accepts_session and item.get("session") is not None:
                kw["session"] = item["session"]
            tier = str(item.get("tier") or "untiered")
            tiers[tier] = tiers.get(tier, 0) + 1
            try:
                futures.append(self.engine.submit(
                    item["packed"], item["player"], item["rank"],
                    timeout_s=self.timeout_s, **kw))
            except (EngineOverloaded, CircuitOpen, EngineBusy,
                    FleetUnavailable):
                futures.append(None)  # counted as shed at collection
            actuals.append(self._clock() - t0)
        for item, f in zip(self.trace, futures):
            value = exc = None
            if f is None:
                outcome = "shed"
            else:
                try:
                    value = f.result(timeout=self.collect_timeout_s)
                    outcome = "ok"
                except TimeoutError as e:
                    # a future STILL unresolved after the collection
                    # grace is lost — dropped by a failover hole, not
                    # merely late; a resolved TimeoutError is a
                    # deadline verdict the serving side delivered
                    outcome = "lost" if not f.done() else "timeout"
                    exc = e
                except (EngineOverloaded, CircuitOpen, EngineBusy,
                        FleetUnavailable) as e:
                    outcome, exc = "shed", e
                except PoisonedRequest as e:
                    outcome, exc = "poisoned", e
                except BaseException as e:  # noqa: BLE001 — an outcome
                    outcome, exc = "failed", e
            outcomes[outcome] += 1
            if self.on_result is not None:
                self.on_result(item, outcome, value, exc)
        wall = self._clock() - t0
        target_span = targets[-1]
        actual_span = actuals[-1] - actuals[0] if len(actuals) > 1 else 0.0
        lags = np.abs(np.array(actuals) - np.array(targets))
        report = {
            "requests": len(self.trace),
            "speed": self.speed,
            "target_span_s": round(target_span, 6),
            "actual_span_s": round(actual_span, 6),
            "span_error_frac": round(
                abs(actual_span - target_span) / target_span, 6)
            if target_span > 0 else 0.0,
            "mean_lag_ms": round(float(lags.mean()) * 1000, 3),
            "p99_lag_ms": round(float(np.percentile(lags, 99)) * 1000, 3),
            "lag_frac": round(float(lags.mean()) / target_span, 6)
            if target_span > 0 else 0.0,
            "wall_s": round(wall, 4),
            "boards_per_sec": round(len(self.trace) / wall, 1)
            if wall > 0 else None,
            "tiers": {t: tiers[t] for t in sorted(tiers)},
            "outcomes": {o: n for o, n in outcomes.items() if n},
        }
        # the acceptance bar: the replayed timeline within 10% of the
        # recorded one, both in total span and in mean per-request lag
        report["fidelity_ok"] = (report["span_error_frac"] <= 0.10
                                 and report["lag_frac"] <= 0.10)
        return report


# ---------------------------------------------------------------------------
# the synthetic opening-heavy generator

def _opening_pool(sgf_dir: str, games: int, opening_moves: int
                  ) -> list[dict]:
    """Packed positions from the first ``opening_moves`` plies of up to
    ``games`` real games: the shared-opening-tree duplication is REAL —
    every game's move-0 position is the same empty board, and early
    joseki repeat across games."""
    from ..go.replay import replay_positions
    from ..sgf import parse_file

    paths: list[str] = []
    for dirpath, dirnames, filenames in os.walk(sgf_dir):
        dirnames.sort()
        paths.extend(os.path.join(dirpath, n) for n in sorted(filenames)
                     if n.endswith(".sgf"))
    pool: list[dict] = []
    used = 0
    for path in paths:
        if used >= games:
            break
        try:
            game = parse_file(path)
        except (OSError, ValueError):
            continue
        if not game.moves:
            continue
        used += 1
        ranks = game.ranks or (5, 5)
        for i, (packed, move) in enumerate(replay_positions(game)):
            if i >= opening_moves:
                break
            pool.append({
                "packed": packed,
                "player": int(move.player),
                "rank": int(ranks[move.player - 1]),
                "move": i,
            })
    if not pool:
        raise WorkloadCaptureError(
            f"no usable SGF games under {sgf_dir!r} — cannot build a "
            "synthetic opening pool")
    return pool


def build_synthetic_requests(sgf_dir: str, requests: int = 512,
                             games: int = 32, opening_moves: int = 12,
                             rate_per_s: float = 200.0,
                             zipf_s: float = 1.1, seed: int = 0,
                             tiers: tuple = DEFAULT_TIERS,
                             tier_weights: tuple = (0.6, 0.3, 0.1)
                             ) -> list[dict]:
    """A deterministic (seed-derived) opening-heavy trace, in memory.

    Popularity is doubly skewed: the pool already duplicates early
    positions across games (the real opening tree), and sampling
    weights decay with move number as ``1/(1+move)^zipf_s`` — so
    move-0/1 positions dominate the way a production opening-explorer
    workload does. Arrivals are Poisson at ``rate_per_s`` (burstiness
    ~0 by construction; the analyzer measures, not assumes)."""
    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    pool = _opening_pool(sgf_dir, games, opening_moves)
    rng = np.random.default_rng(seed)
    weights = np.array([1.0 / (1.0 + p["move"]) ** zipf_s for p in pool])
    weights /= weights.sum()
    picks = rng.choice(len(pool), size=requests, p=weights)
    tw = np.array(tier_weights, dtype=np.float64)
    tw /= tw.sum()
    tier_picks = rng.choice(len(tiers), size=requests, p=tw)
    offsets = np.cumsum(rng.exponential(1.0 / rate_per_s, size=requests))
    items = []
    for i in range(requests):
        p = pool[int(picks[i])]
        items.append({
            "t": float(offsets[i]),
            "packed": p["packed"],
            "player": p["player"],
            "rank": p["rank"],
            "tier": str(tiers[int(tier_picks[i])]),
        })
    return items


def write_synthetic_capture(out_dir: str, items: list[dict]) -> dict:
    """Persist an in-memory synthetic trace in the standard capture
    layout (workload.jsonl + positions.jsonl), digests included, so
    ``cli workload analyze|replay`` and ``bench --trace`` consume
    synthetic and recorded captures identically."""
    from ..obs.exporter import JsonlSink

    os.makedirs(out_dir, exist_ok=True)
    seen: set[str] = set()
    canon: set[str] = set()
    with JsonlSink(os.path.join(out_dir, "workload.jsonl")) as sink, \
            JsonlSink(os.path.join(out_dir, "positions.jsonl")) as pos_sink:
        for item in items:
            digest = workload_mod.exact_digest(
                item["packed"], item["player"], item["rank"])
            canonical = workload_mod.canonical_digest(
                item["packed"], item["player"], item["rank"])
            canon.add(canonical)
            if digest not in seen:
                seen.add(digest)
                pos_sink.write(
                    "workload_position", digest=digest,
                    canonical=canonical, player=item["player"],
                    rank=item["rank"],
                    packed=workload_mod.encode_packed(item["packed"]))
            sink.write("workload_request", t=item["t"], digest=digest,
                       canonical=canonical, player=item["player"],
                       rank=item["rank"], tier=item.get("tier"),
                       outcome="synthetic", synthetic=True)
        sink.write("workload_capture", started=len(items),
                   finished=len(items), dropped=0, unique=len(seen),
                   canonical_unique=len(canon), synthetic=True)
    return {"requests": len(items), "unique": len(seen),
            "canonical_unique": len(canon), "dir": out_dir}
