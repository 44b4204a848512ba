"""The campaign runner: trace replay under a fault schedule, graded.

A campaign answers one question with a JSON report: *under this
scenario, did the fleet lose headroom or did it lose answers?* The
runner:

  1. computes ground truth — every unique position in the trace is
     evaluated through the fleet BEFORE chaos starts (this also seeds
     the router's latency windows, so hedge delays are p99-derived
     from the first faulted request, not cold floors);
  2. builds canary sentinels from that ground truth and starts the
     ``CanaryProber`` and the ``ScenarioScheduler``;
  3. replays the trace open-loop (serving/replay.WorkloadReplayer),
     checking every "ok" answer against ground truth as it resolves;
  4. grades: integrity invariants (zero lost futures, zero wrong
     answers returned to callers, corrupt replicas canary-detected)
     AND the latency objective (obs/slo.HistogramLatencyObjective over
     ``deepgo_serving_request_seconds`` for the fleet's interactive
     tier, sampled as a before/after delta so the process-cumulative
     registry never bleeds one arm — or one earlier campaign — into
     the next).

The grade's shape is the robustness contract: a brownout mid-trace may
cost headroom (the SLO side, defenses earn it back) but must never cost an
answer (the integrity side, always). The port's copy of
``deepgo_tpu/chaos/campaign.py``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass

import numpy as np

from ..obs import workload as workload_mod
from ..obs.slo import HistogramLatencyObjective
from ..serving.fleet import FleetConfig
from ..serving.replay import WorkloadReplayer
from ..utils.atomicio import atomic_write
from .canary import CanaryProber, make_sentinels
from .scenario import FaultEvent, Scenario, ScenarioScheduler


@dataclass(frozen=True)
class CampaignConfig:
    """Grading and probe knobs; defaults fit a CPU smoke fleet.

    ``slo_threshold_s``/``slo_target`` define the interactive-tier
    objective ("target of requests complete within threshold").
    ``ground_truth_tier`` is the tier ground-truth evaluation submits
    under — interactive by default, ON PURPOSE: those pre-chaos
    completions fill the router's interactive latency window so the
    first hedge delay is measured, not a floor guess."""

    slo_threshold_s: float = 0.15
    slo_target: float = 0.9
    slo_tier: str = "interactive"
    canary: bool = True
    canary_interval_s: float = 0.2
    canary_timeout_s: float = 2.0
    sentinels: int = 4
    answer_rtol: float = 1e-4
    answer_atol: float = 1e-5
    request_timeout_s: float = 5.0
    collect_timeout_s: float = 15.0
    speed: float = 1.0
    ground_truth_tier: str = "interactive"
    saturate_tier: str = "batch"


def log_prob_integrity(row) -> bool:
    """Fleet-level integrity predicate for log-probability outputs: a
    real row is never positive (log_softmax), while the injected
    corruption (``1 - out``) flips it overwhelmingly positive. Cheap
    enough to run on every response."""
    arr = np.atleast_1d(np.asarray(row))
    return bool(np.max(arr) <= 1e-3)


def defended_config(base: FleetConfig | None = None,
                    integrity_check=log_prob_integrity) -> FleetConfig:
    """The gray-failure defense posture over ``base``: interactive-tier
    hedging (generous cap — campaigns WANT the hedge budget), straggler
    ejection tuned to catch a brownout within a short trace, and the
    per-response integrity guard."""
    base = base or FleetConfig()
    return dataclasses.replace(
        base, hedge_tiers=("interactive",), hedge_min_delay_s=0.03,
        hedge_max_frac=0.5, eject_stragglers=True, eject_min_samples=8,
        eject_consecutive=2, eject_factor=3.0,
        integrity_check=integrity_check)


def brownout_scenario(span_s: float, seed: int = 0,
                      brownout_ms: int = 200, replica: int = 0
                      ) -> Scenario:
    """The A/B gate's attack: one replica brownouts for ~85% of the
    trace. Hedging + ejection must hold the interactive SLO; without
    them the round-robin tiebreak keeps feeding the straggler."""
    return Scenario(name="brownout", seed=seed, events=(
        FaultEvent(at_s=0.06 * span_s, kind="slow", replica=replica,
                   duration_s=0.88 * span_s, arg=brownout_ms),))


def acceptance_scenario(span_s: float, seed: int = 0,
                        brownout_ms: int = 200,
                        corrupt_batches: int = 40) -> Scenario:
    """The full campaign: replica 0 brownouts then dies mid-window
    (its respawn re-enters the open window — a bad host back in
    rotation), while replica 1 silently corrupts until the canary
    catches it. The integrity invariants must hold throughout."""
    return Scenario(name="kill-brownout-corrupt", seed=seed, events=(
        FaultEvent(at_s=0.10 * span_s, kind="slow", replica=0,
                   duration_s=0.75 * span_s, arg=brownout_ms),
        FaultEvent(at_s=0.25 * span_s, kind="corrupt", replica=1,
                   duration_s=0.35 * span_s, arg=corrupt_batches),
        FaultEvent(at_s=0.45 * span_s, kind="kill", replica=0),))


def grade_report(report: dict) -> dict:
    """The verdict, derived from a report's measurements alone (so a
    stored report file can be re-graded). Integrity
    failures are absolute; the SLO verdict is the defense A/B's axis."""
    reasons: list[str] = []
    counts = report.get("answers", {})
    if counts.get("lost", 0) > 0:
        reasons.append(f"{counts['lost']} future(s) lost — a caller "
                       "hung with no verdict")
    if counts.get("wrong", 0) > 0:
        reasons.append(f"{counts['wrong']} wrong answer(s) returned "
                       "to callers")
    slo = report.get("slo", {})
    if not slo.get("ok", True):
        reasons.append(
            f"interactive SLO missed: {slo.get('good_frac')} within "
            f"{slo.get('threshold_s')}s < target {slo.get('target')}")
    canary = report.get("canary")
    if report.get("expects_corruption") and canary is not None:
        if not canary.get("detected"):
            reasons.append("corruption injected but never "
                           "canary-detected")
    cache = report.get("cache")
    if cache is not None and cache.get("stale_hits", 0) > 0:
        reasons.append(f"{cache['stale_hits']} stale cache hit(s) — an "
                       "answer served from a pre-reload generation")
    for r in report.get("reloads", ()):
        if not r.get("ok"):
            reasons.append(f"mid-trace reload failed: {r.get('error')}")
    return {"pass": not reasons, "reasons": reasons}


class CampaignRunner:
    """One fleet, one trace, one scenario, one graded report.

    ``fleet`` is a live FleetRouter (the caller owns its lifecycle —
    the runner never closes it); ``trace`` is replay items (``{t,
    packed, player, rank, tier}``) from serving/replay.load_trace or
    build_synthetic_requests."""

    def __init__(self, fleet, trace: list[dict], scenario: Scenario,
                 config: CampaignConfig | None = None,
                 reload_params=None):
        if not trace:
            raise ValueError("empty trace: nothing to campaign against")
        self.fleet = fleet
        self.trace = trace
        self.scenario = scenario
        self.config = config or CampaignConfig()
        # the params tree a scheduled ``reload`` event rolls through the
        # fleet mid-trace (a cache-armed campaign proves zero stale hits
        # across the invalidation); None = reload events are no-ops
        self._reload_params = reload_params
        self._reload_results: list[dict] = []

    # -- ground truth --------------------------------------------------------

    def _digest(self, item: dict) -> str:
        return workload_mod.exact_digest(
            item["packed"], item["player"], item["rank"])

    def ground_truth(self) -> dict:
        """digest -> known-good answer, evaluated through the healthy
        fleet. Must run before the scheduler starts — ground truth from
        a corrupt fleet would bless the corruption."""
        cfg = self.config
        expected: dict = {}
        pending: list[tuple[str, object]] = []
        for item in self.trace:
            digest = self._digest(item)
            if digest in expected:
                continue
            expected[digest] = None
            f = self.fleet.submit(item["packed"], item["player"],
                                  item["rank"],
                                  tier=cfg.ground_truth_tier,
                                  timeout_s=cfg.request_timeout_s)
            pending.append((digest, f))
        for digest, f in pending:
            expected[digest] = np.asarray(
                f.result(timeout=cfg.collect_timeout_s))
        return expected

    # -- the campaign --------------------------------------------------------

    def run(self, report_path: str | None = None) -> dict:
        cfg = self.config
        expected = self.ground_truth()
        items = [dict(it, digest=self._digest(it)) for it in self.trace]

        wrong: list[dict] = []

        def on_result(item, outcome, value, exc):
            if outcome != "ok":
                return
            want = expected.get(item["digest"])
            if want is None:
                return
            if not np.allclose(np.asarray(value), want,
                               rtol=cfg.answer_rtol,
                               atol=cfg.answer_atol, equal_nan=True):
                wrong.append({"digest": item["digest"],
                              "tier": item.get("tier")})

        objective = HistogramLatencyObjective(
            "chaos_interactive_latency", "deepgo_serving_request_seconds",
            cfg.slo_threshold_s, target=cfg.slo_target,
            engine=self.fleet.name, tier=cfg.slo_tier)
        good0, total0 = objective.sample()
        counter_keys = ("failovers", "respawns", "poisoned", "hedges",
                        "hedge_wins", "ejections", "integrity_failures",
                        "reloads")
        h0 = self.fleet.health()
        counters0 = {k: h0.get(k, 0) for k in counter_keys}
        cache0 = h0.get("cache") or {}

        prober = None
        if cfg.canary:
            sentinels = make_sentinels(items, expected,
                                       limit=cfg.sentinels)
            if sentinels:
                prober = CanaryProber(
                    self.fleet, sentinels,
                    interval_s=cfg.canary_interval_s,
                    timeout_s=cfg.canary_timeout_s,
                    rtol=cfg.answer_rtol, atol=cfg.answer_atol)

        def submit_burst(n: int) -> None:
            # queue pressure only: junk load on the non-critical tier,
            # futures deliberately dropped (they resolve server-side)
            for i in range(n):
                item = items[i % len(items)]
                try:
                    self.fleet.submit(item["packed"], item["player"],
                                      item["rank"],
                                      tier=cfg.saturate_tier,
                                      timeout_s=cfg.request_timeout_s)
                except Exception:  # noqa: BLE001 — shed IS saturation
                    pass

        def reload_params() -> None:
            t0 = time.time()
            try:
                out = self.fleet.reload(self._reload_params)
                self._reload_results.append(
                    {"ok": True, "replicas": out["replicas"],
                     "seconds": round(time.time() - t0, 4)})
            except Exception as e:  # noqa: BLE001 — reported in the grade
                self._reload_results.append({"ok": False,
                                             "error": repr(e)})

        scheduler = ScenarioScheduler(
            self.scenario, fleet_name=self.fleet.name,
            submit_burst=submit_burst,
            reload_params=(reload_params if self._reload_params is not None
                           else None))
        replayer = WorkloadReplayer(
            self.fleet, items, speed=cfg.speed,
            timeout_s=cfg.request_timeout_s,
            collect_timeout_s=cfg.collect_timeout_s,
            on_result=on_result)
        t_start = time.time()
        if prober is not None:
            prober.start()
        scheduler.start()
        try:
            replay_report = replayer.run()
        finally:
            scheduler.stop()
            if prober is not None:
                prober.stop()
        # a fired reload runs past the timeline on its own thread (it
        # blocks on the rolling drain); the report must not snapshot
        # counters mid-roll
        fired_reloads = sum(1 for e in scheduler.executed
                            if e["kind"] == "reload")
        deadline = time.time() + cfg.collect_timeout_s
        while (len(self._reload_results) < fired_reloads
               and time.time() < deadline):
            time.sleep(0.01)

        good1, total1 = objective.sample()
        d_total = total1 - total0
        d_good = good1 - good0
        good_frac = (d_good / d_total) if d_total > 0 else None
        bad_frac = (1.0 - good_frac) if good_frac is not None else 0.0
        outcomes = replay_report.get("outcomes", {})
        health = self.fleet.health()
        counters = {k: health.get(k, 0) - counters0[k]
                    for k in counter_keys}
        cache1 = health.get("cache")
        cache_block = None
        if cache1 is not None:
            # campaign-scoped deltas: the integrity claim is about THIS
            # run — stale_hits must not move across the mid-trace reload
            cache_block = {
                "keying": cache1.get("keying"),
                "hits": cache1.get("hits", 0) - cache0.get("hits", 0),
                "misses": (cache1.get("misses", 0)
                           - cache0.get("misses", 0)),
                "coalesced": (cache1.get("coalesced", 0)
                              - cache0.get("coalesced", 0)),
                "invalidations": (cache1.get("invalidations", 0)
                                  - cache0.get("invalidations", 0)),
                "stale_hits": (cache1.get("stale_hits", 0)
                               - cache0.get("stale_hits", 0)),
                "entries": cache1.get("entries"),
                "generation": cache1.get("generation"),
            }
        report = {
            "scenario": self.scenario.to_dict(),
            "executed": list(scheduler.executed),
            "started_unix": round(t_start, 3),
            "fleet": {"name": self.fleet.name,
                      "replicas": self.fleet.replicas},
            "defenses": {
                "hedge_tiers": list(self.fleet.config.hedge_tiers),
                "eject_stragglers":
                    bool(self.fleet.config.eject_stragglers),
                "integrity_check":
                    self.fleet.config.integrity_check is not None,
                "canary": prober is not None,
            },
            "replay": replay_report,
            "answers": {
                "checked": int(outcomes.get("ok", 0)),
                "wrong": len(wrong),
                "wrong_detail": wrong[:16],
                "lost": int(outcomes.get("lost", 0)),
            },
            "slo": {
                "tier": cfg.slo_tier,
                "threshold_s": cfg.slo_threshold_s,
                "target": cfg.slo_target,
                "requests": d_total,
                "good_frac": (round(good_frac, 4)
                              if good_frac is not None else None),
                "bad_frac": round(bad_frac, 4),
                "burn": round(bad_frac / max(1.0 - cfg.slo_target, 1e-9),
                              3),
                "ok": good_frac is not None
                      and good_frac >= cfg.slo_target,
            },
            "canary": prober.report() if prober is not None else None,
            "counters": counters,
            "cache": cache_block,
            "reloads": list(self._reload_results),
            "expects_corruption": any(e.kind == "corrupt"
                                      for e in self.scenario.events),
        }
        report["grade"] = grade_report(report)
        if report_path is not None:
            with atomic_write(report_path, mode="w") as fh:
                json.dump(report, fh, indent=2, sort_keys=True)
                fh.write("\n")
        return report
