"""The port's chaos campaigns (``deepgo_tpu_torch/chaos``) against the JAX
package's, on the CPU.

The chaos modules are copies over the port's fleet, ``WorkloadReplayer``,
``obs/slo`` and ``utils/faults``. Bars:

* scenarios (the presets and hand-made ones) serialise to the same dicts,
  load in the other package, and expand into the same schedule;
* ``grade_report``, ``log_prob_integrity``, ``defended_config`` and
  ``make_sentinels`` agree on the same inputs;
* a whole campaign (kill + brownout + corrupt, canaries on) on numpy-stub
  fleets of both packages grades the same: no future lost, no wrong
  answer, the corrupt replica canary-detected, with the lock-order
  sanitizer armed and no inversion found.
"""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from deepgo_tpu import chaos as jax_chaos
from deepgo_tpu import serving as jax_serving
from deepgo_tpu.analysis import lockcheck as jax_lockcheck
from deepgo_tpu.obs import registry as jax_registry
from deepgo_tpu.utils import faults as jax_faults

from deepgo_tpu_torch import chaos, serving
from deepgo_tpu_torch.analysis import lockcheck
from deepgo_tpu_torch.utils import faults

torch.set_num_threads(2)

PKGS = {"jax": (jax_chaos, jax_serving, jax_faults, jax_lockcheck),
        "port": (chaos, serving, faults, lockcheck)}


@pytest.fixture(scope="module", autouse=True)
def private_jax_registry():
    """The JAX package's calls in this file count into a metrics registry
    of their own. Its process-wide one feeds the ``obs_snapshot`` of every
    later JAX run in this worker, and tests/test_attribution.py holds its
    run's train-step total to its own 30 steps."""
    saved = jax_registry._default
    jax_registry._default = jax_registry.MetricsRegistry()
    yield
    jax_registry._default = saved


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DEEPGO_FAULTS", raising=False)
    for _, _, f, _ in PKGS.values():
        f.reset()
    yield
    for _, _, f, _ in PKGS.values():
        f.reset()


def _scenarios(c, span):
    return [c.acceptance_scenario(span, seed=3),
            c.acceptance_scenario(span, brownout_ms=50, corrupt_batches=7),
            c.brownout_scenario(span, replica=1, brownout_ms=80),
            c.Scenario(name="mixed", seed=9, events=(
                c.FaultEvent(at_s=0.0, kind="saturate", arg=12),
                c.FaultEvent(at_s=0.2 * span, kind="reload"),
                c.FaultEvent(at_s=0.3 * span, kind="wal", arg=2,
                             duration_s=0.1 * span),
                c.FaultEvent(at_s=0.4 * span, kind="reply", arg=1),
                c.FaultEvent(at_s=0.5 * span, kind="corrupt", replica=2,
                             arg=3, duration_s=0.2 * span),
                c.FaultEvent(at_s=0.6 * span, kind="kill", replica=1)))]


@pytest.mark.parametrize("span", [0.5, 2.56, 10.0])
def test_scenarios_and_schedules_like_jax(span):
    ours, theirs = _scenarios(chaos, span), _scenarios(jax_chaos, span)
    for sc, jsc in zip(ours, theirs):
        assert sc.to_dict() == jsc.to_dict()
        wire = json.loads(json.dumps(jsc.to_dict()))
        assert chaos.Scenario.from_dict(wire) == sc
        assert sc.span_s() == jsc.span_s()
        got = chaos.ScenarioScheduler(sc, fleet_name="f")._expand()
        want = jax_chaos.ScenarioScheduler(jsc, fleet_name="f")._expand()
        # (offset, event, phase, action): the actions are closures
        assert [(t, ev.to_dict(), phase) for t, ev, phase, _ in got] == \
            [(t, ev.to_dict(), phase) for t, ev, phase, _ in want]


def test_event_validation_like_jax():
    for kw in (dict(at_s=0.0, kind="meteor"), dict(at_s=-1.0, kind="kill"),
               dict(at_s=0.0, kind="slow", duration_s=0.0),
               dict(at_s=0.0, kind="corrupt", arg=0)):
        with pytest.raises(ValueError):
            jax_chaos.FaultEvent(**kw)
        with pytest.raises(ValueError):
            chaos.FaultEvent(**kw)


REPORTS = [
    {"answers": {"lost": 0, "wrong": 0}, "slo": {"ok": True},
     "expects_corruption": False},
    {"answers": {"lost": 2, "wrong": 1}, "slo": {"ok": False,
     "good_frac": 0.4, "threshold_s": 0.15, "target": 0.9}},
    {"answers": {}, "expects_corruption": True,
     "canary": {"detected": []}},
    {"answers": {}, "expects_corruption": True,
     "canary": {"detected": [{"replica": 1}]},
     "cache": {"stale_hits": 3}},
    {"reloads": [{"ok": True}, {"ok": False, "error": "boom"}]},
]


@pytest.mark.parametrize("i", range(len(REPORTS)))
def test_grade_report_like_jax(i):
    assert chaos.grade_report(REPORTS[i]) == \
        jax_chaos.grade_report(REPORTS[i])


def test_integrity_predicate_and_defenses_like_jax():
    rng = np.random.default_rng(0)
    rows = [-rng.random(361), 1.0 - -rng.random(361), np.zeros(361),
            np.full(361, 2e-3), np.float32(-1.0)]
    for row in rows:
        assert chaos.log_prob_integrity(row) == \
            jax_chaos.log_prob_integrity(row)
    ours = dataclasses.asdict(chaos.defended_config())
    theirs = dataclasses.asdict(jax_chaos.defended_config())
    assert ours.pop("integrity_check") is chaos.log_prob_integrity
    assert theirs.pop("integrity_check") is jax_chaos.log_prob_integrity
    assert ours == theirs


def test_make_sentinels_like_jax():
    trace = make_trace(12, seed=4)
    items = [dict(it, digest=f"d{i % 5}") for i, it in enumerate(trace)]
    expected = {f"d{i}": np.full(3, float(i)) for i in range(5)}
    for limit in (2, 4, 9):
        got = chaos.make_sentinels(items, expected, limit=limit)
        want = jax_chaos.make_sentinels(items, expected, limit=limit)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# a whole campaign on numpy-stub fleets of both packages


def lp_forward(params, packed, player, rank):
    """Log-prob-shaped scripted forward: strictly negative, distinct per
    board — passes ``log_prob_integrity`` until the corrupt hook flips
    it positive."""
    return -(np.asarray(packed, np.float32).sum(axis=(1, 2, 3))
             + 1000.0 * np.asarray(player, np.float32) + 1.0)


def make_trace(n=30, rate=60.0, tier="interactive", seed=0):
    rng = np.random.default_rng(seed)
    items, t = [], 0.0
    for _ in range(n):
        t += 1.0 / rate
        items.append({
            "t": t,
            "packed": rng.integers(0, 3, size=(9, 19, 19), dtype=np.uint8),
            "player": int(rng.integers(1, 3)),
            "rank": int(rng.integers(1, 10)),
            "tier": tier,
        })
    return items


def stub_fleet(pkg, name):
    c, s, _, _ = PKGS[pkg]
    ecfg = s.EngineConfig(buckets=(1, 4), max_wait_ms=0.0)
    base = s.FleetConfig(respawn_base_s=0.001, respawn_cap_s=0.005)

    def make_replica(i):
        return s.SupervisedEngine(
            lambda: s.InferenceEngine(lp_forward, None, ecfg,
                                      name=f"{name}-{i}"),
            config=s.SupervisorConfig(max_restarts=0,
                                      backoff_base_s=0.001,
                                      backoff_cap_s=0.005),
            name=f"{name}-{i}")

    return s.FleetRouter(make_replica, 2, config=c.defended_config(base),
                         name=name, rng=random.Random(0))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_acceptance_campaign_grades_pass_with_lockcheck(pkg, tmp_path):
    c, _, f, lc = PKGS[pkg]
    lc.enable(True)
    lc.reset()
    fleet = stub_fleet(pkg, f"camp-{pkg}")
    try:
        trace = make_trace(60, rate=40.0, seed=11)
        span = trace[-1]["t"]
        out = str(tmp_path / "report.json")
        report = c.CampaignRunner(
            fleet, trace,
            c.acceptance_scenario(span, brownout_ms=60, corrupt_batches=400),
            c.CampaignConfig(slo_threshold_s=2.0, slo_target=0.5,
                             canary_interval_s=0.05)).run(report_path=out)
    finally:
        fleet.close()
        f.reset()
        cycles = lc.report()["cycles"]
        lc.enable(None)
        lc.reset()
    assert report["answers"]["lost"] == 0
    assert report["answers"]["wrong"] == 0
    assert report["answers"]["checked"] > 0
    assert report["canary"]["detected"], report["canary"]
    assert report["grade"] == {"pass": True, "reasons": []}
    assert {e["kind"] for e in report["executed"]} >= {"slow", "corrupt",
                                                       "kill"}
    assert cycles == []
    with open(out, encoding="utf-8") as fh:
        loaded = json.load(fh)
    assert c.grade_report(loaded) == jax_chaos.grade_report(loaded) == \
        loaded["grade"]
