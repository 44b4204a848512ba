"""Deterministic chaos campaigns for the serving fleet.

The port's copy of ``deepgo_tpu/chaos``, over the port's fleet,
``WorkloadReplayer``, ``obs/slo`` and ``utils/faults``: the same scenario
format, schedules and grade.

A chaos campaign replays a captured (or synthetic) workload trace
against a live fleet while a *scenario* — a declarative timeline of
faults — browns out, kills, and corrupts replicas mid-trace, then
grades the run against SLO burn objectives and integrity invariants:
no lost futures, no wrong answers returned to callers, the
latency-critical tier's budget holds. The defenses it validates
(request hedging, latency-outlier ejection, canary integrity probes)
live in serving/fleet.py; this package owns the attack and the grade.

  scenario.py  FaultEvent / Scenario (JSON round-trip) and the
               ScenarioScheduler thread that opens and closes fault
               windows on the timeline via utils/faults add/remove
  canary.py    CanaryProber — sentinel positions with known-good
               answers probed against every replica; a wrong answer
               ejects the replica through FleetRouter.eject_replica
  campaign.py  CampaignRunner — ground truth, trace replay, grading,
               and the JSON campaign report

A campaign run with the lock-order sanitizer armed
(``analysis.lockcheck.enable()`` before the fleet is built) doubles as a
race hunt.
"""

from .campaign import (CampaignConfig, CampaignRunner,
                       acceptance_scenario, brownout_scenario,
                       defended_config, grade_report, log_prob_integrity)
from .canary import CanaryProber, make_sentinels
from .scenario import EVENT_KINDS, FaultEvent, Scenario, ScenarioScheduler

__all__ = [
    "CampaignConfig",
    "CampaignRunner",
    "CanaryProber",
    "EVENT_KINDS",
    "FaultEvent",
    "Scenario",
    "ScenarioScheduler",
    "acceptance_scenario",
    "brownout_scenario",
    "defended_config",
    "grade_report",
    "log_prob_integrity",
    "make_sentinels",
]
