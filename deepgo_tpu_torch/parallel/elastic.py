"""Elastic multi-host training: checkpoint-coordinated re-mesh recovery.

The port of ``deepgo_tpu/parallel/elastic.py``. When a participating host
dies, every survivor independently

  1. **detects** the loss — its heartbeat silence exceeds the miss budget
     (``liveness.HeartbeatLedger``), raised as a typed ``HostLost`` out of
     the training loop's window hook;
  2. **converges** on the newest valid checkpoint in the shared run
     directory (``checkpoint.find_latest_valid``, which skips corrupt
     candidates), discarding its own in-memory state: the checkpoint is the
     only state the survivors provably share;
  3. **re-meshes** over the surviving process set (``remesh``) and
     re-balances the global batch (``per_host_batch`` with the surviving
     count). With ``ElasticConfig.reshard`` the re-mesh may shrink the
     tensor-parallel factor (``shrink_tp``), and the converge step restores
     through the resharding layer (``parallel/reshard.py``), whose
     placement check reports any leaf that landed off its declared shard;
  4. **resumes** — and because the synchronous data stream is
     step-indexed (``loader.step_rng``), the continuation is bit-exact
     against an uninterrupted run over the same step indices.

Steps are lost (rollback to the checkpoint), never corrupted. Recovery
latency and steps lost are measured and reported (``ELASTIC_RECOVERY`` /
``ELASTIC_DONE`` JSON lines on stdout; ``elastic-<host>.jsonl`` records in
the run directory).

Each simulated host is a process with a local world of its own (no
process group, or a group of its own ranks), coordinated with its peers
only through the shared run directory (heartbeats and checkpoints): a live
``torch.distributed`` group cannot shrink in-process. On a real cluster the
same loop applies per host, with the relaunch re-entering through the
deadline-wrapped bootstrap (``deadlines.initialize_with_deadline``).

``ElasticConfig.obs_port`` serves live ``/metrics`` + ``/healthz`` for the
host: the health verdict composes the heartbeat ledger, so a peer's
silence flips ``/healthz`` to 503 within this host's miss budget, and it
stays 503 until the recovery has resumed from the converged checkpoint.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass

from ..obs import (configure_flight, flight_dump, get_registry,
                   health_from_ledger, start_exporter)
from ..utils.metrics import MetricsWriter
from .deadlines import guard_first_call, initialize_with_deadline
from .distributed import hybrid_mesh, per_host_batch, world_size
from .liveness import (ConfigError, HeartbeatLedger, HeartbeatWriter,
                       HostLost)


@dataclass(frozen=True)
class ElasticConfig:
    """Infrastructure knobs for one elastic host (CLI: ``train --elastic``).

    These are per-launch facts — which host am I, who else should exist,
    how patient is liveness — so they live here, not in ExperimentConfig
    (which rides inside checkpoints and must describe the *model run*)."""

    process_id: int = 0
    expected_hosts: int = 1
    heartbeat_interval_s: float = 1.0
    miss_budget: int = 3
    straggler_factor: float = 3.0
    min_straggler_beats: int = 3
    init_deadline_s: float = 120.0
    step_deadline_s: float = 0.0   # 0 = no watchdog around the first step
    max_recoveries: int = 8
    # allow recovery to shrink the tensor-parallel factor with the
    # surviving fraction (shrink_tp) and reshard the checkpoint state
    # into the new layout; off = re-mesh keeps the stored tp (a loss
    # that strands too few devices for it then surfaces as ConfigError)
    reshard: bool = False
    coordinator: str | None = None
    num_processes: int | None = None
    heartbeat_dir: str = ""        # default: <run_dir>/heartbeats
    # live observability endpoint: /metrics + /healthz on this port (0 =
    # ephemeral, None = no exporter). The health verdict composes the
    # heartbeat ledger, so a peer kill flips /healthz to 503 within this
    # host's own miss budget.
    obs_port: int | None = None


def remesh(n_model: int, survivors: set[int]):
    """The mesh after a host loss.

    Real multi-process group: the hybrid mesh restricted to surviving
    process indices (hosts-major ordering preserved; a layout, since a
    live group cannot drop ranks). Simulated hosts (one process each): the
    local world IS the surviving world, so the full local hybrid mesh.
    Raises ConfigError when the surviving set owns no devices or the
    local world does not divide over ``n_model``."""
    if world_size() > 1:
        alive = sorted(p for p in survivors if p < world_size())
        return hybrid_mesh(n_model, processes=alive)
    return hybrid_mesh(n_model)


def shrink_tp(n_model: int, alive: int, expected: int) -> int:
    """Target tensor-parallel factor after shrinking to ``alive`` of
    ``expected`` hosts: scale "model" down with the surviving fraction,
    rounded down to the nearest divisor of the original factor (a
    non-divisor would split the already-partitioned channel dims
    unevenly). Never below 1 — a single survivor still trains, fully
    replicated."""
    if n_model <= 1 or alive >= expected:
        return max(1, n_model)
    target = max(1, (n_model * alive) // max(1, expected))
    while n_model % target:
        target -= 1
    return target


def run_elastic(run_dir: str, total_iters: int, *, overrides: dict | None = None,
                ecfg: ElasticConfig = ElasticConfig(), clock=time.time,
                log=None, device="cuda") -> dict:
    """Train to ``total_iters`` total steps, surviving peer-host death.

    Each participating host runs this over the same ``run_dir`` (shared
    filesystem). Semantics match ``cli train --auto-resume``: ``total_iters``
    is the TOTAL step target, so re-running the identical command after any
    number of kills — of this host or its peers — converges on the same
    final state. Returns the summary dict also printed as the
    ``ELASTIC_DONE`` JSON line. ``device`` is where this host trains."""
    from ..experiments import Experiment

    if log is None:
        def log(msg):
            print(msg, file=sys.stderr, flush=True)

    if ecfg.expected_hosts < 1:
        raise ConfigError(
            f"expected_hosts must be >= 1, got {ecfg.expected_hosts}")
    if not (0 <= ecfg.process_id < ecfg.expected_hosts):
        raise ConfigError(
            f"process_id {ecfg.process_id} outside expected_hosts "
            f"{ecfg.expected_hosts}")

    # bootstrap: deadline-wrapped, retried, typed (a no-op single-process,
    # but the dist_init fault site and the watchdog cover it either way)
    initialize_with_deadline(ecfg.coordinator, ecfg.num_processes,
                             ecfg.process_id, timeout_s=ecfg.init_deadline_s,
                             device=device)

    hb_dir = ecfg.heartbeat_dir or os.path.join(run_dir, "heartbeats")
    writer = HeartbeatWriter(hb_dir, ecfg.process_id, clock=clock)
    ledger = HeartbeatLedger(hb_dir, interval_s=ecfg.heartbeat_interval_s,
                             miss_budget=ecfg.miss_budget, clock=clock,
                             log=log)
    survivors = set(range(ecfg.expected_hosts))
    metrics = MetricsWriter(os.path.join(
        run_dir, f"elastic-{ecfg.process_id:04d}.jsonl"))
    metrics.write("elastic_start", host=ecfg.process_id,
                  expected_hosts=ecfg.expected_hosts,
                  budget_s=ledger.budget_s)
    # arm the crash flight recorder over the shared run dir BEFORE the
    # training loop configures its own default: a HostLost dump then
    # lands next to the heartbeats every survivor can read
    configure_flight(run_dir)
    reg = get_registry()
    obs_recoveries = reg.counter(
        "deepgo_elastic_recoveries_total",
        "host losses recovered via checkpoint convergence + re-mesh")
    obs_steps_lost = reg.counter(
        "deepgo_elastic_steps_lost_total",
        "steps rolled back to the converged checkpoint across recoveries")
    obs_alive = reg.gauge(
        "deepgo_elastic_hosts_alive", "surviving host count")
    obs_alive.set(len(survivors))
    exporter = None
    # /healthz state shared with the recovery loop: the ledger check alone
    # would flip back to healthy the instant the loop drops the lost host
    # from ``survivors``; the latch keeps it 503 from detection until the
    # recovery record is finalized (resumed from the converged checkpoint)
    recovering = {"active": False, "lost": None}
    if ecfg.obs_port is not None:
        exporter = start_exporter(ecfg.obs_port)
        ledger_check = health_from_ledger(
            ledger, lambda: survivors - {ecfg.process_id})

        def fleet_health() -> dict:
            out = ledger_check()
            if recovering["active"]:
                out["healthy"] = False
                out["recovering"] = True
                out["lost_process_id"] = recovering["lost"]
            return out

        exporter.add_health("heartbeats", fleet_health)
    recoveries: list[dict] = []
    pending_loss: dict | None = None
    # parallelism-layout override for the converge step, set by the
    # HostLost handler when ecfg.reshard shrinks tp; sticky across
    # further losses (later checkpoints carry the new layout anyway)
    remesh_overrides: dict | None = None
    exp = None
    # fresh starts must record that this run is elastic (the flag rides in
    # the checkpoint config and threads the dist_collective fault site
    # through the steps); resumes take the stored config as always
    overrides = dict(overrides or {})
    overrides["elastic"] = True
    try:
        while True:
            exp = Experiment.auto_resume(
                run_dir, overrides=dict(overrides), log=log, device=device,
                remesh=remesh_overrides if pending_loss is not None else None)
            if pending_loss is not None:
                metrics.write("reshard_restore", host=ecfg.process_id,
                              tp=exp.config.tensor_parallel,
                              findings=len(exp.last_restore_findings))
                # finalize the recovery record now that we know where the
                # fleet converged (the checkpoint step survives; everything
                # the dead host's peers computed past it is rolled back)
                now = clock()
                rec = dict(pending_loss)
                rec.update(
                    resumed_step=exp.step,
                    steps_lost=max(0, rec["step_at_detection"] - exp.step),
                    recovery_latency_s=now - rec["last_seen"],
                    detect_latency_s=rec["detected_at"] - rec["last_seen"],
                    survivors=sorted(survivors),
                    tp=exp.config.tensor_parallel,
                    sharding_findings=len(exp.last_restore_findings),
                )
                del rec["detected_at"]
                recoveries.append(rec)
                obs_recoveries.inc()
                obs_steps_lost.inc(rec["steps_lost"])
                obs_alive.set(len(survivors))
                metrics.write("recovery", **rec)
                print("ELASTIC_RECOVERY " + json.dumps(rec), flush=True)
                pending_loss = None
                recovering["active"] = False
            remaining = total_iters - exp.step
            if remaining <= 0:
                log(f"elastic host {ecfg.process_id}: step {exp.step} already "
                    f"meets --iters {total_iters}; nothing to do")
                summary = {"final_step": exp.step, "final_ewma": exp.ewma}
                break
            if not exp.initialized:
                exp.init()
            if ecfg.step_deadline_s > 0:
                # the first step (its first collective) is where a broken
                # fleet wedges; arm the external watchdog
                # around exactly that call
                exp.train_step = guard_first_call(
                    exp.train_step, f"first-step(host {ecfg.process_id})",
                    ecfg.step_deadline_s)
                exp.train_step_many = guard_first_call(
                    exp.train_step_many,
                    f"first-step-many(host {ecfg.process_id})",
                    ecfg.step_deadline_s)

            peers = survivors - {ecfg.process_id}

            def on_window(step: int, window_dt: float, window_steps: int) -> None:
                writer.beat(step, step_latency_s=window_dt / max(1, window_steps))
                if not peers:
                    return
                ledger.poll()
                ledger.check_liveness(peers)  # raises HostLost
                for s in ledger.straggler_report(ecfg.straggler_factor,
                                                 ecfg.min_straggler_beats):
                    log(f"elastic host {ecfg.process_id}: {s}")
                    metrics.write("straggler", host=s.process_id,
                                  latency_s=s.latency_s,
                                  fleet_median_s=s.fleet_median_s)

            exp.on_window = on_window
            writer.beat(exp.step)  # registration / resume announcement
            try:
                run_summary = exp.run(remaining)
                path = exp.save()
                summary = {"final_step": exp.step,
                           "final_ewma": run_summary["final_ewma"],
                           "samples_per_sec": run_summary["samples_per_sec"],
                           "checkpoint": path}
                break
            except HostLost as e:
                detected_at = clock()
                # black box first: the ring holds the windows that led up
                # to the loss (spans, heartbeat latencies, loader waits)
                flight_dump("host_lost", host=ecfg.process_id,
                            lost_process_id=e.process_id,
                            silent_for_s=round(e.silent_for_s, 3),
                            step_at_detection=exp.step)
                if len(recoveries) >= ecfg.max_recoveries:
                    log(f"elastic host {ecfg.process_id}: recovery budget "
                        f"({ecfg.max_recoveries}) exhausted; surfacing {e}")
                    raise
                survivors.discard(e.process_id)
                recovering["active"] = True
                recovering["lost"] = e.process_id
                if not survivors:
                    raise  # cannot happen for a live host; defensive
                log(f"elastic host {ecfg.process_id}: {e}; converging on the "
                    f"latest valid checkpoint and re-meshing over "
                    f"{sorted(survivors)}")
                tp_from = exp.config.tensor_parallel
                new_tp = tp_from
                if ecfg.reshard:
                    new_tp = shrink_tp(tp_from, len(survivors),
                                       ecfg.expected_hosts)
                    if new_tp != tp_from:
                        remesh_overrides = {"tensor_parallel": new_tp}
                        log(f"elastic host {ecfg.process_id}: resharding "
                            f"tp {tp_from} -> {new_tp} over the survivors")
                        metrics.write("elastic_remesh", host=ecfg.process_id,
                                      tp_from=tp_from, tp_to=new_tp,
                                      survivors=sorted(survivors))
                mesh = remesh(new_tp, survivors)
                try:
                    # re-derived after EVERY re-mesh: the data width the
                    # global batch must divide over is a property of the
                    # new mesh, not the original launch
                    local_batch = per_host_batch(exp.config.batch_size,
                                                 process_count=len(survivors))
                    log(f"elastic host {ecfg.process_id}: re-mesh "
                        f"{dict(mesh.shape)}; per-host batch -> {local_batch}")
                except ConfigError as ce:
                    # a non-dividing batch over the shrunken fleet is a real
                    # re-balance constraint; surviving with padding is the
                    # loader's problem, not a reason to abandon recovery
                    local_batch = None
                    log(f"elastic host {ecfg.process_id}: {ce}")
                pending_loss = {
                    "event": "host_lost",
                    "process_id": e.process_id,
                    "last_seen": e.last_seen,
                    "silent_for_s": e.silent_for_s,
                    "budget_s": e.budget_s,
                    "last_step": e.last_step,
                    "step_at_detection": exp.step,
                    "detected_at": detected_at,
                    "per_host_batch": local_batch,
                    "tp_from": tp_from,
                    "tp_to": new_tp,
                }
                metrics.write("host_lost", **{k: v for k, v in
                                              pending_loss.items()
                                              if k != "event"})
                continue

        summary.update(
            host=ecfg.process_id,
            survivors=sorted(survivors),
            recoveries=len(recoveries),
            steps_lost_total=sum(r["steps_lost"] for r in recoveries),
            recovery_latency_s=[round(r["recovery_latency_s"], 3)
                                for r in recoveries],
            heartbeats=writer.beats,
        )
        metrics.write("elastic_done", **{k: v for k, v in summary.items()
                                         if k != "checkpoint"})
        print("ELASTIC_DONE " + json.dumps(summary), flush=True)
        return summary
    finally:
        if exporter is not None:
            exporter.close()
        # per-host close-time registry snapshot: the cross-host join in
        # obs/attribution.py keys on these (the shared metrics.jsonl's
        # snapshots interleave between hosts; this stream is ours alone)
        try:
            if not metrics.closed:
                metrics.write("obs_snapshot", host=ecfg.process_id,
                              metrics=get_registry().snapshot()["metrics"])
        except (OSError, ValueError):
            pass
        metrics.close()
