"""Offline run summarizer: one per-stage table out of a run's JSONL streams.

A finished (or killed) run directory holds up to three event streams —
``metrics.jsonl`` (train/validation/serving/obs events, possibly rotated),
``trace.jsonl`` (obs_span records), and ``elastic-NNNN.jsonl`` (per-host
recovery events) — that describe the same timeline from different angles.
This module joins them into the table the next perf PR argues from:
loader wait, dispatch latency, step time, span durations, recovery
counts, side by side with p50/p99 where a distribution exists.

Distributions come from two places and the report prefers the richer one:
the final ``obs_snapshot`` event (the registry's full histogram state at
close — exact counts, interpolated percentiles) and, for spans, the raw
per-occurrence records in ``trace.jsonl`` (exact percentiles, since every
occurrence is on disk).

The port's copy of ``deepgo_tpu/obs/report.py`` (``read_events`` lives in
the port's ``obs/exporter.py``); its summary and table equal the JAX
package's for the same run directory. Run as ``python -m
deepgo_tpu_torch.obs.report RUN_DIR [--json]``.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .attribution import attribute_run, format_attribution
from .exporter import read_events


def _pct(values: list[float], q: float) -> float | None:
    return float(np.percentile(values, q)) if values else None


def _hist_row(name: str, snap: dict, unit_scale: float = 1000.0) -> dict:
    """One table row from a registry histogram snapshot (seconds -> ms)."""
    return {
        "count": snap["count"],
        "p50_ms": round(snap["p50"] * unit_scale, 3),
        "p95_ms": round(snap["p95"] * unit_scale, 3),
        "p99_ms": round(snap["p99"] * unit_scale, 3),
        "mean_ms": round(snap["mean"] * unit_scale, 3),
    }


def summarize_run(run_dir: str) -> dict:
    """The joined per-stage summary for one run directory."""
    metrics = read_events(os.path.join(run_dir, "metrics.jsonl"))
    # loop runs stream their events (loop_* / fleet_* / lineage_*) to
    # loop.jsonl — same grammar, different file; fold them in so the
    # loop and fleet sections below see both deployment shapes
    metrics.extend(read_events(os.path.join(run_dir, "loop.jsonl")))
    trace_stream = read_events(os.path.join(run_dir, "trace.jsonl"))
    spans = [r for r in trace_stream if r.get("kind") == "obs_span"]
    requests = [r for r in trace_stream
                if r.get("kind") == "trace_request"]
    elastic: list[dict] = []
    for p in sorted(glob.glob(os.path.join(run_dir, "elastic-*.jsonl"))):
        elastic.extend(read_events(p))

    summary: dict = {"run_dir": run_dir, "stages": {}, "events": {}}

    # ---- training cadence (the train/validation/summary event grammar)
    train = [r for r in metrics if r.get("kind") == "train"]
    if train:
        sps = [r["samples_per_sec"] for r in train
               if r.get("samples_per_sec")]
        summary["stages"]["train"] = {
            "windows": len(train),
            "last_step": train[-1].get("step"),
            "last_ewma": train[-1].get("ewma"),
            "samples_per_sec_p50": round(_pct(sps, 50) or 0.0, 1),
            "samples_per_sec_min": round(min(sps), 1) if sps else None,
        }
    vals = [r for r in metrics if r.get("kind") == "validation"]
    if vals:
        summary["stages"]["validation"] = {
            "count": len(vals),
            "best_cost": round(min(r["cost"] for r in vals), 4),
            "last_accuracy": round(vals[-1]["accuracy"], 4),
        }

    # ---- registry snapshot (the hot-path histograms: loader wait,
    # dispatch latency, step windows) — the last one wins: it is the
    # close-time state and subsumes the others
    snaps = [r for r in metrics if r.get("kind") == "obs_snapshot"]
    hists: dict = {}
    if snaps:
        hists = snaps[-1].get("metrics", {})
        stage_of = {
            "deepgo_loader_wait_seconds": "loader_wait",
            "deepgo_train_window_seconds": "train_window",
            "deepgo_serving_dispatch_seconds": "serving_dispatch",
            "deepgo_serving_request_seconds": "serving_request",
            "deepgo_fleet_failover_seconds": "fleet_failover",
        }
        for metric_name, stage in stage_of.items():
            m = hists.get(metric_name)
            if not m or m.get("kind") != "histogram":
                continue
            for label, snap in m["series"].items():
                if not snap:
                    continue
                key = stage if not label else f"{stage}[{label}]"
                summary["stages"][key] = _hist_row(metric_name, snap)
        counters = {}
        for metric_name, m in hists.items():
            if m.get("kind") == "counter":
                for label, v in m["series"].items():
                    key = metric_name if not label \
                        else f"{metric_name}[{label}]"
                    counters[key] = v
        if counters:
            summary["events"]["counters"] = counters
        # the serving supervisor's resilience counters, surfaced as their
        # own section (restarts / shed / poisoned / replayed): the fleet
        # health row an operator reads first, not buried in the generic
        # counter dump
        sup = {}
        for short, metric_name in (("restarts",
                                    "deepgo_serving_restarts_total"),
                                   ("shed", "deepgo_serving_shed_total"),
                                   ("poisoned",
                                    "deepgo_serving_poisoned_total"),
                                   ("replayed",
                                    "deepgo_serving_replayed_total")):
            m = hists.get(metric_name)
            if m and m.get("kind") == "counter":
                sup[short] = sum(m["series"].values())
        if sup:
            summary["events"].setdefault("serving", {}).update(
                supervisor=sup)

    # ---- spans (exact per-occurrence durations from the trace stream)
    by_name: dict[str, list[float]] = {}
    errors: dict[str, int] = {}
    for r in spans:
        by_name.setdefault(r["name"], []).append(float(r["duration_s"]))
        if r.get("status") == "error":
            errors[r["name"]] = errors.get(r["name"], 0) + 1
    for name, durs in sorted(by_name.items()):
        row = {
            "count": len(durs),
            "p50_ms": round(_pct(durs, 50) * 1000, 3),
            "p95_ms": round(_pct(durs, 95) * 1000, 3),
            "p99_ms": round(_pct(durs, 99) * 1000, 3),
            "mean_ms": round(float(np.mean(durs)) * 1000, 3),
        }
        if errors.get(name):
            row["errors"] = errors[name]
        summary["stages"][f"span:{name}"] = row

    # ---- serving events (engine/supervisor JSONL grammar)
    restarts = [r for r in metrics if r.get("kind") == "serving_restart"]
    poisons = [r for r in metrics if r.get("kind") == "serving_poison"]
    if restarts or poisons:
        # merge, don't assign: the snapshot section above may already
        # have parked the supervisor counter block under this key
        summary["events"].setdefault("serving", {}).update(
            restarts=len(restarts), poisoned=len(poisons))

    def _counter_series(metric_name: str) -> dict:
        m = hists.get(metric_name)
        if m and m.get("kind") == "counter":
            return {lbl: v for lbl, v in m["series"].items()}
        return {}

    def _gauge_value(metric_name: str):
        m = hists.get(metric_name)
        if m and m.get("kind") == "gauge" and m["series"]:
            return list(m["series"].values())[-1]
        return None

    # ---- fleet (router counters, per-replica restart/failover/respawn
    # attribution — the deepgo_fleet_* / fleet_* grammar, previously
    # invisible in this report)
    fleet_sec: dict = {}
    for short, metric_name in (("failovers", "deepgo_fleet_failovers_total"),
                               ("respawns", "deepgo_fleet_respawns_total"),
                               ("reloads", "deepgo_fleet_reloads_total")):
        series = _counter_series(metric_name)
        if series:
            fleet_sec[short] = int(sum(series.values()))
    shed = _counter_series("deepgo_fleet_shed_total")
    if shed:
        fleet_sec["shed"] = {lbl: int(v) for lbl, v in sorted(shed.items())}
    if fleet_sec:
        # per-replica restarts: the supervisor counter's engine label IS
        # the replica name when the engines sit behind a fleet router
        per_engine = _counter_series("deepgo_serving_restarts_total")
        if per_engine:
            fleet_sec["replica_restarts"] = {
                lbl or "(unlabeled)": int(v)
                for lbl, v in sorted(per_engine.items())}
    fleet_events = [r for r in metrics
                    if str(r.get("kind", "")).startswith("fleet_")]
    if fleet_events:
        by_replica: dict = {}
        for r in fleet_events:
            if r["kind"] == "fleet_respawn" and "replica" in r:
                key = str(r["replica"])
                by_replica[key] = by_replica.get(key, 0) + 1
        fleet_sec.setdefault(
            "respawns", sum(1 for r in fleet_events
                            if r["kind"] == "fleet_respawn"))
        if by_replica:
            fleet_sec["respawns_by_replica"] = by_replica
        failed = [r for r in fleet_events
                  if r["kind"] == "fleet_replica_failed"]
        if failed:
            fleet_sec["replicas_failed"] = [r.get("replica") for r in failed]
        reload_events = [r for r in fleet_events
                         if r["kind"] == "fleet_reload"]
        if reload_events:
            fleet_sec.setdefault("reloads", len(reload_events))
    if fleet_sec:
        summary["events"]["fleet"] = fleet_sec

    # ---- loop (the deepgo_loop_* / loop_* expert-iteration grammar)
    loop_sec: dict = {}
    for short, metric_name in (
            ("games_ingested", "deepgo_loop_games_ingested_total"),
            ("positions_ingested", "deepgo_loop_positions_ingested_total"),
            ("windows_trained", "deepgo_loop_windows_trained_total"),
            ("gates_passed", "deepgo_loop_gates_passed_total"),
            ("gates_rejected", "deepgo_loop_gates_rejected_total"),
            ("stalls", "deepgo_loop_stalls_total")):
        series = _counter_series(metric_name)
        if series:
            loop_sec[short] = int(sum(series.values()))
    comp_restarts = _counter_series("deepgo_loop_component_restarts_total")
    if comp_restarts:
        loop_sec["component_restarts"] = {
            lbl or "(unlabeled)": int(v)
            for lbl, v in sorted(comp_restarts.items())}
    step = _gauge_value("deepgo_loop_learner_step")
    if step is not None:
        loop_sec["learner_step"] = int(step)
    loop_events = [r for r in metrics
                   if str(r.get("kind", "")).startswith("loop_")]
    if loop_events:
        loop_sec.setdefault(
            "windows_trained",
            sum(1 for r in loop_events if r["kind"] == "loop_window"))
        loop_sec.setdefault(
            "games_ingested",
            sum(1 for r in loop_events if r["kind"] == "loop_ingest"))
        gates = [r for r in loop_events if r["kind"] == "loop_gate"]
        if gates:
            loop_sec.setdefault(
                "gates_passed",
                sum(1 for r in gates if r.get("outcome") == "passed"))
            loop_sec.setdefault(
                "gates_rejected",
                sum(1 for r in gates if r.get("outcome") == "rejected")
                + sum(1 for r in loop_events
                      if r["kind"] == "loop_gate_rejected"))
        crashes: dict = {}
        for r in loop_events:
            if r["kind"] == "loop_restart":
                key = str(r.get("component", "?"))
                crashes[key] = crashes.get(key, 0) + 1
        if crashes:
            loop_sec.setdefault("component_restarts", crashes)
        closes = [r for r in loop_events if r["kind"] == "loop_close"]
        if closes:
            last = closes[-1]
            for k in ("games_acked", "games_durable", "champion_step"):
                if last.get(k) is not None:
                    loop_sec[k] = last[k]
    if loop_sec:
        summary["events"]["loop"] = loop_sec

    # ---- slowest-request exemplars (trace_request records sampled by
    # obs/tracing.py: the tail anatomy next to the aggregate table)
    if requests:
        top = sorted(requests,
                     key=lambda r: -float(r.get("duration_s", 0.0)))[:10]
        summary["exemplars"] = [{
            "trace_id": r.get("trace_id"),
            "duration_ms": round(float(r.get("duration_s", 0.0)) * 1000, 3),
            "status": r.get("status"),
            "tier": r.get("tier"),
            "replica": r.get("replica"),
            "bucket": r.get("bucket"),
            "hops": len(r.get("hops") or []),
            "events": len(r.get("events") or []),
        } for r in top]

    # ---- elastic recovery (per-host streams)
    recoveries = [r for r in elastic if r.get("kind") == "recovery"]
    losses = [r for r in elastic if r.get("kind") == "host_lost"]
    stragglers = [r for r in elastic if r.get("kind") == "straggler"]
    if elastic:
        row: dict = {
            "hosts_seen": len({r.get("host") for r in elastic
                               if "host" in r}),
            "host_losses": len(losses),
            "recoveries": len(recoveries),
            "stragglers_flagged": len(stragglers),
        }
        if recoveries:
            lat = [r["recovery_latency_s"] for r in recoveries]
            row.update(
                steps_lost_total=sum(r.get("steps_lost", 0)
                                     for r in recoveries),
                recovery_latency_s_p50=round(_pct(lat, 50), 3),
                recovery_latency_s_max=round(max(lat), 3),
            )
        summary["events"]["elastic"] = row

    # ---- profiler trace discoverability (utils.profiling.trace logs it)
    traces = [r for r in metrics if r.get("kind") == "profile_trace"]
    if traces:
        summary["events"]["profiler_traces"] = [
            r.get("out_dir") for r in traces]

    # ---- SLO burns (the tracker's transition events, when streamed)
    burns = [r for r in metrics if r.get("kind") == "slo_burn"]
    if burns:
        summary["events"]["slo_burns"] = [
            {k: r.get(k) for k in ("slo", "from_state", "to_state",
                                   "burn_fast", "burn_slow")}
            for r in burns]

    # ---- telemetry time-series (the ts-NNNN.jsonl chunk store written
    # by obs/timeseries.py): the historical view next to the point-in-
    # time snapshot — per-watchlist series last/min/max over the whole
    # retained window, so "when did it degrade" is answerable offline
    from .dash import find_store_dir
    from .timeseries import (key_field, list_keys, load_samples,
                             series_from_samples)

    ts_samples = load_samples(find_store_dir(run_dir))
    if ts_samples:
        from .anomaly import DEFAULT_WATCHLIST

        watch: dict = {}
        for spec in DEFAULT_WATCHLIST:
            per_key = series_from_samples(ts_samples, spec.metric)
            for key, points in sorted(per_key.items()):
                if key_field(key) != spec.field:
                    continue
                values = [v for _, v in points]
                watch[key] = {
                    "points": len(points),
                    "last": round(values[-1], 6),
                    "min": round(min(values), 6),
                    "max": round(max(values), 6),
                }
        summary["timeseries"] = {
            "samples": len(ts_samples),
            "series": len(list_keys(ts_samples)),
            "span_s": round(ts_samples[-1]["t"] - ts_samples[0]["t"], 3),
            "pinned": sum(1 for r in ts_samples if r.get("pin")),
            "watch": watch,
        }

    # ---- anomalies (the streaming detector's typed events,
    # obs/anomaly.py) — what fired, when, and how hard, plus the scrape
    # failures the federation layer absorbed
    anomalies = [r for r in metrics if r.get("kind") == "anomaly"]
    anomalies.extend(r for r in trace_stream
                     if r.get("kind") == "anomaly")
    if anomalies:
        by_kind: dict = {}
        for r in anomalies:
            k = str(r.get("detector", "?"))
            by_kind[k] = by_kind.get(k, 0) + 1
        summary["anomalies"] = {
            "count": len(anomalies),
            "by_kind": by_kind,
            "events": [{k: r.get(k) for k in ("metric", "series",
                                              "detector", "value",
                                              "baseline", "score", "t")}
                       for r in anomalies[-20:]],
        }
    scrape_failures = [r for r in metrics
                       if r.get("kind") == "ts_scrape_failed"]
    if scrape_failures:
        summary["events"]["scrape_failures"] = {
            str(r.get("host", "?")): sum(
                1 for s in scrape_failures if s.get("host") == r.get("host"))
            for r in scrape_failures}

    # ---- workload observatory (the obs/workload.py capture streams —
    # a run's workload/ subdirectory or a capture dir itself):
    # what the run was ASKED to serve, characterized — the projected
    # cache hit rate next to the dispatch latencies it would remove
    wl_dir = None
    for cand in (os.path.join(run_dir, "workload"), run_dir):
        if os.path.exists(os.path.join(cand, "workload.jsonl")):
            wl_dir = cand
            break
    if wl_dir is not None:
        from .workload import analyze_capture

        summary["workload"] = analyze_capture(wl_dir)

    # ---- the device cost ledger (cost_ledger events streamed by
    # obs/costmodel.py at train start): the per-entrypoint
    # FLOPs / bytes / HBM bill the attribution roofline divides by
    cost_events = [r for r in metrics if r.get("kind") == "cost_ledger"]
    if cost_events:
        summary["cost_ledger"] = {
            "version": cost_events[-1].get("version"),
            "platform": cost_events[-1].get("platform"),
            "device_kind": cost_events[-1].get("device_kind"),
            "entries": [{k: v for k, v in r.items()
                         if k not in ("kind", "time", "version",
                                      "platform", "device_kind")}
                        for r in cost_events],
        }

    # ---- step-time attribution (obs/attribution.py): the per-host
    # wall-clock decomposition, joined across elastic hosts when present
    att = attribute_run(run_dir)
    if att is not None:
        summary["attribution"] = att

    return summary


def format_report(summary: dict) -> str:
    """The human rendering: one fixed-width per-stage table plus an
    events block — terminal-greppable, no dependencies."""
    lines = [f"run: {summary['run_dir']}"]
    stages = summary.get("stages", {})
    if stages:
        cols = ["stage", "count", "p50_ms", "p95_ms", "p99_ms", "notes"]
        rows = []
        for name, row in stages.items():
            notes = ", ".join(
                f"{k}={v}" for k, v in row.items()
                if k not in ("count", "p50_ms", "p95_ms", "p99_ms",
                             "mean_ms") and v is not None)
            rows.append([
                name,
                str(row.get("count", row.get("windows", ""))),
                str(row.get("p50_ms", "")),
                str(row.get("p95_ms", "")),
                str(row.get("p99_ms", "")),
                notes,
            ])
        widths = [max(len(c), *(len(r[i]) for r in rows))
                  for i, c in enumerate(cols)]
        lines.append("  ".join(c.ljust(w) for c, w in zip(cols, widths)))
        lines.append("  ".join("-" * w for w in widths))
        for r in rows:
            lines.append("  ".join(v.ljust(w) for v, w in zip(r, widths)))
    else:
        lines.append("(no stage data: no metrics.jsonl / trace.jsonl "
                     "events found)")
    events = summary.get("events", {})
    for section, payload in events.items():
        lines.append("")
        lines.append(f"{section}:")
        if isinstance(payload, dict):
            for k, v in payload.items():
                lines.append(f"  {k}: {v}")
        else:
            for item in payload:
                lines.append(f"  {item}")
    exemplars = summary.get("exemplars")
    if exemplars:
        lines.append("")
        lines.append("slowest requests (sampled exemplars — "
                     "`cli trace RUN_DIR <id>` for the waterfall):")
        cols = ["trace_id", "ms", "status", "tier", "replica", "bucket",
                "hops"]
        rows = [[str(e.get("trace_id", "")),
                 str(e.get("duration_ms", "")),
                 str(e.get("status", "")),
                 str(e.get("tier") or ""),
                 str(e.get("replica") if e.get("replica") is not None
                     else ""),
                 str(e.get("bucket") if e.get("bucket") is not None
                     else ""),
                 str(e.get("hops", 0))] for e in exemplars]
        widths = [max(len(c), *(len(r[i]) for r in rows))
                  for i, c in enumerate(cols)]
        lines.append("  " + "  ".join(c.ljust(w)
                                      for c, w in zip(cols, widths)))
        for r in rows:
            lines.append("  " + "  ".join(v.ljust(w)
                                          for v, w in zip(r, widths)))
    ts = summary.get("timeseries")
    if ts:
        lines.append("")
        lines.append(f"telemetry time-series ({ts['samples']} samples, "
                     f"{ts['series']} series over {ts['span_s']}s, "
                     f"{ts['pinned']} pinned — `cli dash` for sparklines):")
        watch = ts.get("watch", {})
        if watch:
            cols = ["series", "points", "last", "min", "max"]
            rows = [[key[:72], str(row["points"]), f"{row['last']:g}",
                     f"{row['min']:g}", f"{row['max']:g}"]
                    for key, row in watch.items()]
            widths = [max(len(c), *(len(r[i]) for r in rows))
                      for i, c in enumerate(cols)]
            lines.append("  " + "  ".join(c.ljust(w)
                                          for c, w in zip(cols, widths)))
            for r in rows:
                lines.append("  " + "  ".join(v.ljust(w)
                                              for v, w in zip(r, widths)))
    anom = summary.get("anomalies")
    if anom:
        lines.append("")
        lines.append(f"anomalies ({anom['count']} total, "
                     + ", ".join(f"{k}={v}"
                                 for k, v in sorted(anom["by_kind"]
                                                    .items()))
                     + "):")
        for e in anom["events"]:
            lines.append(
                f"  {e.get('detector', '?'):5s}  "
                f"{e.get('series') or e.get('metric')}  "
                f"value {e.get('value')} vs baseline {e.get('baseline')} "
                f"(score {e.get('score')})")
    wl = summary.get("workload")
    if wl:
        from .workload import format_workload

        lines.append("")
        lines.append("workload (obs/workload.py capture — "
                     "`cli workload analyze` for the full report):")
        for row in format_workload(wl).splitlines():
            lines.append(f"  {row}")
    cost = summary.get("cost_ledger")
    if cost:
        lines.append("")
        lines.append(f"device cost ledger (v{cost.get('version')}, "
                     f"{cost.get('platform')}):")
        cols = ["entrypoint", "GFLOPs", "MB moved", "AI", "HBM MB", "src"]
        rows = []
        for e in cost["entries"]:
            fn, bucket = e.get("fn", "?"), e.get("bucket")
            ai = e.get("arithmetic_intensity")
            rows.append([
                fn if bucket is None else f"{fn}/b{bucket}",
                f"{(e.get('flops') or 0) / 1e9:,.1f}",
                f"{(e.get('bytes_accessed') or 0) / 2**20:,.1f}"
                if e.get("bytes_accessed") else "-",
                f"{ai:.1f}" if ai else "-",
                f"{(e.get('hbm_peak_bytes') or 0) / 2**20:,.1f}"
                if e.get("hbm_peak_bytes") is not None else "-",
                str(e.get("source", "")),
            ])
        widths = [max(len(c), *(len(r[i]) for r in rows))
                  for i, c in enumerate(cols)]
        lines.append("  " + "  ".join(c.ljust(w)
                                      for c, w in zip(cols, widths)))
        for r in rows:
            lines.append("  " + "  ".join(v.ljust(w)
                                          for v, w in zip(r, widths)))
    att = summary.get("attribution")
    if att:
        lines.append("")
        lines.append(format_attribution(att))
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="deepgo_tpu_torch.obs.report",
        description="join a run's metrics/trace/elastic JSONL streams "
                    "into one per-stage table")
    ap.add_argument("run_dir")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of the table")
    args = ap.parse_args(argv)
    summary = summarize_run(args.run_dir)
    if args.json:
        print(json.dumps(summary, indent=1, default=str))
    else:
        print(format_report(summary))


if __name__ == "__main__":
    main()
