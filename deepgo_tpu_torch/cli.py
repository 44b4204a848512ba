"""Command-line entry points of the port.

The port's counterpart of ``deepgo_tpu/cli.py``: the same subcommands,
flags, defaults and choices, plus ``--device`` on every subcommand that
builds a net or a step. Those run on ``cuda`` (and raise without CUDA)
unless ``--device cpu`` is given; nothing falls back to the CPU.
Random-init nets come from ``torch.Generator`` seed 0, so their weights
differ from the JAX package's ``jax.random.key(0)``; a checkpoint written
by either package gives the same net in both.

  python -m deepgo_tpu_torch.cli train       train (or resume) an experiment
  python -m deepgo_tpu_torch.cli eval        evaluate a checkpoint on a split
  python -m deepgo_tpu_torch.cli localtest   20-iteration smoke run on a
                                       processed split (reference localtest.lua)
  python -m deepgo_tpu_torch.cli selfplay    engine-driven batched self-play
                                       (forwards to deepgo_tpu_torch.selfplay;
                                       inference rides the serving engine)
  python -m deepgo_tpu_torch.cli serve       serving-fleet daemon: N supervised
                                       replicas behind the failover router,
                                       live /healthz, verified checkpoint
                                       hot-reload
  python -m deepgo_tpu_torch.cli loop        always-on expert-iteration service:
                                       selfplay actors -> replay buffer ->
                                       continuous learner -> arena
                                       gatekeeper, champion hot-swapped
                                       through the fleet (docs/loop.md)
  python -m deepgo_tpu_torch.cli obs         offline observability report: join a
                                       run's metrics/trace/elastic JSONL
                                       streams into one per-stage table
  python -m deepgo_tpu_torch.cli dash        live operator dashboard: watchlist
                                       sparklines, fleet health grid,
                                       active anomalies, SLO burn state —
                                       over a run directory's time-series
                                       store or N scraped /metrics
                                       endpoints federated into one view
  python -m deepgo_tpu_torch.cli trend       bench trajectory: every committed
                                       BENCH_r*.json round joined with
                                       BENCH_LAST_GOOD.json into one
                                       per-metric history table
  python -m deepgo_tpu_torch.cli trace       reconstruct one request's waterfall
                                       (from sampled trace_request
                                       exemplars) or a champion's lineage
                                       chain (games -> segments -> window
                                       -> gate -> champion) from a run
                                       directory's JSONL streams
  python -m deepgo_tpu_torch.cli cost        device cost ledger: run every
                                       entrypoint of one model config once
                                       under the FLOP counter on --device
                                       and print its FLOPs / HBM bill
                                       against the card's peak
                                       (docs/observability.md)
  python -m deepgo_tpu_torch.cli lint        invariant linter over the port:
                                       machine-check the atomic-write/
                                       determinism/thread/typed-error/
                                       hot-sync disciplines and the
                                       code<->docs grammar
                                       (docs/static_analysis.md)

Config overrides are ``--set key=value`` pairs against ExperimentConfig
(the reference's prototype-override tables, experiments.lua:19-31, and its
torch.CmdLine flags, experiments/repeated.lua:6-10).
"""

from __future__ import annotations

import argparse
import dataclasses

from .experiments import Experiment, ExperimentConfig

DEVICE_HELP = "cuda (default; raises without CUDA) or cpu"


def parse_overrides(pairs: list[str]) -> dict:
    """``key=value`` strings -> typed config overrides.

    Dispatches on the runtime type of each field's default value (bool
    before int: bool subclasses int), not on the stringified annotation —
    so config evolution (new field types) fails loudly here instead of
    silently coercing to str."""
    defaults = ExperimentConfig()
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    out = {}
    for pair in pairs:
        key, _, raw = pair.partition("=")
        if key not in fields:
            raise SystemExit(f"unknown config field {key!r}; valid: {sorted(fields)}")
        default = getattr(defaults, key)
        if isinstance(default, bool):
            out[key] = raw.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            out[key] = int(raw)
        elif isinstance(default, float):
            out[key] = float(raw)
        elif isinstance(default, str):
            out[key] = raw
        else:
            raise SystemExit(
                f"field {key!r} has non-scalar type "
                f"{type(default).__name__}; set it in code, not via --set")
    return out


def _policy(args):
    """(model, cfg) on ``args.device``: ``--checkpoint`` when given, else a
    random init of ``--model`` from ``torch.Generator`` seed 0."""
    if getattr(args, "checkpoint", None):
        from .models.serving import load_policy

        _, model, cfg = load_policy(args.checkpoint, device=args.device)
        return model, cfg
    import torch

    from .models import policy_cnn

    cfg = policy_cnn.CONFIGS[args.model]
    return policy_cnn.init(torch.Generator().manual_seed(0), cfg,
                           device=args.device), cfg


def _train_overrides(args) -> dict:
    overrides = parse_overrides(args.set)
    if args.tp is not None:
        overrides["tensor_parallel"] = args.tp  # shorthand for --set
    return overrides


def cmd_train(args) -> None:
    if args.resume and args.auto_resume:
        raise SystemExit("--resume and --auto-resume are mutually exclusive")
    if args.elastic:
        # elastic multi-host training (docs/robustness.md, "Distributed
        # failure domains"): every host runs this same command over a
        # shared run dir; peer death is detected via heartbeat silence,
        # survivors converge on the latest valid checkpoint, re-mesh, and
        # resume — --iters stays the TOTAL step target, so re-running the
        # identical command after any number of host losses converges on
        # the same final state
        if not args.auto_resume:
            raise SystemExit("--elastic requires --auto-resume RUN_DIR "
                             "(the shared directory hosts converge on)")
        from .parallel.elastic import ElasticConfig, run_elastic

        ecfg = ElasticConfig(
            process_id=args.process_id,
            expected_hosts=args.expected_hosts,
            heartbeat_interval_s=args.heartbeat_interval,
            miss_budget=args.miss_budget,
            straggler_factor=args.straggler_factor,
            init_deadline_s=args.init_deadline,
            step_deadline_s=args.step_deadline,
            max_recoveries=args.max_recoveries,
            reshard=args.reshard,
            coordinator=args.coordinator,
            num_processes=args.num_processes,
            obs_port=args.obs_port,
        )
        summary = run_elastic(args.auto_resume, args.iters,
                              overrides=_train_overrides(args), ecfg=ecfg,
                              device=args.device)
        print(f"elastic host {ecfg.process_id} done at step "
              f"{summary['final_step']} ({summary['recoveries']} recoveries, "
              f"{summary['steps_lost_total']} steps rolled back)")
        return
    if args.coordinator is not None or args.num_processes not in (None, 1):
        # one rank of a torch.distributed group (NCCL on the cards, gloo
        # on the CPU): every rank runs this same command with its own
        # --process-id; the Experiment lays its mesh over the group
        from .parallel import distributed

        distributed.initialize(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
    if args.auto_resume:
        # elastic restart loop: --iters is the TOTAL step target, so
        # re-running the identical command after any number of kills
        # converges on the same final state as one uninterrupted run
        # (docs/robustness.md)
        exp = Experiment.auto_resume(args.auto_resume,
                                     overrides=_train_overrides(args),
                                     device=args.device)
        if exp.step > 0:
            print(f"auto-resumed {exp.id} at step {exp.step}")
        else:
            print(f"experiment {exp.id} (no valid checkpoint in "
                  f"{args.auto_resume}; starting fresh)")
        iters = args.iters - exp.step
        if iters <= 0:
            print(f"step {exp.step} already meets --iters {args.iters}; "
                  f"nothing to do")
            return
    elif args.resume:
        exp = Experiment.load(args.resume, device=args.device)
        print(f"resumed {exp.id} at step {exp.step}")
        iters = args.iters
    else:
        config = ExperimentConfig(**_train_overrides(args))
        exp = Experiment(config, device=args.device)
        print(f"experiment {exp.id}")
        iters = args.iters
    exporter = None
    if args.obs_port is not None:
        # live /metrics + /healthz for the single-host run
        # (docs/observability.md); the elastic path wires its own
        # exporter with ledger-backed health inside run_elastic
        from .obs import start_exporter

        exporter = start_exporter(args.obs_port)
        exporter.add_health(
            "train", lambda: {"healthy": True, "run_id": exp.id,
                              "step": exp.step})
    tracker = None
    if args.slo:
        # declarative SLOs over the live registry: burn-rate states show
        # as gauge + slo_burn lines, and /healthz reports degraded (but
        # stays 200) while an objective burns (docs/observability.md)
        from .obs.slo import SloTracker, parse_slo_spec

        health_fn = exporter.check_health if exporter is not None else None
        tracker = SloTracker(parse_slo_spec(args.slo, health_fn=health_fn))
        tracker.start(interval_s=args.slo_interval)
        if exporter is not None:
            exporter.add_health("slo", tracker.health)
    try:
        summary = exp.run(iters)
    finally:
        if tracker is not None:
            tracker.stop()
        if exporter is not None:
            exporter.close()
    print(f"final EWMA cost {summary['final_ewma']:.4f}; "
          f"checkpoint at {exp.save()}")


def verified_reload(fleet, path: str) -> dict | None:
    """Hot-reload ``path`` through the fleet ONLY if it passes the full
    format-v2 integrity check (per-array CRC32s + whole-file digest, the
    ``find_latest_valid`` discipline). Returns the reload report, or None
    when the checkpoint is unverifiable — the fleet keeps serving its
    current weights and the operator sees why. The publish side writes
    atomically (utils.atomicio), so a rejection here means real
    corruption or a non-atomic producer, never a mid-write race."""
    import sys

    from .experiments import checkpoint as ckpt

    try:
        ckpt.verify_checkpoint(path)
    except ckpt.CheckpointError as e:
        print(f"serve: NOT reloading {e.path}: {e.reason} — fleet keeps "
              "its current weights", file=sys.stderr, flush=True)
        return None
    return fleet.reload(path)


def cmd_serve(args) -> None:
    """Long-running serving daemon: a FleetRouter of N supervised policy
    replicas with live /metrics + /healthz and checkpoint hot-reload.

    This is the operational front for the always-on loop (ROADMAP item
    4): a trainer/gatekeeper publishes a new champion checkpoint at
    ``--watch PATH``, and the daemon rolls it through the fleet one
    replica at a time — in-flight futures never drop, capacity never
    dips below N-1, the forwards are reused (docs/serving.md)."""
    import os
    import signal
    import threading
    import time as _time

    from .obs import health_from_engine, start_exporter
    from .serving import EngineConfig, fleet_policy_engine

    params, cfg = _policy(args)
    source = (args.checkpoint if args.checkpoint
              else f"random-init {args.model!r}")
    variants = tuple(v.strip() for v in args.variant.split(",") if v.strip())
    # the serve gate: lossy variants tolerance-verify against the f32
    # forward of this very checkpoint before any replica exists — a
    # failing variant refuses to serve, typed (docs/serving.md)
    from .serving import VariantToleranceError

    try:
        fleet = fleet_policy_engine(
            params, cfg, replicas=args.fleet,
            config=EngineConfig(max_wait_ms=args.max_wait_ms),
            variants=variants, device=args.device)
    except VariantToleranceError as e:
        raise SystemExit(
            f"serve: {e}\n(quantizing an undecided net flips tied "
            "argmaxes — gate a trained champion, or serve --variant "
            "f32; docs/serving.md \"Serving variants\")") from e
    warmed = fleet.warmup()
    assignment = [variants[i % len(variants)] for i in range(args.fleet)]
    if set(assignment) != {"f32"}:
        print(f"serve: replica variants {assignment} (hot-reload "
              "re-prepares each replica's program from the new base "
              "checkpoint)", flush=True)
    exporter = start_exporter(args.obs_port)
    exporter.add_health("fleet", health_from_engine(fleet))
    session_service = None
    if args.sessions:
        # the durable game-session service rides the same daemon: the
        # store auto-recovers (checkpoint + WAL replay) in its
        # constructor, so a restarted daemon resumes every live game
        # before the first request lands; its liveness (open sessions,
        # WAL lag, corrupt count) joins the composed /healthz verdict
        from .sessions import GameService, SessionStore

        store = SessionStore(args.sessions)
        session_service = GameService(fleet, store,
                                      search_sims=args.search_sims)
        exporter.add_health("sessions", session_service.health)
        rec = store.recovery
        print(f"serve: session store {args.sessions} — "
              f"{rec['sessions']} live game(s) resumed "
              f"(checkpoint seq {rec['checkpoint_seq']}, "
              f"{rec['wal_records_applied']} WAL record(s) replayed"
              + (f", {len(rec['corrupt'])} corrupt" if rec["corrupt"]
                 else "") + ")", flush=True)
    sampler = telem_sink = None
    if args.telemetry_dir:
        # the fleet telemetry plane on the daemon (docs/observability.md
        # "Fleet telemetry plane"): registry history + streaming anomaly
        # watchlist into --telemetry-dir; `cli dash DIR` renders it live
        # and the exporter's /series serves the recent window
        from .obs import (AnomalyDetector, JsonlSink, TelemetrySampler,
                          TimeSeriesStore, set_live_store)

        ts_store = TimeSeriesStore(args.telemetry_dir)
        telem_sink = JsonlSink(os.path.join(args.telemetry_dir,
                                            "metrics.jsonl"))
        detector = AnomalyDetector(sink=telem_sink, store=ts_store)
        sampler = TelemetrySampler(ts_store,
                                   interval_s=args.telemetry_interval,
                                   listeners=[detector.observe])
        set_live_store(ts_store)
        sampler.start()
        print(f"serve: telemetry -> {args.telemetry_dir} "
              f"(ts-NNNN.jsonl every {args.telemetry_interval:g}s; "
              "`cli dash` it)", flush=True)
    print(f"serve: fleet of {args.fleet} replica(s) over {source} "
          f"({warmed} warm shapes/replica); /healthz composes the fleet "
          "verdict", flush=True)
    stop = threading.Event()
    # SIGINT/SIGTERM end the daemon; the previous handlers come back when
    # it returns, so an in-process caller keeps its own
    previous = {sig: signal.signal(sig, lambda *_: stop.set())
                for sig in (signal.SIGINT, signal.SIGTERM)}
    watched_mtime = (os.path.getmtime(args.watch)
                     if args.watch and os.path.exists(args.watch) else None)
    t_end = (None if args.duration <= 0
             else _time.monotonic() + args.duration)
    try:
        while not stop.is_set():
            if t_end is not None and _time.monotonic() >= t_end:
                break
            stop.wait(min(args.watch_interval, 0.5))
            if args.watch and os.path.exists(args.watch):
                mtime = os.path.getmtime(args.watch)
                if watched_mtime is None or mtime > watched_mtime:
                    watched_mtime = mtime
                    # verify-before-swap: a torn or corrupt publish must
                    # never reach live replicas (docs/loop.md)
                    out = verified_reload(fleet, args.watch)
                    if out is not None:
                        print(f"serve: hot-reloaded {args.watch} through "
                              f"{out['replicas']} replica(s) in "
                              f"{out['seconds']:.3f}s (zero dropped "
                              "futures, no new forward signature)",
                              flush=True)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        health = fleet.health()
        if session_service is not None:
            # final compacting checkpoint: the next start resumes from
            # one file instead of replaying the whole WAL tail
            session_service.close()
        if sampler is not None:
            sampler.stop(final_sample=True)
            sampler.store.close()
        if telem_sink is not None:
            telem_sink.close()
        exporter.close()
        fleet.close()
        print(f"serve: done ({health['replicas_serving']}/"
              f"{health['replicas_total']} serving, "
              f"{health['respawns']} respawns, {health['reloads']} "
              "reloads)", flush=True)


def cmd_loop(args) -> None:
    """The always-on expert-iteration service (docs/loop.md): selfplay
    actors → replay buffer → continuous learner → arena gatekeeper, all
    supervised, champion hot-swapped through the serving fleet on every
    gate pass. Supersedes the hand-sequenced tools/r5_value_loop.sh —
    one long-running process instead of stage-by-stage shell queues, and
    it survives kills: re-running the identical command over the same
    --run-dir resumes bit-exactly (learner checkpoint + read cursor)."""
    import json as _json

    from .loop import ExpertIterationLoop, LoopConfig

    config = LoopConfig(
        trace=args.trace,
        telemetry=args.telemetry,
        telemetry_interval_s=args.telemetry_interval,
        actors=args.actors,
        fleet=args.fleet,
        games_per_round=args.games_per_round,
        max_moves=args.max_moves,
        temperature=args.temperature,
        steps_per_window=args.window_steps,
        min_window_positions=args.min_positions,
        scheme=args.scheme,
        segment_games=args.segment_games,
        capacity_positions=args.buffer_capacity,
        gate_games=args.gate_games,
        gate_threshold=args.gate_threshold,
        windows=args.windows,
        duration_s=args.duration,
        stall_timeout_s=args.stall_timeout,
        max_wait_ms=args.max_wait_ms,
        seed=args.seed,
        search_sims=args.search_sims,
    )
    overrides = parse_overrides(args.set)
    overrides.setdefault("name", "loop-learner")
    lcfg = ExperimentConfig(**overrides)
    loop = ExpertIterationLoop(args.run_dir, config, lcfg,
                               seed_checkpoint=args.checkpoint,
                               device=args.device)
    exporter = None
    if args.obs_port is not None:
        from .obs import health_from_engine, start_exporter

        exporter = start_exporter(args.obs_port)
        exporter.add_health("fleet", health_from_engine(loop.fleet))
        exporter.add_health(
            "loop", lambda: {"healthy": not loop.fatal,
                             **{k: v for k, v in loop.summary().items()
                                if k in ("windows_trained", "gates_passed",
                                         "games_acked")}})
    try:
        summary = loop.run()
    finally:
        if exporter is not None:
            exporter.close()
    print(_json.dumps(summary, default=str))


def cmd_obs(args) -> None:
    """Offline per-stage report over one run directory (obs/report.py)."""
    import json as _json

    from .obs.report import format_report, summarize_run

    summary = summarize_run(args.run_dir)
    if args.json:
        print(_json.dumps(summary, indent=1, default=str))
    else:
        print(format_report(summary))


def cmd_dash(args) -> None:
    """The live operator dashboard (obs/dash.py, docs/observability.md
    "Fleet telemetry plane"): one terminal frame of watchlist
    sparklines, the per-host/per-replica fleet health grid, the anomaly
    tail, and SLO burn state — refreshed in place until interrupted,
    or rendered once for CI with ``--once`` / ``--json``."""
    import json as _json
    import time as _time

    from .obs import dash as dash_mod

    urls = {}
    for i, u in enumerate(p.strip()
                          for p in (args.scrape or "").split(",")):
        if u:
            # host label: the URL's host:port (stable + readable), not
            # the list index — the same endpoint keeps the same label
            # across invocations
            urls[u.split("//")[-1].rstrip("/") or f"host{i}"] = u
    if not args.run_dir and not urls:
        raise SystemExit("dash needs RUN_DIR or --scrape URL[,URL...]")
    history = dash_mod.DashHistory(window=args.window) if urls else None
    once = args.once or args.json
    try:
        while True:
            data = dash_mod.collect_dash(
                args.run_dir or None, urls or None, history=history,
                window=args.window)
            if args.json:
                print(_json.dumps(data, indent=1, default=str))
            else:
                frame = dash_mod.render_dash(data)
                if not once:
                    # clear + home: redraw in place, no scrollback spam
                    print("\x1b[2J\x1b[H", end="")
                print(frame, flush=True)
            if once:
                return
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return
    except BrokenPipeError:
        return  # `cli dash ... | head` is legitimate operator usage


def cmd_trend(args) -> None:
    """The bench trajectory table (obs/dash.py): BENCH_r*.json rounds
    + BENCH_LAST_GOOD.json, per metric, stale captures marked — the
    history the regression gate's verdicts come from."""
    import json as _json

    from .obs import dash as dash_mod

    data = dash_mod.collect_trend(args.root)
    if args.json:
        print(_json.dumps(data, indent=1, default=str))
    else:
        print(dash_mod.render_trend(data))


def _workload_engine(args):
    """The record/replay target: a FleetRouter over --fleet supervised
    policy replicas (the cmd_serve build, without the daemon loop)."""
    from .serving import EngineConfig, fleet_policy_engine

    params, cfg = _policy(args)
    fleet = fleet_policy_engine(
        params, cfg, replicas=args.fleet,
        config=EngineConfig(max_wait_ms=args.max_wait_ms),
        device=args.device)
    fleet.warmup()
    return fleet


def _pct(rate) -> str:
    return "n/a" if rate is None else f"{rate:.1%}"


def cmd_workload(args) -> None:
    """The workload observatory (obs/workload.py + serving/replay.py,
    docs/observability.md "Workload observatory"):

    ``record``   drive a live fleet with a deterministic opening-heavy
                 synthetic workload (real game openings via the go/
                 rules engine, Zipf-skewed popularity, Poisson arrivals)
                 with the workload recorder armed — producing a REAL
                 capture: per-request content digests, canonical
                 8-fold-symmetry keys, tiers, buckets, outcomes,
                 latencies, plus the deduplicated position store.
    ``analyze``  characterize a capture: unique-vs-total positions,
                 symmetry-dedup gain, popularity skew, burstiness, tier
                 mix, and the projected cache hit rate.
    ``replay``   re-serve a capture against a live fleet with open-loop
                 arrival fidelity at --speed x, reporting timeline error
                 vs the recorded arrivals next to the served outcomes."""
    import json as _json

    from .obs import workload as workload_mod

    if args.wcmd == "analyze":
        stats = workload_mod.analyze_capture(args.capture)
        if args.simulate_cache:
            from .serving import cache as cache_mod

            sizes = [int(s) for s in args.simulate_cache.split(",")
                     if s.strip()]
            reqs = workload_mod.load_capture(args.capture)["requests"]
            exact_keys = [r["digest"] for r in reqs]
            canon_keys = [r.get("canonical") or r["digest"] for r in reqs]
            stats["simulated_cache"] = {
                str(size): {
                    "exact": cache_mod.simulate(exact_keys, size),
                    "canonical": cache_mod.simulate(canon_keys, size),
                } for size in sizes}
        if args.json:
            print(_json.dumps(stats, indent=1, default=str))
        else:
            print(workload_mod.format_workload(stats))
            for size, sim in (stats.get("simulated_cache") or {}).items():
                ex, ca = sim["exact"], sim["canonical"]
                print(f"  simulated cache[{size}]: exact "
                      f"{_pct(ex['hit_rate'])} hit rate "
                      f"({ex['evictions']} evictions), canonical "
                      f"{_pct(ca['hit_rate'])} ({ca['evictions']})")
        return

    from .serving import replay as replay_mod

    if args.wcmd == "record":
        items = replay_mod.build_synthetic_requests(
            args.sgf_dir, requests=args.requests, games=args.games,
            opening_moves=args.opening_moves, rate_per_s=args.rate,
            zipf_s=args.zipf, seed=args.seed)
        recorder = workload_mod.configure_workload(args.out)
        fleet = _workload_engine(args)
        searches = []
        try:
            replayed = replay_mod.WorkloadReplayer(
                fleet, items, speed=args.speed).run()
            if args.search:
                # search-shaped traffic: PUCT searches rooted at the
                # first distinct synthetic positions, leaf evals labeled
                # search:<id> so `workload analyze` can report the
                # transposition dup ratio the tree actually produced
                from .search import Search, SearchConfig, game_from_packed

                searcher = Search(fleet, SearchConfig(
                    simulations=args.search_sims, tier="interactive"))
                seen = set()
                for item in items:
                    if len(searches) >= args.search:
                        break
                    key = item["packed"].tobytes()
                    if key in seen:
                        continue
                    seen.add(key)
                    res = searcher.search(game_from_packed(
                        item["packed"], item["player"]))
                    searches.append({"search_id": res.search_id,
                                     "move": res.move,
                                     "simulations": res.simulations,
                                     "lost": res.lost,
                                     "wave_occupancy": res.wave_occupancy})
        finally:
            fleet.close()
            recorder.drain()
            workload_mod.disable_workload()
        stats = workload_mod.analyze_capture(args.out)
        out = {"capture": args.out, "drive": replayed, "workload": stats}
        if searches:
            out["searches"] = searches
        if args.json:
            print(_json.dumps(out, indent=1, default=str))
        else:
            print(f"recorded {stats['requests']} request(s) -> {args.out}")
            print(workload_mod.format_workload(stats))
        return

    # replay: fidelity vs the recorded timeline + live outcomes
    source = workload_mod.analyze_capture(args.capture)
    trace = replay_mod.load_trace(args.capture)
    fleet = _workload_engine(args)
    try:
        report = replay_mod.WorkloadReplayer(
            fleet, trace, speed=args.speed,
            timeout_s=args.timeout or None).run()
    finally:
        fleet.close()
    report["capture"] = args.capture
    report["mix_match"] = (
        report["requests"] == source.get("requests")
        and report["tiers"] == source.get("tiers"))
    if args.json:
        print(_json.dumps(report, indent=1, default=str))
    else:
        print(f"replayed {report['requests']} request(s) from "
              f"{args.capture} at {args.speed:g}x")
        print(f"  timeline: span {report['actual_span_s']}s vs target "
              f"{report['target_span_s']}s (error "
              f"{report['span_error_frac']:.2%}, mean lag "
              f"{report['mean_lag_ms']}ms, p99 {report['p99_lag_ms']}ms) "
              f"fidelity_ok={report['fidelity_ok']}")
        print(f"  mix: tiers {report['tiers']} "
              f"(matches capture: {report['mix_match']})")
        print(f"  outcomes: {report['outcomes']}  "
              f"{report['boards_per_sec']} boards/sec")
    if not report["fidelity_ok"]:
        raise SystemExit(1)


def cmd_chaos(args) -> None:
    """Chaos campaigns against a live fleet (deepgo_tpu/chaos,
    docs/robustness.md "Chaos campaigns"):

    ``run``     build a fleet (defenses armed unless --no-defenses),
                replay an opening-heavy trace while the scenario's
                fault timeline executes, and write the graded JSON
                campaign report; exits nonzero when the grade fails.
    ``report``  re-render (and re-grade) a stored campaign report."""
    import json as _json

    from .chaos import (CampaignConfig, CampaignRunner, Scenario,
                        acceptance_scenario, brownout_scenario,
                        grade_report)

    def _render(rep: dict) -> None:
        grade = rep.get("grade", {})
        slo = rep.get("slo", {})
        answers = rep.get("answers", {})
        canary = rep.get("canary")
        print(f"scenario: {rep['scenario']['name']} "
              f"(seed {rep['scenario']['seed']}, "
              f"{len(rep['scenario']['events'])} event(s))")
        print(f"  answers: {answers.get('checked', 0)} checked, "
              f"{answers.get('wrong', 0)} wrong, "
              f"{answers.get('lost', 0)} lost")
        print(f"  slo[{slo.get('tier')}]: {slo.get('good_frac')} within "
              f"{slo.get('threshold_s')}s vs target {slo.get('target')} "
              f"(burn {slo.get('burn')}) -> "
              f"{'ok' if slo.get('ok') else 'MISSED'}")
        if canary:
            print(f"  canary: {canary['probes']} probe(s), "
                  f"{canary['failures']} failure(s), detected "
                  f"{sorted({d['replica'] for d in canary['detected']})}")
        print(f"  counters: {rep.get('counters')}")
        verdict = "PASS" if grade.get("pass") else "FAIL"
        print(f"  grade: {verdict}"
              + ("" if grade.get("pass")
                 else " — " + "; ".join(grade.get("reasons", []))))

    if args.ccmd == "report":
        with open(args.report, encoding="utf-8") as fh:
            rep = _json.load(fh)
        rep["grade"] = grade_report(rep)  # re-grade: the verdict is
        # derived from measurements, never trusted from the file
        if args.json:
            print(_json.dumps(rep, indent=1, default=str))
        else:
            _render(rep)
        if not rep["grade"]["pass"]:
            raise SystemExit(1)
        return

    from .serving import replay as replay_mod

    if args.trace:
        trace = replay_mod.load_trace(args.trace)
    else:
        trace = replay_mod.build_synthetic_requests(
            args.sgf_dir, requests=args.requests, games=args.games,
            rate_per_s=args.rate, seed=args.seed)
    span_s = ((trace[-1]["t"] - trace[0]["t"]) / args.speed
              if len(trace) > 1 else 1.0)
    if args.scenario:
        with open(args.scenario, encoding="utf-8") as fh:
            scenario = Scenario.from_dict(_json.load(fh))
    elif args.preset == "full":
        scenario = acceptance_scenario(span_s, seed=args.seed)
    else:
        scenario = brownout_scenario(span_s, seed=args.seed)
    # per-scenario SLO defaults mirror the robustness contract
    # (docs/robustness.md): a pure brownout is the hedging/ejection A/B
    # axis and is graded tight; a kill- or corruption-bearing scenario
    # is an integrity campaign whose latency legitimately spikes around
    # the failover/eject/respawn, so it is graded on survival unless
    # the caller pins the bar explicitly
    hard = any(e.kind in ("kill", "corrupt") for e in scenario.events)
    slo_threshold = (args.slo_threshold if args.slo_threshold is not None
                     else (2.0 if hard else 0.15))
    slo_target = (args.slo_target if args.slo_target is not None
                  else (0.5 if hard else 0.95))
    # the canary is armed only when the scenario can corrupt: probes
    # submit straight to a target replica (no hedging), so against a
    # pure brownout every probe through the slow replica is a
    # guaranteed SLO-histogram miss — measurement pollution, not a
    # defense (bench --mode chaos splits its arms the same way)
    canary = (not args.no_defenses) and any(
        e.kind == "corrupt" for e in scenario.events)
    fleet = _chaos_fleet(args)
    try:
        report = CampaignRunner(
            fleet, trace, scenario,
            CampaignConfig(slo_threshold_s=slo_threshold,
                           slo_target=slo_target, speed=args.speed,
                           canary=canary)
        ).run(report_path=args.out)
    finally:
        fleet.close()
    if args.json:
        print(_json.dumps(report, indent=1, default=str))
    else:
        _render(report)
        if args.out:
            print(f"report -> {args.out}")
    if not report["grade"]["pass"]:
        raise SystemExit(1)


def _chaos_fleet(args):
    """The campaign target: a FleetRouter of supervised policy replicas
    with ``max_restarts=0`` (a dispatcher kill crosses into the FLEET
    failure domain) and the gray-failure defense posture armed unless
    --no-defenses (the A/B's control arm)."""
    from .chaos import defended_config
    from .serving import (EngineConfig, FleetConfig, SupervisorConfig,
                          fleet_policy_engine)

    params, cfg = _policy(args)
    # fast respawn + a short bucket ladder, as in bench --mode chaos:
    # an ejected/killed replica must rebuild within the short smoke
    # trace, and its warmup must not re-execute 128/512-wide rungs —
    # on the CPU those monopolize the shared intra-op pool for ~1s,
    # starving the survivor, and the SLO verdict ends up measuring the
    # rebuild instead of the defenses
    base = FleetConfig(respawn_base_s=0.01, respawn_cap_s=0.05)
    fleet = fleet_policy_engine(
        params, cfg, replicas=args.fleet,
        config=EngineConfig(buckets=(1, 8, 32),
                            max_wait_ms=args.max_wait_ms),
        fleet=base if args.no_defenses else defended_config(base),
        supervisor=SupervisorConfig(max_restarts=0), device=args.device)
    fleet.warmup()
    return fleet


def cmd_trace(args) -> None:
    """Request waterfall / lineage chain reconstruction (obs/tracing.py).

    ``ID`` is a trace-id prefix (from the `cli obs` exemplar table, a
    `trace_request` record, or a flight dump), ``champion`` / a window
    number / a params-digest prefix for the provenance chain. With no ID,
    lists what the run directory has to offer."""
    import json as _json

    from .obs.tracing import load_trace_events, trace_report

    if args.id is None:
        events = load_trace_events(args.run_dir)
        print(trace_report(args.run_dir, ""))
        if not events["requests"] and not events["lineage"]:
            raise SystemExit(1)
        return
    if args.json:
        from .obs.tracing import build_lineage, find_request

        events = load_trace_events(args.run_dir)
        record = find_request(events, args.id)
        out = record if record is not None \
            else build_lineage(events, args.id)
        if out is None:
            raise SystemExit(f"no trace or lineage matches {args.id!r} "
                             f"in {args.run_dir}")
        print(_json.dumps(out, indent=1, default=str))
        return
    print(trace_report(args.run_dir, args.id))


def cmd_cost(args) -> None:
    """The device cost ledger (obs/costmodel.py): every entrypoint of one
    model config — the serving bucket ladder (f32 and int8), the 8-fold
    sym ensembles, the train/eval steps — run ONCE on ``--device`` on
    empty boards under the FLOP counter, with its FLOPs, the card's
    device-memory bill and the peak from the card table. Unlike the JAX
    package's AOT ledger this executes every entrypoint on the device (it
    allocates, and on the card it launches the expansion kernels). A row
    whose run fails degrades to the analytic estimator, ``estimated``."""
    import json as _json

    from .obs import costmodel

    buckets = tuple(int(b) for b in args.buckets.split(",") if b.strip())
    ledger = costmodel.standard_ledger(
        model=args.model, buckets=buckets, train_batch=args.train_batch,
        sym_bucket=args.sym_bucket, device=args.device)
    costmodel.set_cost_ledger(ledger)
    if args.json:
        print(_json.dumps(ledger.roofline(), indent=1, default=str))
    else:
        print(costmodel.format_ledger(ledger))


def cmd_lint(args) -> None:
    """Invariant linter + grammar drift checker (docs/static_analysis.md).

    Exits non-zero on any strict finding: raw durable writes outside
    utils/atomicio, nondeterminism in step-indexed/replay modules,
    anonymous/unsupervised threads, service-layer asserts, and code<->docs
    grammar drift, torch host<->device syncs in the hot paths. The sweep
    covers ``deepgo_tpu_torch/`` and ``chip_smoke.py`` (the policy is
    checked in at analysis/config.py)."""
    import json as _json

    from .analysis.linter import format_report, run_lint

    findings = run_lint(args.root, paths=args.paths or None,
                        grammar=not args.no_grammar)
    strict = sum(1 for f in findings if f.level == "strict")
    if args.json:
        print(_json.dumps({
            "findings": [f.to_dict() for f in findings],
            "strict": strict,
            "warn": len(findings) - strict,
        }, indent=1))
    else:
        print(format_report(findings))
    if strict:
        raise SystemExit(1)


def cmd_eval(args) -> None:
    exp = Experiment.load(args.checkpoint, device=args.device)
    result = exp.evaluate(split=args.split, limit=args.limit)
    print(f"{args.split}: cost={result['cost']:.4f} "
          f"accuracy={result['accuracy']:.4f} n={result['n']}")


def cmd_localtest(args) -> None:
    """End-to-end smoke on the bundled data (reference localtest.lua:1-11)."""
    defaults = dict(
        name="localtest",
        batch_size=16,
        channels=32,
        validation_size=64,
        validation_interval=20,
        loader_threads=1,
        data_parallel=1,
    )
    # --set wins over the smoke-run defaults (the reference's override
    # tables work the same way, localtest.lua:4-10)
    defaults.update(parse_overrides(args.set))
    config = ExperimentConfig(**defaults)
    exp = Experiment(config, device=args.device)
    summary = exp.run(args.iters)
    print(f"localtest done: final EWMA {summary['final_ewma']:.4f}")


def main(argv=None) -> None:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["selfplay"]:
        # plain forwarding, before argparse: REMAINDER cannot capture
        # leading --flags, and the selfplay command owns its own help
        from . import selfplay

        return selfplay.main(argv[1:])

    ap = argparse.ArgumentParser(prog="deepgo_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train or resume an experiment")
    p.add_argument("--iters", type=int, required=True,
                   help="steps to run (TOTAL step target with --auto-resume)")
    p.add_argument("--resume", help="checkpoint path to continue from")
    p.add_argument("--auto-resume", metavar="RUN_DIR",
                   help="continue from the newest valid checkpoint in "
                        "RUN_DIR (corrupt ones are skipped), or start a "
                        "fresh run there; --set applies to fresh starts "
                        "only")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument("--elastic", action="store_true",
                   help="multi-host elastic mode (requires --auto-resume): "
                        "heartbeat liveness, deadline-wrapped bootstrap, "
                        "checkpoint-coordinated re-mesh recovery on host "
                        "loss over the composed dp×tp×ZeRO mesh; combine "
                        "with --tp/--reshard for tp-crossing recovery "
                        "(docs/robustness.md)")
    p.add_argument("--tp", type=int, default=None, metavar="N",
                   help="tensor-parallel factor of the mesh (shorthand for "
                        "--set tensor_parallel=N): conv channels shard "
                        "over the \"model\" axis, composing with data "
                        "parallelism and ZeRO optimizer-state sharding")
    p.add_argument("--reshard", action="store_true",
                   help="(--elastic) let recovery SHRINK the tp factor "
                        "with the surviving fraction and reshard the "
                        "checkpoint state into the new dp×tp×ZeRO layout "
                        "(parallel/reshard.py); without it a re-mesh "
                        "keeps the stored tp")
    p.add_argument("--process-id", type=int, default=0,
                   help="this host's id in [0, expected-hosts) (--elastic) "
                        "or this rank in [0, num-processes)")
    p.add_argument("--expected-hosts", type=int, default=1,
                   help="(--elastic) fleet size whose liveness to watch")
    p.add_argument("--heartbeat-interval", type=float, default=1.0,
                   metavar="S", help="(--elastic) expected beat cadence")
    p.add_argument("--miss-budget", type=int, default=3,
                   help="(--elastic) beats of silence before a peer is "
                        "declared lost (budget = interval x this)")
    p.add_argument("--straggler-factor", type=float, default=3.0,
                   help="(--elastic) flag hosts slower than this multiple "
                        "of the fleet median step latency")
    p.add_argument("--init-deadline", type=float, default=120.0, metavar="S",
                   help="(--elastic) external-watchdog fuse around the "
                        "distributed bootstrap (0 disables)")
    p.add_argument("--step-deadline", type=float, default=0.0, metavar="S",
                   help="(--elastic) external-watchdog fuse around the "
                        "FIRST sharded step (compile + first collective; "
                        "0 disables)")
    p.add_argument("--max-recoveries", type=int, default=8,
                   help="(--elastic) bounded recovery budget before a host "
                        "loss is surfaced instead of absorbed")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="torch.distributed rendezvous (host:port, "
                        "tcp://host:port or file:///path); every rank "
                        "runs the same command with its --process-id "
                        "(omit on single-host / simulated fleets)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="torch.distributed world size")
    p.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                   help="serve live /metrics (Prometheus text) and "
                        "/healthz on this port for the duration of the "
                        "run (0 = ephemeral port, printed at startup; "
                        "docs/observability.md)")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="declarative SLOs evaluated live against the "
                        "metrics registry with multi-window burn-rate "
                        "logic, e.g. 'train_sps=1000,dispatch_ms=50@0.999"
                        ",availability=0.999' (availability needs "
                        "--obs-port). Burns emit slo_burn events, feed "
                        "the deepgo_slo_burn_ratio gauge, and mark "
                        "/healthz degraded without failing it "
                        "(docs/observability.md; plain train path — the "
                        "elastic loop owns its own health wiring)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.add_argument("--slo-interval", type=float, default=2.0, metavar="S",
                   help="SLO evaluation cadence in seconds (default 2)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate a checkpoint")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--limit", type=int)
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("localtest", help="bundled-data smoke run")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.set_defaults(fn=cmd_localtest)

    p = sub.add_parser("serve", help="serving-fleet daemon: N supervised "
                                     "replicas behind the failover router "
                                     "with live /metrics + /healthz and "
                                     "checkpoint hot-reload "
                                     "(docs/serving.md)")
    p.add_argument("--fleet", type=int, default=2, metavar="N",
                   help="replica count (default 2)")
    p.add_argument("--checkpoint",
                   help="policy checkpoint to serve (default: random init)")
    p.add_argument("--model", default="small",
                   help="model config for random init (no --checkpoint)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="per-replica dispatcher coalescing window")
    p.add_argument("--variant", default="f32", metavar="CSV",
                   help="serving variant(s) assigned round-robin per "
                        "replica: f32 | int8 | sym | int8+sym "
                        "(e.g. 'f32,int8' A/Bs the quantized champion "
                        "against full precision live; lossy variants "
                        "are tolerance-gated before serving — "
                        "docs/serving.md)")
    p.add_argument("--obs-port", type=int, default=0, metavar="PORT",
                   help="port for /metrics + /healthz (0 = ephemeral, "
                        "printed at startup)")
    p.add_argument("--watch", metavar="PATH",
                   help="poll this checkpoint path and hot-reload the "
                        "fleet (one replica at a time, no dropped "
                        "futures) whenever its mtime advances — the "
                        "champion-publish hook for the expert-iteration "
                        "loop")
    p.add_argument("--watch-interval", type=float, default=5.0, metavar="S",
                   help="checkpoint poll cadence (default 5s)")
    p.add_argument("--telemetry-dir", metavar="DIR",
                   help="arm the fleet telemetry plane: append the "
                        "registry to DIR/ts-NNNN.jsonl on a fixed "
                        "cadence and run the streaming anomaly "
                        "watchlist over it (anomaly events -> "
                        "DIR/metrics.jsonl; `cli dash DIR` renders it "
                        "live — docs/observability.md)")
    p.add_argument("--telemetry-interval", type=float, default=1.0,
                   metavar="S",
                   help="telemetry sampling cadence (default 1s)")
    p.add_argument("--duration", type=float, default=0.0, metavar="S",
                   help="serve for S seconds then exit (0 = until "
                        "SIGINT/SIGTERM)")
    p.add_argument("--sessions", metavar="DIR",
                   help="host the durable game-session service over DIR "
                        "(WAL + checkpoints; crashed/killed daemons "
                        "resume every live game on restart) next to "
                        "/metrics + /healthz — session liveness (open "
                        "sessions, WAL lag) joins the composed health "
                        "verdict (docs/robustness.md)")
    p.add_argument("--search-sims", type=int, default=0, metavar="N",
                   help="engine replies in --sessions games run an "
                        "N-simulation PUCT search over the fleet "
                        "instead of one policy argmax (0 = off; "
                        "docs/search.md)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("loop", help="always-on expert-iteration service: "
                                    "selfplay actors → replay buffer → "
                                    "continuous learner → arena gatekeeper, "
                                    "champion hot-swapped through the "
                                    "serving fleet (docs/loop.md; "
                                    "supersedes tools/r5_value_loop.sh)")
    p.add_argument("--run-dir", default="runs/loop",
                   help="the loop's durable home (buffer, learner "
                        "checkpoints + cursor, champion.npz, loop.jsonl); "
                        "re-running over the same dir resumes after any "
                        "kill")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="seed champion checkpoint (default: fresh random "
                        "init from the learner model config)")
    p.add_argument("--actors", type=int, default=2,
                   help="selfplay actor threads (default 2)")
    p.add_argument("--fleet", type=int, default=2, metavar="N",
                   help="serving-fleet replicas behind the failover "
                        "router; actors ride the selfplay tier "
                        "(default 2)")
    p.add_argument("--games-per-round", type=int, default=8,
                   help="games per actor round (a round is the actor's "
                        "restart/replay unit)")
    p.add_argument("--max-moves", type=int, default=120,
                   help="selfplay and gate-match move cap")
    p.add_argument("--temperature", type=float, default=0.25,
                   help="actor sampling temperature (trajectory "
                        "diversity for the corpus)")
    p.add_argument("--search-sims", type=int, default=0, metavar="N",
                   help="actors pick moves by N-simulation PUCT search "
                        "over the fleet instead of one policy sample "
                        "(0 = off; AlphaZero-style search-selfplay, "
                        "docs/search.md)")
    p.add_argument("--window-steps", type=int, default=50,
                   help="learner steps per training window (each window "
                        "publishes one challenger)")
    p.add_argument("--min-positions", type=int, default=512,
                   help="sealed positions required before a window may "
                        "freeze its extent")
    p.add_argument("--scheme", default="game",
                   choices=["game", "uniform", "winner"],
                   help="sampling scheme over the frozen extent "
                        "(winner = outcome-conditioned distillation)")
    p.add_argument("--segment-games", type=int, default=16,
                   help="games per sealed buffer segment (the index "
                        "version granularity)")
    p.add_argument("--buffer-capacity", type=int, default=0,
                   metavar="POSITIONS",
                   help="replay-buffer position bound; oldest segments "
                        "are evicted past it, never across a live "
                        "cursor (0 = unbounded)")
    p.add_argument("--gate-games", type=int, default=64,
                   help="arena games per gate (protocol pins from "
                        "match.standard_gate; production gates want the "
                        "1,000-game pin)")
    p.add_argument("--gate-threshold", type=float, default=0.55,
                   help="challenger win rate required to take the "
                        "champion slot (default 0.55)")
    p.add_argument("--windows", type=int, default=0,
                   help="stop after N completed windows (0 = run "
                        "forever)")
    p.add_argument("--duration", type=float, default=0.0, metavar="S",
                   help="stop after S seconds (0 = no time limit)")
    p.add_argument("--stall-timeout", type=float, default=600.0,
                   metavar="S",
                   help="typed LoopStalled when no ingest/window/gate "
                        "progress lands within S seconds")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="per-replica dispatcher coalescing window")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", action="store_true",
                   help="arm request-scoped tracing: per-request "
                        "timelines through the fleet with tail-exemplar "
                        "sampling streamed to <run-dir>/trace.jsonl — "
                        "`cli trace RUN_DIR ID` renders the waterfalls "
                        "(docs/observability.md)")
    p.add_argument("--telemetry", action="store_true",
                   help="arm the fleet telemetry plane: a background "
                        "sampler appends the registry to "
                        "<run-dir>/ts-NNNN.jsonl (retention-bounded, "
                        "power-of-two downsampled) and the streaming "
                        "anomaly watchlist runs over it — `cli dash "
                        "RUN_DIR` renders the history live "
                        "(docs/observability.md)")
    p.add_argument("--telemetry-interval", type=float, default=1.0,
                   metavar="S",
                   help="telemetry sampling cadence (default 1s)")
    p.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                   help="live /metrics + /healthz (fleet + loop "
                        "progress) for the duration of the run")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="learner ExperimentConfig overrides (model size, "
                        "batch_size, rate, ... — the train grammar)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.set_defaults(fn=cmd_loop)

    p = sub.add_parser("cost", help="device cost ledger: FLOPs / HBM per "
                                    "entrypoint against the card's peak; "
                                    "each entrypoint runs ONCE on "
                                    "--device under the FLOP counter "
                                    "(docs/observability.md)")
    p.add_argument("--model", default="full",
                   help="model config to price (small/medium/full/large; "
                        "default full — the flagship 12L/128)")
    p.add_argument("--buckets", default="1,8,32,128,512",
                   help="serving-ladder rungs to price (CSV)")
    p.add_argument("--train-batch", type=int, default=256, metavar="B",
                   help="batch for the train/eval steps (0 skips "
                        "them — their backward pass dominates the sweep "
                        "on the CPU)")
    p.add_argument("--sym-bucket", type=int, default=8, metavar="B",
                   help="batch for the 8-fold sym-ensemble forward "
                        "(0 skips)")
    p.add_argument("--json", action="store_true",
                   help="emit the roofline block as JSON")
    p.add_argument("--device", default="cuda",
                   help="where every entrypoint runs: " + DEVICE_HELP)
    p.set_defaults(fn=cmd_cost)

    p = sub.add_parser("lint", help="invariant linter over the port: "
                       "atomic-write/determinism/thread/typed-error/"
                       "hot-sync discipline + code<->docs grammar drift "
                       "(docs/static_analysis.md)")
    p.add_argument("paths", nargs="*",
                   help="specific files to lint with every rule in scope "
                        "(default: the configured repo sweep)")
    p.add_argument("--root", default=".",
                   help="repo root the configured sweep runs from")
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings for CI")
    p.add_argument("--no-grammar", action="store_true",
                   help="skip the repo-level code<->docs drift check")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("trace", help="reconstruct one request's waterfall "
                                     "or a champion's lineage chain from "
                                     "a run directory's sampled "
                                     "trace_request / lineage event "
                                     "streams (docs/observability.md)")
    p.add_argument("run_dir")
    p.add_argument("id", nargs="?", default=None,
                   help="a trace-id prefix (request waterfall), "
                        "`champion`, a window number, or a params-digest "
                        "prefix (lineage chain); omit to list what the "
                        "run has")
    p.add_argument("--json", action="store_true",
                   help="emit the raw record/chain as JSON")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("obs", help="offline observability report: one "
                                   "per-stage table (loader wait, "
                                   "dispatch latency, step time, spans, "
                                   "recoveries) joined from a run's "
                                   "JSONL streams")
    p.add_argument("run_dir")
    p.add_argument("--json", action="store_true",
                   help="emit the summary as JSON instead of the table")
    p.set_defaults(fn=cmd_obs)

    p = sub.add_parser("dash", help="live operator dashboard: watchlist "
                                    "sparklines, fleet health grid, "
                                    "anomalies, SLO burn — over a run "
                                    "dir's time-series store or scraped "
                                    "/metrics endpoints "
                                    "(docs/observability.md)")
    p.add_argument("run_dir", nargs="?", default=None,
                   help="run directory holding ts-NNNN.jsonl chunks "
                        "(written by a --telemetry loop run or a bench "
                        "run); omit with --scrape")
    p.add_argument("--scrape", metavar="URL[,URL...]",
                   help="federate these live /metrics endpoints instead "
                        "of reading a store (fleet replicas, elastic "
                        "hosts); each gets a host label, dead endpoints "
                        "are tolerated and flagged")
    p.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="refresh cadence (default 2s)")
    p.add_argument("--window", type=int, default=240, metavar="N",
                   help="samples per sparkline window (default 240)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (CI)")
    p.add_argument("--json", action="store_true",
                   help="emit the frame's underlying dict once as JSON "
                        "(implies --once; schema in "
                        "docs/observability.md)")
    p.set_defaults(fn=cmd_dash)

    p = sub.add_parser("trend", help="bench trajectory: BENCH_r*.json "
                                     "rounds + BENCH_LAST_GOOD.json as "
                                     "one per-metric history table "
                                     "(stale captures marked)")
    p.add_argument("--root", default=".",
                   help="repo root holding the BENCH_r*.json artifacts")
    p.add_argument("--json", action="store_true",
                   help="emit the joined history as JSON")
    p.set_defaults(fn=cmd_trend)

    p = sub.add_parser("workload", help="workload observatory: record a "
                                        "live opening-heavy capture, "
                                        "characterize it (dup ratio, "
                                        "projected cache hit rate), or "
                                        "replay it with open-loop arrival "
                                        "fidelity (docs/observability.md)")
    wsub = p.add_subparsers(dest="wcmd", required=True)

    def _workload_target_args(w) -> None:
        w.add_argument("--fleet", type=int, default=2, metavar="N",
                       help="replicas in the target fleet (default 2)")
        w.add_argument("--model", default="small",
                       help="policy config for a random-init fleet "
                            "(default small)")
        w.add_argument("--checkpoint", default=None,
                       help="serve this checkpoint instead of random init")
        w.add_argument("--max-wait-ms", type=float, default=2.0)
        w.add_argument("--speed", type=float, default=1.0,
                       help="arrival-timeline speedup (1.0 = recorded "
                            "pace, N = N-times faster)")
        w.add_argument("--json", action="store_true")
        w.add_argument("--device", default="cuda", help=DEVICE_HELP)

    w = wsub.add_parser("record", help="drive a live fleet with the "
                                       "synthetic opening-heavy workload "
                                       "and capture it")
    w.add_argument("--out", required=True, metavar="DIR",
                   help="capture directory (workload.jsonl + "
                        "positions.jsonl)")
    w.add_argument("--requests", type=int, default=256)
    w.add_argument("--games", type=int, default=16,
                   help="real games whose openings build the position "
                        "pool")
    w.add_argument("--opening-moves", type=int, default=10,
                   help="plies kept per game (the opening tree depth)")
    w.add_argument("--rate", type=float, default=200.0, metavar="REQ/S",
                   help="Poisson arrival rate of the synthetic trace")
    w.add_argument("--zipf", type=float, default=1.1,
                   help="popularity-skew exponent over move depth")
    w.add_argument("--seed", type=int, default=0,
                   help="the trace is a pure function of this seed")
    w.add_argument("--sgf-dir", default="data/sgf/train")
    w.add_argument("--search", type=int, default=0, metavar="N",
                   help="after the synthetic drive, run N PUCT searches "
                        "rooted at distinct captured positions — the "
                        "capture gains search:<id>-labeled leaf traffic "
                        "and `workload analyze` reports its "
                        "transposition dup ratio")
    w.add_argument("--search-sims", type=int, default=32, metavar="S",
                   help="simulation budget per recorded search")
    _workload_target_args(w)
    w.set_defaults(fn=cmd_workload)

    w = wsub.add_parser("analyze", help="characterization report over a "
                                        "capture: unique/canonical "
                                        "positions, symmetry-dedup gain, "
                                        "popularity skew, burstiness, "
                                        "projected cache hit rate")
    w.add_argument("capture", help="capture directory (or workload.jsonl)")
    w.add_argument("--simulate-cache", default=None, metavar="SIZES",
                   help="replay the capture's key stream through the "
                        "position cache's LRU offline at each capacity "
                        "(comma-separated entry counts) and report the "
                        "ACHIEVED hit rate per size and keying — the "
                        "capacity-planning number next to the projection")
    w.add_argument("--json", action="store_true")
    w.set_defaults(fn=cmd_workload)

    w = wsub.add_parser("replay", help="re-serve a capture against a live "
                                       "fleet at the recorded arrival "
                                       "pace (open loop); exits nonzero "
                                       "when timeline fidelity misses "
                                       "the 10%% bar")
    w.add_argument("capture")
    w.add_argument("--timeout", type=float, default=0.0, metavar="S",
                   help="per-request deadline (0 = none)")
    _workload_target_args(w)
    w.set_defaults(fn=cmd_workload)

    p = sub.add_parser("chaos", help="chaos campaigns: replay an "
                                     "opening-heavy trace against a live "
                                     "fleet while a fault timeline kills, "
                                     "brownouts, and corrupts replicas; "
                                     "grade SLO burn + integrity "
                                     "invariants (docs/robustness.md)")
    csub = p.add_subparsers(dest="ccmd", required=True)

    c = csub.add_parser("run", help="execute one campaign and write the "
                                    "graded JSON report (exits nonzero "
                                    "on a failing grade)")
    c.add_argument("--out", default=None, metavar="FILE",
                   help="write the campaign report JSON here")
    c.add_argument("--scenario", default=None, metavar="FILE",
                   help="scenario JSON (Scenario.to_dict layout); "
                        "default: the --preset timeline scaled to the "
                        "trace span")
    c.add_argument("--preset", default="brownout",
                   choices=["brownout", "full"],
                   help="built-in scenario: 'brownout' (one replica "
                        "slows — the hedging/ejection A/B axis) or "
                        "'full' (kill + brownout + corruption)")
    c.add_argument("--no-defenses", action="store_true",
                   help="disarm hedging/ejection/integrity/canary: the "
                        "A/B control arm")
    c.add_argument("--trace", default=None, metavar="DIR",
                   help="replay this workload capture instead of the "
                        "synthetic opening-heavy trace")
    c.add_argument("--requests", type=int, default=200)
    c.add_argument("--games", type=int, default=16)
    c.add_argument("--rate", type=float, default=45.0, metavar="REQ/S")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--sgf-dir", default="data/sgf/train")
    c.add_argument("--slo-threshold", type=float, default=None,
                   metavar="S",
                   help="interactive latency SLO threshold (default: "
                        "0.15 for a pure brownout, 2.0 once the "
                        "scenario kills or corrupts — the integrity "
                        "campaign is graded on survival)")
    c.add_argument("--slo-target", type=float, default=None,
                   help="fraction of requests that must land within "
                        "the threshold (default 0.95 brownout / 0.5 "
                        "kill+corrupt)")
    c.add_argument("--fleet", type=int, default=2, metavar="N")
    c.add_argument("--model", default="small")
    c.add_argument("--checkpoint", default=None)
    c.add_argument("--max-wait-ms", type=float, default=2.0)
    c.add_argument("--speed", type=float, default=1.0)
    c.add_argument("--json", action="store_true")
    c.add_argument("--device", default="cuda", help=DEVICE_HELP)
    c.set_defaults(fn=cmd_chaos)

    c = csub.add_parser("report", help="re-render and re-grade a stored "
                                       "campaign report")
    c.add_argument("report", help="campaign report JSON from `chaos run`")
    c.add_argument("--json", action="store_true")
    c.set_defaults(fn=cmd_chaos)

    # "selfplay" is forwarded before parsing (above); listed here so it
    # shows up in --help output
    sub.add_parser("selfplay", help="engine-driven batched self-play "
                                    "(flags forward to "
                                    "deepgo_tpu_torch.selfplay, "
                                    "e.g. --games 32 --max-wait-ms 2; "
                                    "--supervised runs the engine under "
                                    "the resilience supervisor)")

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
