"""The always-on expert-iteration service: the loop that runs forever.

The port of ``deepgo_tpu/loop/service.py``: the same components, config
and supervision, on ``device`` (``cuda`` unless asked for the CPU). The
fleet serves the champion from a module of its own; the learner trains
another, loaded from the same checkpoint, and the fleet takes the
learner's weights only through a gate pass's ``reload``. The telemetry
plane (``telemetry=True``) waits for the port of ``obs/timeseries`` and
``obs/anomaly``.

``ExpertIterationLoop`` wires the four components into one supervised,
long-running pipeline — the unification of ``tools/r5_value_loop.sh``'s
hand-sequenced stages into a service where (FireCaffe's framing,
arXiv:1511.00175) every component stays saturated concurrently instead
of barrier-stepping through phases:

    actors ──games──▶ replay buffer ──windows──▶ learner
      ▲                                             │ challenger ckpt
      │  fleet.reload (champion hot-swap)           ▼
    serving fleet ◀──publish+reload── arena gatekeeper

  * N selfplay actors submit boards on the fleet's ``selfplay`` tier and
    durably ingest finished games (loop/actors.py);
  * the replay buffer seals games into window-versioned segments while
    the learner reads (loop/replay.py);
  * the continuous learner trains a window per cycle over a frozen,
    cursor-pinned extent and atomically publishes each window's
    challenger checkpoint (loop/learner.py — bit-exact auto-resume);
  * the arena gatekeeper promotes a challenger only on a >= 55% win rate
    against the incumbent, then hot-reloads the fleet in place
    (loop/gatekeeper.py).

Every component runs under the same restart discipline the serving
supervisor established: a component crash is caught, counted,
logged as a ``loop_restart`` event, backed off with bounded full jitter,
and re-run — the actor replays its round, the learner auto-resumes
bit-exactly from its checkpoint + cursor, the gatekeeper re-gates the
re-queued challenger. A component that exhausts its restart budget stops
the loop with its error recorded; ``GateRejected`` is a counted outcome,
never a restart. Progress is watched: a loop where nothing has been
ingested, trained, or gated inside ``stall_timeout_s`` raises a typed
``LoopStalled``.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import random
import threading
import time

import torch

from .. import resolve_device
from ..experiments import ExperimentConfig
from ..experiments import checkpoint as ckpt
from ..models import policy_cnn
from ..models.convert import opt_state_to_jax, params_to_jax
from ..models.serving import load_policy
from ..obs import get_registry
from ..serving import (EngineConfig, FleetConfig, SupervisorConfig,
                       fleet_policy_engine, ladder_for)
from ..serving.resilience import full_jitter_delay
from ..training.optimizers import for_config
from ..utils.metrics import MetricsWriter
from .actors import SelfplayActor
from .gatekeeper import ArenaGatekeeper, GateRejected, publish_checkpoint
from .learner import ContinuousLearner, LoopStalled, params_digest
from .replay import ReplayBuffer, count_durable_games

CHAMPION_NAME = "champion.npz"
CHALLENGER_NAME = "challenger.npz"


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Knobs for one ExpertIterationLoop (the learner's model/optimizer
    knobs ride in an ExperimentConfig, same override grammar as train)."""

    actors: int = 2
    fleet: int = 2
    games_per_round: int = 8
    max_moves: int = 120
    temperature: float = 0.25
    rank: int = 8
    komi: float = 7.5
    # actors: search_sims > 0 = AlphaZero-style search-selfplay (each
    # move a PUCT search over the fleet's selfplay tier; docs/search.md)
    search_sims: int = 0
    # learner
    steps_per_window: int = 50
    min_window_positions: int = 512
    scheme: str = "game"
    keep_checkpoints: int = 0  # 0 = keep all (offline window replay needs
    #                            window-start checkpoints)
    # buffer
    segment_games: int = 16
    capacity_positions: int = 0
    # gate
    gate_games: int = 32
    gate_threshold: float = 0.55
    gate_through_fleet: bool = True
    # run shape
    windows: int = 0          # stop after N completed windows (0 = forever)
    duration_s: float = 0.0   # stop after S seconds (0 = no time limit)
    # supervision
    max_component_restarts: int = 8
    restart_base_s: float = 0.05
    restart_cap_s: float = 2.0
    stall_timeout_s: float = 600.0
    # chaos: replica supervisors' restart budget (None = supervisor
    # default; the chaos soak passes 0 so a dispatcher kill crosses into
    # the FLEET failure domain — failover + respawn — like bench --fleet)
    replica_max_restarts: int | None = None
    max_wait_ms: float = 2.0
    seed: int = 0
    # request-scoped tracing (obs/tracing.py): arm the exemplar sampler
    # over the fleet's serving path, streaming trace_request records to
    # <run_dir>/trace.jsonl
    trace: bool = False
    # the fleet telemetry plane (obs/timeseries.py + obs/anomaly.py of
    # the JAX package): not ported yet, so True raises
    telemetry: bool = False
    telemetry_interval_s: float = 1.0


class ExpertIterationLoop:
    """Supervisor + wiring for the four loop components.

    ``run_dir`` owns everything durable: ``buffer/`` (the replay buffer),
    ``learner/`` (rolling checkpoints + cursor + windows.jsonl),
    ``champion.npz`` (what the fleet serves; the ``cli serve --watch``
    hook in a split deployment), ``challenger.npz`` (the learner's latest
    publish), ``loop.jsonl`` (the event stream). Re-running the identical
    command over the same run_dir resumes the loop from wherever any
    number of kills left it."""

    def __init__(self, run_dir: str, config: LoopConfig | None = None,
                 learner_config: ExperimentConfig | None = None,
                 seed_checkpoint: str | None = None, device="cuda"):
        self.config = config or LoopConfig()
        if self.config.telemetry:
            raise ValueError(
                "telemetry=True needs obs/timeseries and obs/anomaly, which "
                "are not ported yet: it waits for ROADMAP A7 "
                "(observability adapters)")
        self.device = resolve_device(device)
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.champion_path = os.path.join(run_dir, CHAMPION_NAME)
        self.challenger_path = os.path.join(run_dir, CHALLENGER_NAME)
        self.metrics = MetricsWriter(os.path.join(run_dir, "loop.jsonl"))
        self._trace_sink = None
        if self.config.trace:
            from ..obs import JsonlSink, configure_tracing

            self._trace_sink = JsonlSink(os.path.join(run_dir,
                                                      "trace.jsonl"))
            configure_tracing(sink=self._trace_sink)
        self._stop = threading.Event()
        self._learner_done = threading.Event()
        self._gate_queue: queue.Queue = queue.Queue()
        self._rng = random.Random(self.config.seed)
        self._lock = threading.Lock()
        self.restarts: dict[str, int] = {}
        self.fatal: dict[str, str] = {}
        self.gates_rejected = 0
        self._progress = time.monotonic()
        reg = get_registry()
        self._obs_restarts = reg.counter(
            "deepgo_loop_component_restarts_total",
            "loop component crashes absorbed by the supervisor")
        self._obs_stalls = reg.counter(
            "deepgo_loop_stalls_total",
            "typed LoopStalled events (a stage starved past its budget)")

        lcfg = learner_config or ExperimentConfig(name="loop-learner")
        bootstrap_source = self._ensure_champion(lcfg, seed_checkpoint)
        # the fleet's own module: the learner never trains it in place
        _, self._champ_params, self._model_cfg = load_policy(
            self.champion_path, device=self.device)
        if bootstrap_source is not None:
            # the provenance chain's root for a brand-new run: a champion
            # that was NOT earned through a gate (seed checkpoint or
            # fresh init)
            self.metrics.write(
                "lineage_champion", digest=params_digest(self._champ_params),
                step=ckpt.load_meta(self.champion_path).get("step"),
                path=self.champion_path, source=bootstrap_source)
        cfg = self.config
        sup = (None if cfg.replica_max_restarts is None
               else SupervisorConfig(max_restarts=cfg.replica_max_restarts,
                                     backoff_base_s=0.01,
                                     backoff_cap_s=0.1))
        self.fleet = fleet_policy_engine(
            self._champ_params, self._model_cfg, replicas=cfg.fleet,
            config=EngineConfig(
                buckets=ladder_for(cfg.games_per_round * cfg.actors).buckets,
                max_wait_ms=cfg.max_wait_ms),
            fleet=FleetConfig(default_tier="selfplay"),
            supervisor=sup, metrics=self.metrics, name="loop-fleet",
            device=self.device)
        self.buffer = ReplayBuffer(
            os.path.join(run_dir, "buffer"),
            segment_games=cfg.segment_games,
            capacity_positions=cfg.capacity_positions, metrics=self.metrics)
        self.learner = ContinuousLearner(
            self.buffer, os.path.join(run_dir, "learner"), lcfg,
            steps_per_window=cfg.steps_per_window,
            min_window_positions=cfg.min_window_positions,
            scheme=cfg.scheme, publish_path=self.challenger_path,
            seed_checkpoint=self.champion_path,
            stall_timeout_s=cfg.stall_timeout_s,
            keep_checkpoints=cfg.keep_checkpoints, metrics=self.metrics,
            device=self.device)
        self.gatekeeper = ArenaGatekeeper(
            self.champion_path, games=cfg.gate_games,
            threshold=cfg.gate_threshold, max_moves=cfg.max_moves,
            komi=cfg.komi, fleet=self.fleet,
            engine=self.fleet if cfg.gate_through_fleet else None,
            metrics=self.metrics, device=self.device)
        self.actors = [
            SelfplayActor(i, self.buffer, self.fleet,
                          games_per_round=cfg.games_per_round,
                          max_moves=cfg.max_moves,
                          temperature=cfg.temperature, rank=cfg.rank,
                          komi=cfg.komi, seed=cfg.seed,
                          metrics=self.metrics,
                          search_sims=cfg.search_sims)
            for i in range(cfg.actors)
        ]

    # -- bootstrap ---------------------------------------------------------

    def _ensure_champion(self, lcfg: ExperimentConfig,
                         seed_checkpoint: str | None) -> str | None:
        """The loop needs an incumbent before anything runs: an existing
        champion.npz wins (the loop is resuming), else the seed
        checkpoint is published into the slot, else a fresh random init
        (step 0 — any trained challenger should eventually beat it).
        Returns the bootstrap source ("seed" / "init") when a NEW
        champion was published, None on resume — the lineage root
        event is only written for champions this call created."""
        if os.path.exists(self.champion_path):
            ckpt.verify_checkpoint(self.champion_path)
            return None
        if seed_checkpoint:
            ckpt.verify_checkpoint(seed_checkpoint)
            publish_checkpoint(seed_checkpoint, self.champion_path)
            return "seed"
        # drawn on the CPU: the file is the same whatever the device
        model = policy_cnn.init(torch.Generator().manual_seed(lcfg.seed),
                                lcfg.model_config(), device="cpu")
        ckpt.save_checkpoint(self.champion_path, params_to_jax(model),
                             opt_state_to_jax(for_config(lcfg).init(model)),
                             {
                                 "id": "loop-seed", "step": 0,
                                 "validation_history": [],
                                 "config": lcfg.to_dict(),
                             })
        return "init"

    # -- supervision -------------------------------------------------------

    def _note_progress(self) -> None:
        with self._lock:
            self._progress = time.monotonic()

    def _supervised(self, name: str, body) -> None:
        """Run one component body under the loop restart discipline."""
        attempts = 0
        while not self._stop.is_set():
            try:
                body()
                return  # clean completion (learner hit its window target)
            except Exception as e:  # noqa: BLE001 — the supervisor's job
                if self._stop.is_set():
                    return
                attempts += 1
                with self._lock:
                    self.restarts[name] = self.restarts.get(name, 0) + 1
                self._obs_restarts.inc(1, component=name.split("-")[0])
                if isinstance(e, LoopStalled):
                    self._obs_stalls.inc(1)
                self.metrics.write("loop_restart", component=name,
                                   attempt=attempts,
                                   error=f"{type(e).__name__}: {e}")
                if attempts > self.config.max_component_restarts:
                    with self._lock:
                        self.fatal[name] = f"{type(e).__name__}: {e}"
                    self.metrics.write("loop_fatal", component=name,
                                       error=f"{type(e).__name__}: {e}")
                    self._stop.set()
                    return
                time.sleep(full_jitter_delay(
                    attempts - 1, self.config.restart_base_s,
                    self.config.restart_cap_s, self._rng))

    # -- component bodies --------------------------------------------------

    def _actor_body(self, actor: SelfplayActor):
        def body() -> None:
            while not self._stop.is_set() and not self._learner_done.is_set():
                actor.run_round()
                self._note_progress()
        return body

    def _learner_body(self) -> None:
        # auto-resume from disk FIRST: after a mid-window crash the
        # in-memory params are ahead of the durable truth; the checkpoint
        # + cursor replay the interrupted window bit-exactly
        self.learner.reload_state()
        target = self.config.windows
        while not self._stop.is_set():
            if target and self.learner.window >= target:
                break
            record = self.learner.train_window(stop=self._stop)
            if record is None:  # stop fired mid-window
                return
            self._note_progress()
            self._gate_queue.put((record["window"], self.challenger_path))
        self._learner_done.set()

    def _gatekeeper_body(self) -> None:
        while True:
            try:
                window, path = self._gate_queue.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    return
                if self._learner_done.is_set():
                    return  # queue drained, nothing more is coming
                continue
            try:
                self.gatekeeper.evaluate(path)
            except GateRejected as e:
                # a counted outcome, not a crash: the incumbent keeps
                # serving, the next window gets its own gate
                with self._lock:
                    self.gates_rejected += 1
                self.metrics.write("loop_gate_rejected", window=window,
                                   win_rate=round(e.win_rate, 4))
            except Exception:
                # crash mid-gate (injected loop_gate fault, a wedged
                # match): re-queue the challenger so the restarted
                # component re-gates it instead of dropping the window
                self._gate_queue.put((window, path))
                raise
            self._note_progress()

    # -- the run -----------------------------------------------------------

    def run(self) -> dict:
        """Start every component, watch progress, return the summary.

        Stops when: the learner reached ``config.windows`` and the gate
        queue drained; ``config.duration_s`` elapsed; ``stop()`` was
        called; or a component went fatal. Either way every thread is
        joined, the fleet is closed, and the summary is both returned
        and written as the ``loop_close`` event."""
        cfg = self.config
        self.fleet.warmup()
        self.metrics.write(
            "loop_start", actors=cfg.actors, fleet=cfg.fleet,
            steps_per_window=cfg.steps_per_window, windows=cfg.windows,
            gate_games=cfg.gate_games, gate_threshold=cfg.gate_threshold,
            resumed_from=self.learner.resumed_from,
            buffer=self.buffer.stats())
        threads = [
            threading.Thread(target=self._supervised,
                             args=(f"actor-{a.actor_id}",
                                   self._actor_body(a)),
                             name=f"loop-actor-{a.actor_id}", daemon=True)
            for a in self.actors
        ]
        threads.append(threading.Thread(
            target=self._supervised, args=("learner", self._learner_body),
            name="loop-learner", daemon=True))
        threads.append(threading.Thread(
            target=self._supervised,
            args=("gatekeeper", self._gatekeeper_body),
            name="loop-gatekeeper", daemon=True))
        t0 = time.monotonic()
        for t in threads:
            t.start()
        try:
            while any(t.is_alive() for t in threads):
                if self._stop.is_set():
                    break
                if cfg.duration_s and time.monotonic() - t0 >= cfg.duration_s:
                    self._stop.set()
                    break
                if (self._learner_done.is_set()
                        and not threads[-1].is_alive()):
                    break  # windows target met and the gate queue drained
                with self._lock:
                    idle = time.monotonic() - self._progress
                if idle > cfg.stall_timeout_s:
                    self._obs_stalls.inc(1)
                    self.metrics.write("loop_stall", idle_s=round(idle, 1))
                    self._stop.set()
                    self.fatal["loop"] = (
                        f"LoopStalled: no ingest/window/gate progress for "
                        f"{idle:.0f}s")
                    break
                self.gatekeeper.champion_age_s()
                time.sleep(0.05)
        finally:
            self._stop.set()
            self._learner_done.set()
            for t in threads:
                t.join(timeout=30)
            summary = self.summary()
            summary["seconds"] = round(time.monotonic() - t0, 3)
            if self._trace_sink is not None:
                from ..obs import get_trace_recorder

                rec = get_trace_recorder()
                if rec is not None:
                    summary["tracing"] = rec.stats()
            self.metrics.write("loop_close", **summary)
            self.fleet.close()
            if self._trace_sink is not None:
                self._trace_sink.close()
            self.metrics.close()
        if self.fatal.get("loop", "").startswith("LoopStalled"):
            raise LoopStalled(self.fatal["loop"])
        return summary

    def stop(self) -> None:
        self._stop.set()

    def summary(self) -> dict:
        """Accounting snapshot. ``games_durable`` is re-read from the
        on-disk index — the acked-vs-durable comparison is the zero-
        lost-games proof the chaos soak asserts."""
        acked = sum(a.games_acked for a in self.actors)
        fleet_stats = self.fleet.stats()["fleet"]
        champ_step = None
        try:
            champ_step = ckpt.load_meta(self.champion_path).get("step")
        except ckpt.CheckpointError:
            pass
        return {
            "games_acked": acked,
            "games_durable": count_durable_games(self.buffer.dir),
            "windows_trained": self.learner.window,
            "learner_step": self.learner.step,
            "gates_passed": self.gatekeeper.gates_passed,
            "gates_rejected": self.gates_rejected,
            "champion_step": champ_step,
            "component_restarts": dict(self.restarts),
            "fleet_respawns": fleet_stats["respawns"],
            "fleet_failovers": fleet_stats["failovers"],
            "fleet_reloads": fleet_stats["reloads"],
            "buffer": self.buffer.stats(),
            "fatal": dict(self.fatal),
        }
