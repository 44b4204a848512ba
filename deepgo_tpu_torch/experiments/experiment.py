"""The experiment layer: config -> initialised run -> train, validate,
checkpoint, resume, on one device or over a process group.

The port of ``deepgo_tpu/experiments/experiment.py``:

  * a config with the JAX package's fields, defaults and dict form, written
    into every checkpoint (either package loads the other's runs);
  * a random run id and git-sha provenance;
  * the EWMA (0.95/0.05) training cost folded at print-window boundaries,
    samples/sec prints, JSONL metrics with the JAX records and keys;
  * periodic validation (NLL and top-1 accuracy over a fixed, game-balanced
    set) with a checkpoint at every validation, rolling retention, and
    load-and-continue resume; warm restart is in ``experiments.repeated``.

Parallelism (``parallel/``): inside a ``torch.distributed`` process group
(``parallel.distributed.initialize``; NCCL on the cards, gloo on the CPU)
the run lays the group's ranks out as a ``data_parallel`` x
``tensor_parallel`` mesh (``data_parallel=0``: the group's size over
``tensor_parallel``; 1 without a group). Each data rank trains on its rows
of the step's global batch and the gradients are averaged over "data";
under ``tensor_parallel > 1`` each rank holds its channel shards
(``parallel/tensor.py``); ``zero_opt`` keeps 1/D of the optimizer state
per data rank (``parallel/zero.py``). A layout the group cannot hold
raises ``ConfigError``; a CUDA run in a group is on ``cuda:{local rank}``.
Validation is sharded over the data ranks and its sums all-reduced.
Checkpoints are gathered to full arrays and written by rank 0 alone (the
others wait at a barrier); every rank reads them, and ``load(path,
remesh=...)`` restores under another layout (``parallel/reshard.py``).
``elastic=True`` threads the ``dist_collective`` fault site through the
step; ``parallel/elastic.py`` drives elastic runs.

Observability, as in the JAX package: ``train`` streams its spans
(``validate``, ``checkpoint_save``) to ``<run>/trace.jsonl``, arms the
flight recorder in the run directory, and feeds the attribution histograms
(``obs/attribution.py``); ``profile=True`` captures a torch.profiler trace
of the run into ``<run>/trace``; ``cost_ledger`` prices the train step once
at train start (``obs/costmodel.py``), and a failure to price it prints and
training goes on.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import uuid
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..data.dataset import GoDataset
from ..data.loader import AsyncLoader, to_device
from ..models import policy_cnn
from ..obs import JsonlSink, get_registry, span, trace_to
from ..ops.wire import nibble_pack_np
from ..parallel import data_sharding, distributed, make_mesh, reshard, zero
from ..parallel.liveness import ConfigError
from ..training import make_eval_step, make_train_step, make_train_step_many
from ..training.optimizers import for_config
from ..utils import faults
from ..utils.atomicio import atomic_write
from ..utils.gitinfo import git_sha
from ..utils.metrics import MetricsWriter, append_registry
from ..utils.retry import retry_with_backoff
from . import checkpoint as ckpt

@dataclass(frozen=True)
class ExperimentConfig:
    """The JAX package's ``ExperimentConfig``: the same fields, defaults
    and ``to_dict`` / ``from_dict``. See its comments for each field."""

    name: str = "basic"
    num_layers: int = 3
    channels: int = 64
    channel_schedule: str = ""
    first_kernel: int = 5
    kernel: int = 3
    final_relu: bool = False
    compute_dtype: str = "bfloat16"
    remat: bool = False
    batch_size: int = 32
    rate: float = 0.01
    rate_decay: float = 1e-7
    optimizer: str = "sgd"
    momentum: float = 0.0
    validation_size: int = 2000
    validation_interval: int = 2000
    print_interval: int = 10
    # steps per train call (0 = print_interval on cuda, 1 on the CPU)
    steps_per_call: int = 0
    augment: bool = False
    data_root: str = "data/processed"
    train_split: str = "train"
    validation_split: str = "validation"
    test_split: str = "test"
    scheme: str = "game"
    loader_threads: int = 2
    prefetch: int = 4
    # "auto" = nibble on cuda (half the host-to-device bytes), packed on
    # the CPU (no copy to save)
    wire_format: str = "auto"
    device_prefetch: int = 2
    anchor_checkpoint: str = ""
    anchor_weight: float = 0.0
    data_parallel: int = 0  # 0 = the group's ranks / tensor_parallel
    tensor_parallel: int = 1
    zero_opt: bool = True
    # kept so that configs carry over from the JAX package; nothing reads
    # it: the tensors' device picks the expansion
    expand_backend: str = "xla"
    seed: int = 0
    run_dir: str = "runs"
    profile: bool = False
    cost_ledger: bool = True
    keep_checkpoints: int = 3
    faults: str = ""
    elastic: bool = False

    def model_config(self) -> policy_cnn.ModelConfig:
        channels = self.channels
        if self.channel_schedule:
            channels = tuple(
                int(c) for c in self.channel_schedule.split(",") if c.strip()
            )
        return policy_cnn.ModelConfig(
            num_layers=self.num_layers,
            channels=channels,
            first_kernel=self.first_kernel,
            kernel=self.kernel,
            final_relu=self.final_relu,
            compute_dtype=self.compute_dtype,
            remat=self.remat,
        )

    def replace(self, **overrides) -> "ExperimentConfig":
        return dataclasses.replace(self, **overrides)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class Experiment:
    def __init__(self, config: ExperimentConfig, run_id: str | None = None,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.id = run_id or uuid.uuid4().hex[:8]
        self.step = 0
        self.validation_history: list[dict] = []
        # the EWMA rides in checkpoints so a resumed run's loss curve
        # continues exactly
        self.ewma: float | None = None
        self.last_loss: float = float("nan")
        self.initialized = False
        self.model: policy_cnn.PolicyCNN | None = None
        self.opt_state: dict | None = None
        # placement-check findings of the latest restore (``load``); the
        # elastic recovery record reports their count
        self.last_restore_findings: list = []
        # optional hook called at every print-window boundary, after
        # metrics, validation and checkpointing, with (step,
        # window_seconds, window_steps); an exception raised here (a
        # HostLost from the heartbeat ledger) propagates out of train()
        self.on_window = None

    # ---- setup ----

    def init(self) -> None:
        cfg = self.config
        if cfg.faults and not os.environ.get("DEEPGO_FAULTS"):
            faults.install(cfg.faults)
        self._init_mesh()
        self.wire = cfg.wire_format
        if self.wire == "auto":
            self.wire = "nibble" if self.device.type == "cuda" else "packed"
        if self.wire not in ("nibble", "packed"):
            raise ValueError(f"wire_format must be auto|nibble|packed, "
                             f"got {cfg.wire_format!r}")
        self.model_cfg = cfg.model_config()
        self.placement = reshard.Placement.for_model(
            self.model_cfg, self.mesh, tensor_parallel=cfg.tensor_parallel,
            zero_opt=cfg.zero_opt)
        self.optimizer = self.base_optimizer = for_config(cfg)
        if self.mesh.shape["data"] > 1 and cfg.zero_opt:
            self.optimizer = zero.shard_optimizer(self.optimizer,
                                                  self.placement)
        if self.model is None:
            self.model = policy_cnn.init(
                torch.Generator().manual_seed(cfg.seed), self.model_cfg,
                device=self.device)
        # a full model (and state) -> this rank's shards
        self.model, self.opt_state = reshard.place_state(
            self.model, self.opt_state, self.placement)
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self.model)
        if bool(cfg.anchor_checkpoint) != (cfg.anchor_weight > 0):
            raise ValueError(
                "anchor_checkpoint and anchor_weight > 0 go together: "
                f"got checkpoint={cfg.anchor_checkpoint!r} "
                f"weight={cfg.anchor_weight}")
        anchor = None
        if cfg.anchor_weight > 0:
            from ..models.serving import load_policy

            _, a_model, a_cfg = load_policy(cfg.anchor_checkpoint,
                                            device=self.device)
            anchor = (a_model, a_cfg, cfg.anchor_weight)
        collective_site = "dist_collective" if cfg.elastic else None
        kw = dict(augment=cfg.augment, anchor=anchor, wire=self.wire,
                  collective_site=collective_site, mesh=self.mesh)
        self.train_step = make_train_step(self.model_cfg, self.optimizer,
                                          **kw)
        self.train_step_many = make_train_step_many(self.model_cfg,
                                                    self.optimizer, **kw)
        self.eval_step = make_eval_step(self.model_cfg, wire=self.wire)
        self.run_path = os.path.join(cfg.run_dir, self.id)
        os.makedirs(self.run_path, exist_ok=True)
        self.initialized = True

    def _init_mesh(self) -> None:
        """The (data, model) mesh over the process group (ConfigError when
        the group cannot hold the layout), this rank's device, and the run
        id rank 0 chose."""
        cfg = self.config
        world = distributed.world_size()
        dp = cfg.data_parallel or max(1, world // cfg.tensor_parallel)
        if cfg.batch_size % dp != 0:
            # config validation must survive `python -O`
            raise ValueError(
                f"batch_size {cfg.batch_size} must divide over {dp} "
                "data-parallel devices")
        self.mesh = make_mesh(dp, cfg.tensor_parallel)
        self.rank = distributed.process_index()
        if not dist.is_initialized():
            return
        nccl = dist.get_backend() == "nccl"
        if nccl != (self.device.type == "cuda"):
            raise ConfigError(
                f"a {self.device.type} run in a {dist.get_backend()} group: "
                f"CUDA ranks join over NCCL, CPU ranks over gloo")
        if nccl:
            self.device = distributed.local_device()
        ids = [self.id]
        dist.broadcast_object_list(ids, src=0)
        self.id = ids[0]

    def _dataset(self, split: str) -> GoDataset:
        return GoDataset(self.config.data_root, split)

    # ---- training ----

    def run(self, iters: int) -> dict:
        """Train for ``iters`` steps; returns the run summary record, also
        appended to ``<run_dir>/registry.jsonl``."""
        if iters <= 0:
            raise ValueError(f"iters must be positive, got {iters}")
        if not self.initialized:
            self.init()
        cfg = self.config
        start = time.time()
        summary = self.train(iters)
        summary.update(
            id=self.id,
            name=cfg.name,
            iters=iters,
            total_step=self.step,
            runtime=time.time() - start,
            git_sha=git_sha(),
            config=cfg.to_dict(),
        )
        if self.rank == 0:
            append_registry(os.path.join(cfg.run_dir, "registry.jsonl"),
                            summary)
        return summary

    def train(self, iters: int) -> dict:
        from ..utils.profiling import trace

        if not self.initialized:
            self.init()
        # rank 0 writes the run's metrics.jsonl, trace.jsonl and trace/,
        # every other rank streams of its own
        suffix = "" if self.rank == 0 else f"-rank{self.rank:04d}"
        metrics = MetricsWriter(os.path.join(self.run_path,
                                             f"metrics{suffix}.jsonl"))
        # spans stream for exactly the duration of the run (trace_to
        # restores the previous sink even when training raises)
        trace_sink = JsonlSink(os.path.join(self.run_path,
                                            f"trace{suffix}.jsonl"))
        try:
            with trace_to(trace_sink), trace(
                    os.path.join(self.run_path, f"trace{suffix}")
                    if self.config.profile else None, metrics=metrics):
                return self._train(iters, metrics)
        finally:
            trace_sink.close()
            metrics.close()

    def _data_shard(self) -> tuple[int, int] | None:
        """(data index, data ranks) for the loader; None on one data rank."""
        d = self.mesh.shape["data"]
        return None if d == 1 else (self.mesh.local_index("data"), d)

    def _steps_per_call(self) -> int:
        """Steps K per train call: the largest divisor of print_interval
        <= steps_per_call, so windows end on call boundaries. ``auto`` (0)
        is print_interval on cuda, where one call per window saves host
        work, and 1 on the CPU."""
        cfg = self.config
        want = cfg.steps_per_call
        if want == 0:
            want = cfg.print_interval if self.device.type == "cuda" else 1
        k = max(d for d in range(1, cfg.print_interval + 1)
                if cfg.print_interval % d == 0 and d <= want)
        if k != want:
            print(f"steps_per_call={want} does not divide "
                  f"print_interval={cfg.print_interval}; using {k}")
        return k

    def _train(self, iters: int, metrics: MetricsWriter) -> dict:
        cfg = self.config
        train_set = self._dataset(cfg.train_split)
        reg = get_registry()
        obs_steps = reg.counter(
            "deepgo_train_steps_total", "optimizer steps completed")
        obs_samples = reg.counter(
            "deepgo_train_samples_total", "training samples consumed")
        obs_window = reg.histogram(
            "deepgo_train_window_seconds", "wall time of one print window")
        obs_ewma = reg.gauge(
            "deepgo_train_loss_ewma", "EWMA(0.95/0.05) training cost")
        obs_sps = reg.gauge(
            "deepgo_train_samples_per_sec",
            "samples/sec over the last print window")
        obs_dispatch = reg.histogram(
            "deepgo_train_dispatch_seconds",
            "host time inside the step call (phase=first carries the "
            "first call's set-up)")
        obs_fetch = reg.histogram(
            "deepgo_train_fetch_seconds",
            "host time blocked fetching window losses (the device fence)")
        # the attribution's liveness bucket; part=window keeps the
        # boundary's bookkeeping out of the untimed residual
        obs_hook = reg.histogram(
            "deepgo_train_hook_seconds",
            "window-boundary host time: the window hook (heartbeat write + "
            "liveness checks); part=window the metrics lines, progress "
            "print and flight-recorder tick")
        obs_wall = reg.counter(
            "deepgo_train_wall_seconds_total",
            "train-loop wall time: the attribution denominator")
        # the crash flight recorder dumps into the run directory (kills,
        # restarts, SLO fast burns); an earlier configuration (an elastic
        # run's shared directory) is kept
        from ..obs.sentinel import configure_flight, get_flight_recorder

        flight = get_flight_recorder()
        if not flight.enabled:
            flight = configure_flight(self.run_path)
        if cfg.cost_ledger:
            self._price_train_step(reg, metrics)
        called: set = set()  # phase=first vs phase=steady
        val_batches = self._validation_batches()

        k_steps = self._steps_per_call()
        use_many = k_steps > 1
        ewma = self.ewma
        last_loss = self.last_loss
        last_val: dict = {}
        pending: list = []  # device-resident losses of the open window

        def fold_pending(ewma, last_loss):
            # EWMA 0.95/0.05 (reference train.lua:115), one host fetch per
            # call at window boundaries only: the fetch is the window's
            # device fence
            t0 = time.monotonic()
            for losses in pending:
                # lint: allow[hot-sync] window-boundary fetch is the declared materialization point (one copy back per window)
                for value in losses.reshape(-1).cpu().numpy().tolist():
                    ewma = value if ewma is None else 0.95 * ewma + 0.05 * value
                    last_loss = value
            if pending:
                obs_fetch.observe(time.monotonic() - t0)
            pending.clear()
            self.ewma, self.last_loss = ewma, last_loss
            return ewma, last_loss

        def timed_step(step_fn, program, batch):
            phase = "steady" if program in called else "first"
            t0 = time.monotonic()
            try:
                self.model, self.opt_state, losses = step_fn(
                    self.model, self.opt_state, batch)
                return losses
            finally:
                called.add(program)
                obs_dispatch.observe(time.monotonic() - t0, phase=phase)

        def dump_bad(batch):
            # the failing (super)batch, kept for offline debugging
            # lint: allow[hot-sync] crash-path postmortem dump: the step already failed, there is no pipeline left to stall
            bad = {k_: v.cpu().numpy() for k_, v in batch.items()}
            with atomic_write(
                    os.path.join(self.run_path, "bad_batch.npz")) as f:
                np.savez(f, **bad)

        def run_call(step_fn, program, batch, k):
            try:
                faults.check("train_step")
                losses = timed_step(step_fn, program, batch)
            except Exception:
                dump_bad(batch)
                raise
            pending.append(losses)
            self.step += k
            obs_steps.inc(k)
            obs_samples.inc(k * cfg.batch_size)
            faults.check("kill", step=self.step)

        window_t0 = total_t0 = time.time()
        with AsyncLoader(
            train_set,
            cfg.batch_size,
            scheme=cfg.scheme,
            # sync mode is step-indexed: a resume replays the
            # uninterrupted run's batches bitwise
            seed=cfg.seed,
            start_step=self.step,
            num_threads=cfg.loader_threads,
            prefetch=cfg.prefetch,
            device=self.device,
            stack=k_steps if use_many else 0,
            augment=cfg.augment,
            wire=self.wire,
            device_prefetch=cfg.device_prefetch,
            shard=self._data_shard(),
        ) as loader:
            try:
                remaining = iters
                window_steps = 0
                while remaining > 0:
                    # realign to print-window boundaries first: a resume
                    # can start mid-window
                    align = (-self.step) % cfg.print_interval
                    k = min(k_steps, remaining, align or k_steps)
                    if k == k_steps and use_many:
                        run_call(self.train_step_many, "many", loader.get(),
                                 k)
                    else:
                        # alignment and tail remainders step singly
                        for _ in range(k):
                            run_call(self.train_step, "single",
                                     loader.get(stack=0), 1)
                    remaining -= k
                    window_steps += k
                    if self.step % cfg.print_interval == 0:
                        ewma, last_loss = fold_pending(ewma, last_loss)
                        window_dt = time.time() - window_t0
                        window_t0 = time.time()
                        sps = window_steps * cfg.batch_size / window_dt
                        done_steps, window_steps = window_steps, 0
                        with obs_hook.time(part="window"):
                            metrics.write("train", step=self.step,
                                          loss=last_loss, ewma=ewma,
                                          samples_per_sec=sps)
                            obs_window.observe(window_dt)
                            obs_ewma.set(ewma)
                            obs_sps.set(sps)
                        validated = self.step % cfg.validation_interval == 0
                        if validated:
                            with span("validate", step=self.step):
                                last_val = self.validate(val_batches)
                            with span("checkpoint_save", step=self.step):
                                self._save_periodic()
                        with obs_hook.time(part="window"):
                            if validated:
                                metrics.write("validation", step=self.step,
                                              **last_val)
                                print(f"validation at iteration {self.step}: "
                                      f"cost={last_val['cost']:.4f}, "
                                      f"accuracy={last_val['accuracy']:.4f}")
                            else:
                                print(f"training {ewma:.4f} (samples per "
                                      f"second {sps:.0f})")
                            # one registry snapshot per print window keeps
                            # the flight recorder's ring current (a no-op
                            # unarmed)
                            flight.tick()
                        # the elastic hook last, after the periodic
                        # checkpoint: a HostLost raised here finds the
                        # newest checkpoint already on disk
                        if self.on_window is not None:
                            t_hook = time.monotonic()
                            self.on_window(self.step, window_dt, done_steps)
                            obs_hook.observe(time.monotonic() - t_hook)
                # a final partial window still folds into the EWMA
                ewma, last_loss = fold_pending(ewma, last_loss)
            finally:
                obs_wall.inc(time.time() - total_t0)
        total_dt = time.time() - total_t0
        total_sps = cfg.batch_size * iters / total_dt
        print(f"total samples per second {total_sps:.0f}")
        metrics.write("summary", step=self.step, ewma=ewma,
                      total_samples_per_sec=total_sps)
        metrics.write("obs_snapshot", metrics=reg.snapshot()["metrics"])
        return {
            "final_ewma": ewma,
            "samples_per_sec": total_sps,
            "last_validation": last_val,
        }

    def _price_train_step(self, reg, metrics) -> None:
        """Price this run's train step once (``costmodel.train_entry``: one
        step of a fresh model under the FLOP counter, before the loop's
        wall clock starts); the ledger gauges ride the close-time
        ``obs_snapshot``, so the offline attribution reports MFU. A
        failure prints and training goes on without an MFU row."""
        from ..obs import costmodel

        try:
            ledger = costmodel.CostLedger(registry=reg, sink=metrics,
                                          device=self.device)
            costmodel.train_entry(
                ledger, self.model_cfg, self.config.batch_size,
                optimizer=self.base_optimizer, wire=self.wire,
                augment=self.config.augment)
            costmodel.set_cost_ledger(ledger)
        except Exception as e:  # noqa: BLE001 — observability never blocks
            print(f"cost ledger: skipped ({e!r})", flush=True)

    # ---- validation / evaluation ----

    def _validation_batches(self) -> list[dict]:
        cfg = self.config
        try:
            val_set = self._dataset(cfg.validation_split)
        except FileNotFoundError:
            return []
        n = min(cfg.validation_size, len(val_set))
        return self._deterministic_batches(val_set, n)

    def _deterministic_batches(self, dataset: GoDataset, n: int
                               ) -> list[dict]:
        """Fixed, game-balanced sample of a split (``even_n``), padded to
        whole batches with a float mask, on the device: this data rank's
        rows of each."""
        cfg = self.config
        packed, player, rank, target = dataset.even_n(n)
        if self.wire == "nibble":
            packed = nibble_pack_np(packed)
        batches = []
        bs = cfg.batch_size
        for i in range(0, n, bs):
            chunk = slice(i, min(i + bs, n))
            size = chunk.stop - chunk.start
            pad = bs - size
            batch = {
                "packed": np.pad(packed[chunk],
                                 ((0, pad),) + ((0, 0),) * (packed.ndim - 1)),
                "player": np.pad(player[chunk], (0, pad), constant_values=1),
                "rank": np.pad(rank[chunk], (0, pad), constant_values=1),
                "target": np.pad(target[chunk], (0, pad)),
                "mask": np.pad(np.ones(size, np.float32), (0, pad)),
            }
            rows = data_sharding(self.mesh)
            batches.append(to_device({k: rows.take(v) for k, v in
                                      batch.items()}, self.device))
        return batches

    def validate(self, val_batches: list[dict] | None = None,
                 record_history: bool = True) -> dict:
        """Mean NLL and top-1 accuracy over the fixed validation set; the
        data ranks' sums are all-reduced. ``record_history`` appends to
        validation_history (which checkpoints keep); one-off evaluations
        pass False."""
        if val_batches is None:
            if not self.initialized:
                self.init()
            val_batches = self._validation_batches()
        if not val_batches:
            return {"cost": float("nan"), "accuracy": float("nan"), "n": 0}
        total_nll = total_correct = total_n = 0.0
        for batch in val_batches:
            sum_nll, correct = self.eval_step(self.model, batch)
            total_nll += float(sum_nll)
            total_correct += float(correct)
            total_n += float(batch["mask"].sum())
        group = self.mesh.group("data")
        if group is not None:
            sums = torch.tensor([total_nll, total_correct, total_n],
                                dtype=torch.float64, device=self.device)
            dist.all_reduce(sums, group=group)
            total_nll, total_correct, total_n = sums.tolist()
        record = {
            "cost": total_nll / total_n,
            "accuracy": total_correct / total_n,
            "n": int(total_n),
        }
        if record_history:
            self.validation_history.append({"step": self.step, **record})
        return record

    def evaluate(self, split: str | None = None, limit: int | None = None
                 ) -> dict:
        """Deterministic evaluation over a whole split (or its first
        ``limit`` even-spread positions)."""
        if not self.initialized:
            self.init()
        dataset = self._dataset(split or self.config.test_split)
        n = len(dataset) if limit is None else min(limit, len(dataset))
        batches = self._deterministic_batches(dataset, n)
        return self.validate(batches, record_history=False)

    # ---- checkpointing ----

    def save(self, path: str | None = None) -> str:
        """Write one atomic, integrity-checked checkpoint in the JAX
        package's format. With no ``path`` the run directory gets a rolling
        ``checkpoint-{step:08d}.npz``, the ``checkpoint.npz`` alias is
        refreshed and retention prunes old files. Every rank of the mesh
        calls it: the shards are gathered to full arrays, rank 0 writes,
        and the others wait for it at a barrier."""
        managed = path is None
        path = path or os.path.join(self.run_path,
                                    ckpt.checkpoint_name(self.step))
        state = reshard.gather_to_host(self.model, self.opt_state,
                                       self.placement)
        try:
            if self.rank == 0:
                self._write(path, *state, managed=managed)
        finally:
            self._barrier()
        return path

    def _write(self, path: str, params, opt_state, managed: bool) -> None:
        meta = {
            "id": self.id,
            "step": self.step,
            "validation_history": self.validation_history,
            "ewma": self.ewma,
            "last_loss": self.last_loss,
            "config": self.config.to_dict(),
            "git_sha": git_sha(),
            # the layout that wrote it; a restore under any other reshards
            "mesh": reshard.manifest(
                self.mesh, params, opt_state, zero_opt=self.config.zero_opt,
                tensor_parallel=self.config.tensor_parallel),
        }
        ckpt.save_checkpoint(path, params, opt_state, meta)
        if managed:
            self._refresh_latest_alias(path)
            self._apply_retention()

    def _barrier(self) -> None:
        if self.mesh.device_mesh is not None:
            dist.barrier()

    def _save_periodic(self) -> str | None:
        """The in-loop save: transient I/O faults of the write are retried,
        and a save that still fails is logged and survived (the previous
        rolling checkpoint is still on disk and valid)."""
        path = os.path.join(self.run_path, ckpt.checkpoint_name(self.step))
        state = reshard.gather_to_host(self.model, self.opt_state,
                                       self.placement)
        try:
            if self.rank == 0:
                retry_with_backoff(
                    lambda: self._write(path, *state, managed=True),
                    attempts=3, base_delay=0.1)
            return path
        except (OSError, RuntimeError) as e:
            print(f"warning: checkpoint save failed at step {self.step} "
                  f"({e}); training continues on the previous checkpoint",
                  file=sys.stderr, flush=True)
            return None
        finally:
            self._barrier()

    def _refresh_latest_alias(self, path: str) -> None:
        """Best-effort ``checkpoint.npz`` symlink to the newest rolling
        checkpoint; a real ``checkpoint.npz`` file is left alone."""
        alias = os.path.join(self.run_path, "checkpoint.npz")
        if os.path.lexists(alias) and not os.path.islink(alias):
            return
        tmp = alias + ".lnk"
        try:
            if os.path.lexists(tmp):
                os.unlink(tmp)
            os.symlink(os.path.basename(path), tmp)
            os.replace(tmp, alias)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _apply_retention(self) -> None:
        """Keep the newest ``keep_checkpoints`` rolling checkpoints plus the
        best-validation step (lowest cost); 0 keeps everything."""
        keep = self.config.keep_checkpoints
        if keep <= 0:
            return
        entries = ckpt.list_checkpoints(self.run_path)
        keep_steps = {s for s, _ in entries[-keep:]}
        finite = [r for r in self.validation_history
                  if np.isfinite(r.get("cost", float("nan")))]
        if finite:
            keep_steps.add(min(finite, key=lambda r: r["cost"])["step"])
        for s, p in entries:
            if s not in keep_steps:
                try:
                    os.remove(p)
                except OSError:
                    pass

    def _restore(self, p_leaves, o_leaves, path: str) -> None:
        """Load full checkpoint leaves into this rank's shards of the
        initialised model and optimizer state (a reshard when the layout
        differs from the writer's); raises CheckpointError when they do not
        fit. The placement check's findings land on
        ``last_restore_findings``."""
        params_t, opt_t = reshard.full_templates(self.placement,
                                                 self.opt_state)
        params = ckpt.unflatten_like(params_t, p_leaves, path)
        opt_state = (None if o_leaves is None
                     else ckpt.unflatten_like(opt_t, o_leaves, path))
        named, state, self.last_restore_findings = reshard.restore(
            params, opt_state, self.placement, self.device)
        self.model.load_state_dict(named)
        if state is not None:
            self.opt_state = state

    @classmethod
    def load(cls, path: str, device="cuda", remesh: dict | None = None
             ) -> "Experiment":
        """Rebuild an experiment from a checkpoint (the port's or the JAX
        package's) and continue it on ``device``. ``remesh`` overrides the
        stored parallelism layout (e.g. ``{"tensor_parallel": 1}``
        restores a tp = 2 checkpoint on a tp = 1 mesh); the restore puts
        the leaves where a fresh ``init()`` under the new layout puts
        them."""
        meta, p_leaves, o_leaves = ckpt.load_checkpoint(path)
        config = ExperimentConfig.from_dict(meta["config"])
        if remesh:
            config = config.replace(**remesh)
        exp = cls(config, run_id=meta["id"], device=device)
        exp.step = meta["step"]
        exp.validation_history = list(meta["validation_history"])
        exp.ewma = meta.get("ewma")
        last_loss = meta.get("last_loss")
        exp.last_loss = float("nan") if last_loss is None else last_loss
        exp.init()
        exp._restore(p_leaves, o_leaves, path)
        return exp

    @classmethod
    def auto_resume(cls, run_dir: str, overrides: dict | None = None,
                    log=None, device="cuda", remesh: dict | None = None
                    ) -> "Experiment":
        """Continue from the newest valid checkpoint in ``run_dir``
        (corrupt candidates are skipped with a logged reason), or start a
        fresh run rooted at exactly that directory. On resume the stored
        config wins over ``overrides``; ``remesh`` is the one sanctioned
        exception, a parallelism-layout change applied through the
        resharding restore."""
        path = ckpt.find_latest_valid(run_dir, log=log)
        if path is not None:
            if overrides:
                print(f"auto-resume: ignoring overrides {sorted(overrides)} "
                      f"(config comes from {path})", file=sys.stderr)
            return cls.load(path, device=device, remesh=remesh)
        run_dir = run_dir.rstrip("/")
        parent, run_id = os.path.split(run_dir)
        config = ExperimentConfig(**{**(overrides or {}), **(remesh or {})})
        config = config.replace(run_dir=parent or ".")
        return cls(config, run_id=run_id or None, device=device)
