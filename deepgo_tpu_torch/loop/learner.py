"""Continuous learner: windowed training over the live replay buffer.

The port of ``deepgo_tpu/loop/learner.py``, on the port's train step
(``training.make_train_step``: the expansion kernel on the card) and its
step-indexed stream (``data.loader.make_step_batch``).

Trains forever in *windows* of K steps. At each window start the learner
freezes the buffer's sealed extent and durably records a **read cursor**
(``cursor.json``, written atomically BEFORE the first step of the
window); each step's batch is then a pure function of
``(seed, step, extent)`` over the frozen ``ReplayView``. That one ordering
rule is the whole bit-exact-resume story for a growing corpus:

  * killed mid-window -> the newest checkpoint sits at the window's start
    step and the cursor pins the extent the window was using, so the
    resume retrains the window over the identical byte range, whatever
    the actors sealed in the meantime;
  * killed between a window's checkpoint and the next cursor write -> the
    resume freezes a fresh extent, exactly as the uninterrupted run would
    have at that same point in the ingestion schedule.

Each completed window atomically publishes a rolling
``checkpoint-{step:08d}.npz`` in the JAX package's format, appends a
``windows.jsonl`` record with a params digest (the witness
``replay_window`` recomputes offline), and, when ``publish_path`` is set,
publishes the challenger checkpoint for the arena gatekeeper. Fault sites:
``train_step`` before each step and ``kill`` after it.

The port's step updates its model in place, where JAX's arrays are
immutable. So the learner owns a module of its own, built from the
checkpoint it resumes or seeds from: it never shares a module with the
fleet that serves the champion, or each step would change what the users
get. The losses stay on the device and are read back once, at the
window's end. On the CPU a window is bitwise reproducible; on the card
only under ``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts, because cuDNN's
weight-gradient algorithms accumulate with atomics otherwise.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..analysis.cudacheck import stage_d2h
from ..data.loader import make_step_batch, to_device
from ..experiments import ExperimentConfig
from ..experiments import checkpoint as ckpt
from ..models import policy_cnn
from ..models.convert import (opt_state_from_jax, opt_state_to_jax,
                              params_to_jax)
from ..obs import get_registry
from ..training import make_train_step
from ..training.optimizers import for_config
from ..utils import faults
from ..utils.atomicio import atomic_write_bytes
from ..utils.retry import retry_with_backoff
from .replay import ReplayBuffer, ReplayView

CURSOR_NAME = "cursor.json"
WINDOWS_NAME = "windows.jsonl"


class LoopError(RuntimeError):
    """Base for typed expert-iteration-loop failures."""


class LoopStalled(LoopError):
    """A loop stage made no progress inside its stall budget (e.g. the
    learner waited past its deadline for the buffer to reach the minimum
    window extent — dead actors, or a wedged fleet upstream of them)."""


def params_digest(model) -> str:
    """SHA-256 over every leaf's dtype/shape/bytes of the model's JAX-layout
    view, in the JAX tree's leaf order: the digest the JAX package's
    ``params_digest`` gives for the same weights, so a checkpoint's digest
    means the same in both packages."""
    digest = hashlib.sha256()
    for arr in ckpt.tree_leaves(params_to_jax(model)):
        digest.update(str(arr.dtype).encode())
        digest.update(repr(tuple(arr.shape)).encode())
        digest.update(np.ascontiguousarray(arr).tobytes())
    return digest.hexdigest()


def _template(config: ExperimentConfig, device) -> policy_cnn.PolicyCNN:
    """The seed's model, drawn on the CPU and moved to ``device``, so the
    card and the CPU start from the same weights."""
    return policy_cnn.init(torch.Generator().manual_seed(config.seed),
                           config.model_config(), device=device)


def _load_state(path: str, config: ExperimentConfig, optimizer, o_leaves,
                device):
    """(model, opt_state) of the checkpoint at ``path`` on ``device``;
    ``o_leaves=None`` gives a fresh optimizer state over its weights."""
    model = ckpt.load_model_like(_template(config, device), path)
    opt_state = optimizer.init(model)
    if o_leaves is not None:
        opt_state = opt_state_from_jax(ckpt.unflatten_like(
            opt_state_to_jax(opt_state), o_leaves, path), device)
    return model, opt_state


class ContinuousLearner:
    """Windowed trainer over a ReplayBuffer with elastic auto-resume.

    ``config`` is a plain ExperimentConfig (model/optimizer/batch/seed —
    data_root is unused; the buffer IS the dataset). The stored config
    wins on resume, same contract as ``Experiment.auto_resume``. The
    learner trains on ``device`` (``cuda`` unless asked for the CPU).
    """

    def __init__(self, buffer: ReplayBuffer, run_dir: str,
                 config: ExperimentConfig,
                 steps_per_window: int = 50,
                 min_window_positions: int = 512,
                 scheme: str = "game",
                 publish_path: str | None = None,
                 seed_checkpoint: str | None = None,
                 stall_timeout_s: float = 300.0,
                 keep_checkpoints: int = 0,
                 metrics=None, clock=time.monotonic, sleep=time.sleep,
                 device="cuda"):
        self.buffer = buffer
        self.run_dir = run_dir
        self.device = resolve_device(device)
        self.steps_per_window = steps_per_window
        self.min_window_positions = min_window_positions
        self.scheme = scheme
        self.publish_path = publish_path
        self.stall_timeout_s = stall_timeout_s
        self.keep_checkpoints = keep_checkpoints
        self._metrics = metrics
        self._clock = clock
        self._sleep = sleep
        self._seed_checkpoint = seed_checkpoint
        os.makedirs(run_dir, exist_ok=True)
        reg = get_registry()
        self._obs_windows = reg.counter(
            "deepgo_loop_windows_trained_total",
            "completed learner training windows (checkpoint published)")
        self._obs_step_gauge = reg.gauge(
            "deepgo_loop_learner_step", "the learner's global step")
        self._resume(config, seed_checkpoint)

    # -- state / resume ----------------------------------------------------

    def _build(self, config: ExperimentConfig) -> None:
        self.config = config
        self.model_cfg = config.model_config()
        self.optimizer = for_config(config)
        self.train_step = make_train_step(self.model_cfg, self.optimizer)

    def _resume(self, config: ExperimentConfig,
                seed_checkpoint: str | None) -> None:
        """find_latest_valid over the learner dir (corrupt checkpoints are
        skipped with a logged reason); else seed from the champion
        checkpoint's params; else fresh init."""
        path = ckpt.find_latest_valid(self.run_dir)
        if path is not None:
            meta, _, o_leaves = ckpt.load_checkpoint(path)
            self._build(ExperimentConfig.from_dict(meta["config"]))
            self.model, self.opt_state = _load_state(
                path, self.config, self.optimizer, o_leaves, self.device)
            self.step = int(meta["step"])
            self.ewma = meta.get("ewma")
            self.window = int(meta.get("loop", {}).get("window", 0))
            self.resumed_from = path
            return
        self._build(config)
        self.resumed_from = None
        if seed_checkpoint:
            # a fresh optimizer over inherited weights: the champion's
            # opt_state belongs to ITS run; the challenger's momentum
            # history starts here
            self.model, self.opt_state = _load_state(
                seed_checkpoint, config, self.optimizer, None, self.device)
            self.step = int(ckpt.load_meta(seed_checkpoint).get("step", 0))
            self.resumed_from = seed_checkpoint
        else:
            self.model = _template(config, self.device)
            self.opt_state = self.optimizer.init(self.model)
            self.step = 0
        self.ewma = None
        self.window = 0
        # a fresh start durably records its own step-0 boundary: a kill
        # inside the very FIRST window then resumes from this checkpoint
        # plus the cursor, and the offline replay witness has a start
        # state for window 1
        self._save_checkpoint(0, 0, -1)

    def reload_state(self) -> None:
        """Discard in-memory training state and auto-resume from disk —
        what a crashed-and-restarted learner MUST do before training
        again: after a mid-window death the in-memory params sit at some
        arbitrary step while the durable truth is the last window-boundary
        checkpoint plus the cursor. Idempotent; the loop supervisor calls
        it at every learner (re)start."""
        self._resume(self.config, self._seed_checkpoint)

    # -- the cursor --------------------------------------------------------

    def _cursor_path(self) -> str:
        return os.path.join(self.run_dir, CURSOR_NAME)

    def _load_cursor(self) -> dict | None:
        try:
            with open(self._cursor_path()) as f:
                return json.load(f)
        except (FileNotFoundError, ValueError, OSError):
            return None  # absent or torn: freeze a fresh extent

    def _freeze_extent(self, stop=None) -> tuple[int, int, int]:
        """The window's extent: the cursor's, when it pins THIS step (a
        resume of an interrupted window); otherwise a freshly frozen
        sealed span, durably recorded before any step runs."""
        cursor = self._load_cursor()
        if cursor is not None and cursor.get("step") == self.step \
                and cursor.get("seed") == self.config.seed:
            lo, hi = cursor["extent"]
            return int(lo), int(hi), int(cursor.get("version", -1))
        lo, hi, version = self._await_buffer(stop)
        cursor = {"window": self.window, "step": self.step,
                  "steps": self.steps_per_window,
                  "extent": [lo, hi], "version": version,
                  "seed": self.config.seed,
                  "batch_size": self.config.batch_size,
                  "scheme": self.scheme}
        atomic_write_bytes(self._cursor_path(), json.dumps(cursor).encode())
        return lo, hi, version

    def _await_buffer(self, stop=None) -> tuple[int, int, int]:
        """Block until the sealed span can feed a window; seal a starved
        partial segment rather than waiting for actors to fill it. Past
        the stall budget this raises a typed LoopStalled — the signal
        that the PRODUCERS are dead, which a learner restart cannot fix
        but the loop supervisor can see and count."""
        deadline = self._clock() + self.stall_timeout_s
        while True:
            lo, hi, version = self.buffer.extent()
            if hi - lo >= self.min_window_positions:
                return lo, hi, version
            # enough ingested but not yet compacted: seal what exists
            if (hi - lo) + self.buffer.open_positions \
                    >= self.min_window_positions:
                self.buffer.seal()
                continue
            if stop is not None and stop.is_set():
                raise LoopStalled("stop requested while awaiting buffer")
            if self._clock() >= deadline:
                raise LoopStalled(
                    f"buffer stuck at {hi - lo} sealed positions "
                    f"(+{self.buffer.open_positions} open) after "
                    f"{self.stall_timeout_s:.0f}s; window needs "
                    f"{self.min_window_positions} — are the actors dead?")
            self._sleep(0.05)

    # -- training ----------------------------------------------------------

    def train_window(self, stop=None) -> dict | None:
        """One window: freeze extent -> K deterministic steps -> atomic
        checkpoint + windows.jsonl record + challenger publish. Returns
        the window record, or None when ``stop`` fired mid-window (state
        is then exactly a kill's: resume retrains the window)."""
        lo, hi, version = self._freeze_extent(stop)
        view = self.buffer.view(lo, hi)
        step0 = self.step
        t0 = self._clock()
        ewma = self.ewma
        last_loss = float("nan")
        losses = []  # device-resident; fetched once at the window fence
        for t in range(step0, step0 + self.steps_per_window):
            if stop is not None and stop.is_set():
                return None
            batch = make_step_batch(view, self.config.seed, t,
                                    self.config.batch_size,
                                    scheme=self.scheme)
            faults.check("train_step")
            self.model, self.opt_state, loss = self.train_step(
                self.model, self.opt_state, to_device(batch, self.device))
            losses.append(loss)
            self.step = t + 1
            faults.check("kill", step=self.step)
        # the window's one read back: the same floats folded in the same
        # order as a per-step read, so the checkpointed EWMA and the
        # bit-exact resume are unchanged
        # lint: allow[hot-sync] declared materialization point: one fetch per window, not one per step
        for last_loss in stage_d2h(torch.stack(losses)).tolist():
            ewma = (last_loss if ewma is None
                    else 0.95 * ewma + 0.05 * last_loss)
        self.ewma = ewma
        self.window += 1
        digest = params_digest(self.model)
        path = self._save_checkpoint(lo, hi, version)
        record = {
            "window": self.window,
            "step0": step0,
            "step1": self.step,
            "extent": [lo, hi],
            "version": version,
            "scheme": self.scheme,
            "digest": digest,
            "ewma": ewma,
            "loss": last_loss,
            "seconds": round(self._clock() - t0, 3),
            "checkpoint": path,
        }
        with open(os.path.join(self.run_dir, WINDOWS_NAME), "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.publish_path:
            self.publish(self.publish_path)
            record["published"] = self.publish_path
        self._obs_windows.inc(1)
        self._obs_step_gauge.set(self.step)
        if self._metrics is not None:
            self._metrics.write("loop_window", **{
                k: v for k, v in record.items() if k != "checkpoint"})
            # the lineage chain's extent->window->checkpoint join
            self._metrics.write("lineage_window", window=self.window,
                                step0=step0, step1=self.step,
                                extent=[lo, hi], version=version,
                                scheme=self.scheme, digest=digest,
                                checkpoint=path)
        return record

    def _meta(self) -> dict:
        return {
            "id": "loop-learner",
            "step": self.step,
            "validation_history": [],
            "ewma": self.ewma,
            "config": self.config.to_dict(),
            "loop": {"window": self.window},
        }

    def _write(self, path: str, meta: dict) -> None:
        ckpt.save_checkpoint(path, params_to_jax(self.model),
                             opt_state_to_jax(self.opt_state), meta)

    def _save_checkpoint(self, lo: int, hi: int, version: int) -> str:
        path = os.path.join(self.run_dir, ckpt.checkpoint_name(self.step))
        meta = self._meta()
        meta["loop"].update(extent=[lo, hi], version=version)
        # transient I/O is retried; a persistently failing save surfaces:
        # the loop's windows ARE the publish cadence, so silently skipping
        # one would stall the gatekeeper with no visible cause
        retry_with_backoff(lambda: self._write(path, meta), attempts=3,
                           base_delay=0.1)
        self._apply_retention()
        return path

    def _apply_retention(self) -> None:
        keep = self.keep_checkpoints
        if keep <= 0:
            return
        entries = ckpt.list_checkpoints(self.run_dir)
        for s, p in entries[:-keep]:
            try:
                os.remove(p)
            except OSError:
                pass

    def publish(self, path: str) -> str:
        """Atomically publish the current state as a challenger
        checkpoint: a watcher (the gatekeeper) only ever observes the old
        or the new complete file."""
        self._write(path, self._meta())
        return path


def replay_window(run_dir: str, buffer: ReplayBuffer, record: dict,
                  device="cuda") -> str:
    """Re-train one recorded window from its start checkpoint, offline, on
    ``device``, and return the resulting params digest.

    The independent witness for the learner's own ``windows.jsonl``
    digest: the replay is itself an uninterrupted run over the recorded
    extent, so digest equality proves the (possibly killed-and-resumed)
    live window was bit-exact."""
    device = resolve_device(device)
    path = os.path.join(run_dir, ckpt.checkpoint_name(record["step0"]))
    meta, _, o_leaves = ckpt.load_checkpoint(path)
    config = ExperimentConfig.from_dict(meta["config"])
    optimizer = for_config(config)
    model, opt_state = _load_state(path, config, optimizer, o_leaves, device)
    step_fn = make_train_step(config.model_config(), optimizer)
    lo, hi = record["extent"]
    view: ReplayView = buffer.view(int(lo), int(hi))
    for t in range(int(record["step0"]), int(record["step1"])):
        batch = make_step_batch(view, config.seed, t, config.batch_size,
                                scheme=record.get("scheme", "game"))
        model, opt_state, _ = step_fn(model, opt_state,
                                      to_device(batch, device))
    return params_digest(model)


def read_windows(run_dir: str) -> list[dict]:
    """The windows.jsonl records (a torn final line is tolerated)."""
    out = []
    try:
        with open(os.path.join(run_dir, WINDOWS_NAME)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except FileNotFoundError:
        pass
    return out
