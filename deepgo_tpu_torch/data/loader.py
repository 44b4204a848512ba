"""Asynchronous input pipeline: host sampling threads feeding the device.

The port of ``deepgo_tpu/data/loader.py``. The host only gathers packed
uint8 records from a memmap (about 3.2 KB a position, or 1,625 bytes on the
nibble wire); the expansion into planes runs on the device inside the step.

On a CUDA device each (super)batch is copied from pinned host buffers with
``non_blocking`` copies on a side stream of the loader's own, so the copy
of batch n+1 overlaps the step on batch n. ``get()`` makes the consumer's
current stream wait on the copy's event and ``record_stream``s every
delivered tensor on it, so the caching allocator does not reuse a batch's
device memory while a step still reads it. On the CPU the arrays are
wrapped as tensors: no pinning, no stream.

``num_threads=0`` samples synchronously in the caller and is
*step-indexed*: the batch for step t is a pure function of (seed, t), so a
resumed run replays the uninterrupted run's batches bitwise.

Data parallelism: ``shard=(index, count)`` makes the loader feed data rank
``index`` of ``count``. Step-indexed, every rank draws the global batch's
indices from ``step_rng(seed, t)`` and gathers only its own B / count
rows, so the ranks together train on exactly the single device's batch.
Threaded, each rank samples B / count rows from a stream seeded from
(seed + start_step, index): i.i.d. as before, but not the single device's
batches row for row (the JAX package's one global stream is).
"""

from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..analysis.cudacheck import place
from ..obs import get_registry
from ..ops.wire import nibble_pack_np
from .dataset import GoDataset


class LoaderClosed(RuntimeError):
    """get()/_drain called on (or blocked in) a closed AsyncLoader."""


def step_rng(seed: int, step: int) -> np.random.Generator:
    """The generator for training step ``step``: a pure function of
    (seed, step), independent of loader history, so a resume at step t
    draws exactly the batches the uninterrupted run drew, and a K-step
    superbatch holds bitwise the K single-step batches."""
    return np.random.default_rng(np.random.SeedSequence((seed, step)))


def _rows(batch_size: int, shard: tuple[int, int] | None) -> slice:
    """Data rank ``shard[0]``'s rows of ``shard[1]`` (all rows for None)."""
    if shard is None:
        return slice(0, batch_size)
    index, count = shard
    if batch_size % count:
        raise ValueError(f"batch_size {batch_size} must divide over "
                         f"{count} data-parallel ranks")
    per = batch_size // count
    return slice(index * per, (index + 1) * per)


def make_step_batch(dataset: GoDataset, seed: int, step: int, batch_size: int,
                    scheme: str = "game", augment: bool = False,
                    wire: str = "packed", stack: int = 0,
                    shard: tuple[int, int] | None = None) -> dict:
    """Deterministic (super)batch covering steps [step, step + max(1, stack)).

    Each covered step samples from its own ``step_rng``; the gather and the
    optional nibble pass run once over all k*B positions. ``stack=0``
    returns a flat (B, ...) batch, ``stack>=1`` a (K, B, ...) superbatch.
    ``shard=(index, count)`` keeps data rank ``index``'s B / count rows of
    each step's global batch of ``batch_size`` (only those are gathered)."""
    k = max(1, stack)
    rows = _rows(batch_size, shard)
    idx_parts, sym_parts = [], []
    for t in range(step, step + k):
        rng = step_rng(seed, t)
        idx_parts.append(dataset.sample_indices(rng, batch_size,
                                                scheme)[rows])
        if augment:
            sym_parts.append(rng.integers(0, 8, size=batch_size)
                             .astype(np.int32)[rows])
    batch_size = rows.stop - rows.start
    packed, player, rank, target = dataset.batch_at(np.concatenate(idx_parts))
    if wire == "nibble":
        packed = nibble_pack_np(packed)

    def fold(a: np.ndarray) -> np.ndarray:
        if stack < 1:
            return a
        return a.reshape(k, batch_size, *a.shape[1:])

    batch = {"packed": fold(packed), "player": fold(player),
             "rank": fold(rank), "target": fold(target)}
    if augment:
        batch["sym"] = fold(np.concatenate(sym_parts))
    return batch


def make_host_batch(dataset: GoDataset, rng: np.random.Generator,
                    batch_size: int, scheme: str = "game",
                    augment: bool = False, wire: str = "packed") -> dict:
    packed, player, rank, target = dataset.sample_batch(rng, batch_size,
                                                        scheme)
    if wire == "nibble":
        packed = nibble_pack_np(packed)
    batch = {"packed": packed, "player": player, "rank": rank,
             "target": target}
    if augment:
        # per-sample dihedral symmetry index, applied on the device
        batch["sym"] = rng.integers(0, 8, size=batch_size).astype(np.int32)
    return batch


def make_host_superbatch(dataset: GoDataset, rng: np.random.Generator,
                         batch_size: int, stack: int, scheme: str = "game",
                         augment: bool = False, wire: str = "packed") -> dict:
    """One (K, B, ...) superbatch from a single K*B-position gather:
    distributed as K stacked ``make_host_batch`` results, with one memmap
    gather and one nibble pass."""
    n = batch_size * stack
    packed, player, rank, target = dataset.sample_batch(rng, n, scheme)
    if wire == "nibble":
        packed = nibble_pack_np(packed)

    def fold(a: np.ndarray) -> np.ndarray:
        return a.reshape(stack, batch_size, *a.shape[1:])

    batch = {"packed": fold(packed), "player": fold(player),
             "rank": fold(rank), "target": fold(target)}
    if augment:
        batch["sym"] = rng.integers(
            0, 8, size=(stack, batch_size)).astype(np.int32)
    return batch


def to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    """Host arrays -> tensors on ``device`` (a blocking copy, or the
    sanitizer's declared staged copy when it is armed); for batches built
    outside the loader, such as fixed validation sets."""
    return {k: place(v, device) for k, v in batch.items()}


class AsyncLoader:
    """Bounded-queue prefetching sampler over a GoDataset split."""

    def __init__(
        self,
        dataset: GoDataset,
        batch_size: int,
        scheme: str = "game",
        seed: int = 0,
        start_step: int = 0,
        num_threads: int = 2,
        prefetch: int = 4,
        device="cuda",
        augment: bool = False,
        stack: int = 0,
        wire: str = "packed",
        device_prefetch: int = 0,
        shard: tuple[int, int] | None = None,
    ):
        """``stack=K`` (K >= 1) makes ``get()`` return (K, B, ...)
        superbatches for ``make_train_step_many``. ``wire="nibble"`` ships
        packed records two cells per byte (the step must use the same
        wire). ``device_prefetch=N`` (with ``num_threads > 0``) adds an
        uploader thread that keeps up to N (super)batches copied to the
        device ahead of the consumer.

        ``start_step`` is the training step this loader begins feeding.
        With ``num_threads=0`` the stream is step-indexed (``step_rng``);
        threaded mode keeps the free-running i.i.d. stream, where
        start_step only offsets the worker seeds. ``shard=(index, count)``
        feeds data rank ``index`` its B / count rows (module docstring)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard
        # rows a threaded worker samples for this rank
        rows = _rows(batch_size, shard)
        self._local_batch = rows.stop - rows.start
        self.scheme = scheme
        self.wire = wire
        self.device = resolve_device(device)
        # the copy stream: device work of the loader runs on it, never on
        # the consumer's stream
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        reg = get_registry()
        self._obs_wait = reg.histogram(
            "deepgo_loader_wait_seconds",
            "time the consumer blocked in AsyncLoader.get()")
        self._obs_depth = reg.gauge(
            "deepgo_loader_queue_depth",
            "prefetch queue occupancy at the last get() (host = sampled "
            "batches, device = device_put-dispatched batches)")
        self._obs_h2d = reg.histogram(
            "deepgo_h2d_seconds",
            "host->device transfer dispatch time "
            "(path=inline blocks the consumer, path=uploader overlaps)")
        if scheme == "winner":
            # fail here, not silently inside a worker thread
            dataset.winner_positions()
        self.augment = augment
        self.stack = stack
        self.num_threads = num_threads
        self._seed = seed
        self._cursor = start_step  # next step to feed (step-indexed mode)
        self._seq = np.random.SeedSequence(
            seed + start_step if shard is None
            else (seed + start_step, shard[0]))
        self._worker_error: BaseException | None = None
        self._dev_queue: queue.Queue | None = None
        if num_threads > 0:
            # maxsize is in units of get() calls (whole superbatches)
            self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
            self._stop = threading.Event()
            worker_seeds = self._seq.spawn(num_threads)
            # off-depth get(stack=K') calls sample synchronously with a
            # stream of their own
            self._sync_rng = np.random.default_rng(self._seq.spawn(1)[0])
            self._threads = [
                threading.Thread(
                    target=self._worker,
                    args=(np.random.default_rng(s),),
                    name=f"loader-worker-{i}",
                    daemon=True,
                )
                for i, s in enumerate(worker_seeds)
            ]
            for t in self._threads:
                t.start()
            if device_prefetch > 0:
                self._dev_queue = queue.Queue(maxsize=device_prefetch)
                self._uploader = threading.Thread(target=self._upload_loop,
                                                  name="loader-uploader",
                                                  daemon=True)
                self._threads.append(self._uploader)
                self._uploader.start()
        else:
            self._sync_rng = None  # sync mode is step-indexed, rng-free

    def _produce(self, stack: int, rng: np.random.Generator | None) -> dict:
        """Sample one unit at the given depth; ``rng=None`` (sync mode)
        draws step-indexed from the loader's step cursor."""
        if rng is None:
            batch = make_step_batch(self.dataset, self._seed, self._cursor,
                                    self.batch_size, self.scheme,
                                    self.augment, self.wire, stack=stack,
                                    shard=self.shard)
            self._cursor += max(1, stack)
            return batch
        if stack < 1:
            return make_host_batch(self.dataset, rng, self._local_batch,
                                   self.scheme, self.augment, self.wire)
        return make_host_superbatch(self.dataset, rng, self._local_batch,
                                    stack, self.scheme, self.augment,
                                    self.wire)

    def _worker(self, rng: np.random.Generator) -> None:
        try:
            while not self._stop.is_set():
                batch = self._produce(self.stack, rng)
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — surfaced via get()
            # stash the first error and stop the pool, so the consumer's
            # next get() re-raises it instead of waiting forever
            if self._worker_error is None:
                self._worker_error = e
            self._stop.set()

    def _drain(self, q: queue.Queue):
        """Shutdown-aware blocking get: re-raises a stashed worker error,
        raises LoaderClosed once close() has been called, otherwise returns
        the next item."""
        while True:
            if self._worker_error is not None:
                raise RuntimeError(
                    "AsyncLoader worker thread died"
                ) from self._worker_error
            if self._stop.is_set():
                raise LoaderClosed("AsyncLoader is closed")
            try:
                return q.get(timeout=0.5)
            except queue.Empty:
                continue

    def _copy(self, batch: dict):
        """Host arrays -> (device tensors, the copy's CUDA event or None)."""
        if self._stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in batch.items()}, None
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in batch.items()}
        with torch.cuda.stream(self._stream):
            out = {k: t.to(self.device, non_blocking=True)
                   for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _assemble(self, stack: int, path: str = "inline"):
        """One (super)batch at the given depth with its copy to the device
        started. The default depth pulls ready units from the worker queue;
        an off-depth request samples synchronously. ``path`` labels whose
        clock the copy ran on (inline = the consumer's)."""
        if self.num_threads > 0 and stack == self.stack:
            batch = self._drain(self._queue)
        else:
            batch = self._produce(stack, self._sync_rng)
        t0 = time.monotonic()
        staged = self._copy(batch)
        self._obs_h2d.observe(time.monotonic() - t0, path=path)
        return staged

    def _upload_loop(self) -> None:
        """Uploader thread: keep the device queue full of (super)batches
        at the default depth whose copies are under way."""
        try:
            while not self._stop.is_set():
                staged = self._assemble(self.stack, path="uploader")
                while not self._stop.is_set():
                    try:
                        self._dev_queue.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except LoaderClosed:
            return  # normal shutdown
        except BaseException as e:  # noqa: BLE001 — surfaced via get()
            if self._worker_error is None:
                self._worker_error = e
            self._stop.set()

    def _deliver(self, staged) -> dict[str, torch.Tensor]:
        batch, event = staged
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    def get(self, stack: int | None = None) -> dict[str, torch.Tensor]:
        """Next (super)batch as tensors on the device, ready for work on
        the caller's current stream.

        ``stack`` overrides the constructor's depth for this call (the
        final partial window); such calls bypass the device queue."""
        stack = self.stack if stack is None else stack
        t0 = time.monotonic()
        if self._dev_queue is not None and stack == self.stack:
            staged = self._drain(self._dev_queue)
        else:
            staged = self._assemble(stack)
        batch = self._deliver(staged)
        self._obs_wait.observe(time.monotonic() - t0)
        if self.num_threads > 0:
            self._obs_depth.set(self._queue.qsize(), queue="host")
            if self._dev_queue is not None:
                self._obs_depth.set(self._dev_queue.qsize(), queue="device")
        return batch

    def __iter__(self):
        while True:
            yield self.get()

    def _drain_dev_queue(self) -> None:
        """Discard everything staged on the device queue, so an uploader
        blocked in ``put()`` at close time can exit."""
        if self._dev_queue is None:
            return
        while True:
            try:
                self._dev_queue.get_nowait()
            except queue.Empty:
                return

    def close(self, timeout: float = 2.0) -> None:
        """Stop and join the threads, draining the device queue while
        joining; a thread that will not exit is reported on stderr (they
        are daemons, and die with the process)."""
        if self.num_threads <= 0:
            return
        self._stop.set()
        self._drain_dev_queue()
        for t in self._threads:
            deadline = time.monotonic() + timeout
            while t.is_alive():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                t.join(timeout=min(0.1, remaining))
                self._drain_dev_queue()
        leaked = [t.name for t in self._threads if t.is_alive()]
        if leaked:
            print(
                f"AsyncLoader.close: {len(leaked)} thread(s) still alive "
                f"after {timeout}s: {', '.join(leaked)}. Leaking them; "
                "daemon threads die with the process.",
                file=sys.stderr, flush=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
