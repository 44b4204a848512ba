"""Runtime CUDA performance-contract sanitizer (``DEEPGO_XLACHECK=1``).

The port's counterpart of ``deepgo_tpu/analysis/xlacheck.py``: the same
public names, the same switch and the same finding records, so the tests
and the command line read either package alike. The serving engine's speed
rests on contracts the code keeps by hand: the bucket ladder gives the
forward a fixed set of batch shapes, the one declared host-to-device copy
per dispatch is staged explicitly, and a parallel placement really holds
the shards its spec declares. Three checks hold them at run time:

  * **signature sentinel** — :func:`watch_compiles` wraps a forward with a
    counter of the distinct (shape, dtype) signatures its arguments take.
    Eager PyTorch compiles nothing, so a new signature is what a compile
    is under XLA: a new cuDNN plan, allocator growth and, under cuDNN
    autotuning (``torch.backends.cudnn.benchmark``), a real new algorithm
    search. :func:`mark_warm` at the warm-up boundary sets the budget to
    ZERO: any later new signature is a typed :class:`RecompileStorm`
    finding carrying the signature, dumped through the flight recorder.
  * **transfer guard** — :func:`transfer_guard` checks that every input
    of the guarded forward is a tensor already on its device, then runs
    the body under ``torch.cuda.set_sync_debug_mode("error")``, so an
    implicit host-device copy (a pageable-memory copy synchronises the
    stream) raises at its line. :func:`stage_h2d` is the DECLARED
    host-to-device point (pinned memory, a copy that does not
    synchronise); :func:`stage_d2h` the declared device-to-host point the
    forwards return through (a pinned copy, then a wait on a CUDA event,
    which the sync check does not flag). Violations are counted and
    recorded on their way out.
  * **sharding-claim checker** — :func:`check_sharding` holds each local
    shard's shape against the shape its declared spec gives
    (``parallel/reshard.check_placement``), so "sharded" can never silently
    mean "replicated"; wired into ``tensor.shard_params`` and
    ``zero.shard_opt_state``.

Opt-in: everything here is a no-op (identity-returning, ``nullcontext``)
unless ``DEEPGO_XLACHECK=1`` (or programmatic :func:`enable`), so the hot
paths pay one attribute check per engine dispatch by default. The sync
check is process-wide: a guard arms it for every thread until the last
open guard closes (the first restores the previous mode, even when the
body raised), so arm the sanitizer in a process whose CUDA work is the
guarded engines'; their staged inputs and declared outputs never
synchronise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import time

import numpy as np

_ENV = "DEEPGO_XLACHECK"
_force: bool | None = None


def enabled() -> bool:
    """Is the sanitizer on? Programmatic :func:`enable` wins over the
    ``DEEPGO_XLACHECK`` environment variable."""
    if _force is not None:
        return _force
    return os.environ.get(_ENV, "0") not in ("", "0")


def enable(on: bool | None = True) -> None:
    """Programmatic override (tests, campaigns). ``enable(None)``
    restores environment-variable control."""
    global _force
    _force = on


def _abstract(value) -> str:
    """The signature a storm report names: ``uint8[8,9,19,19]`` for
    tensors and arrays, ``dict[N]`` / ``list[N]`` for containers, the type
    name otherwise."""
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is not None and dtype is not None:
        name = str(dtype).removeprefix("torch.")
        return f"{name}[{','.join(str(d) for d in shape)}]"
    if isinstance(value, (dict, list, tuple)):
        return f"{type(value).__name__}[{len(value)}]"
    return type(value).__name__


class ImplicitTransfer(RuntimeError):
    """An input of a guarded forward that is not a tensor on its device:
    the forward would copy it implicitly."""


@dataclasses.dataclass(frozen=True)
class RecompileStorm:
    """One steady-state (post-warm-up) new signature, typed for the
    report. ``cache_before`` / ``cache_after`` count the watched forward's
    distinct signatures."""

    fn: str
    shapes: tuple[str, ...]
    cache_before: int
    cache_after: int
    thread: str
    time: float

    def to_dict(self) -> dict:
        return {"kind": "recompile_storm", "fn": self.fn,
                "shapes": list(self.shapes),
                "cache_before": self.cache_before,
                "cache_after": self.cache_after,
                "thread": self.thread, "time": self.time}


class _Checker:
    """Global finding store + the ``deepgo_xlacheck_*`` metrics."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        # leaf mutex: nothing is acquired while this is held
        self._mu = threading.Lock()
        self._storms: list[RecompileStorm] = []
        self._transfers: list[dict] = []
        self._sharding: list[dict] = []
        self._seen_sharding: set[tuple] = set()
        self._watched: list["_CompileWatch"] = []
        from ..obs import get_registry

        reg = get_registry()
        self._obs_recompiles = reg.counter(
            "deepgo_xlacheck_recompiles_total",
            "steady-state (post-warmup) new forward signatures caught by "
            "the signature sentinel")
        self._obs_transfers = reg.counter(
            "deepgo_xlacheck_transfer_violations_total",
            "implicit host<->device transfers raised inside guarded hot "
            "sections")
        self._obs_sharding = reg.counter(
            "deepgo_xlacheck_sharding_mismatches_total",
            "declared-vs-actual sharding mismatches on live tensors")

    # -- signature sentinel ------------------------------------------------

    def register(self, watch: "_CompileWatch") -> None:
        with self._mu:
            self._watched.append(watch)

    def record_storm(self, storm: RecompileStorm) -> None:
        with self._mu:
            self._storms.append(storm)
        self._obs_recompiles.inc(storm.cache_after - storm.cache_before,
                                 fn=storm.fn)
        print(f"cudacheck: RECOMPILE STORM {storm.fn} saw a new signature "
              f"post-warmup ({storm.cache_before} -> {storm.cache_after}) "
              f"[{', '.join(storm.shapes)}] on thread {storm.thread}",
              file=sys.stderr, flush=True)
        self._flight("recompile_storm", **storm.to_dict())

    # -- transfer guard ----------------------------------------------------

    def record_transfer(self, tag: str, error: BaseException) -> None:
        record = {"kind": "implicit_transfer", "tag": tag,
                  "error": str(error)[:400],
                  "thread": threading.current_thread().name,
                  "time": self.clock()}
        with self._mu:
            self._transfers.append(record)
        self._obs_transfers.inc(tag=tag)
        self._flight("implicit_transfer", **record)

    # -- sharding claims ---------------------------------------------------

    def record_sharding(self, tag: str, path: str, problem: str,
                        declared, actual) -> dict | None:
        key = (tag, path)
        record = {"kind": "sharding_claim", "tag": tag, "path": path,
                  "problem": problem, "declared": str(declared),
                  "actual": str(actual), "time": self.clock()}
        with self._mu:
            if key in self._seen_sharding:
                return record  # report once per (tag, leaf), like hazards
            self._seen_sharding.add(key)
            self._sharding.append(record)
        self._obs_sharding.inc(tag=tag)
        print(f"cudacheck: SHARDING CLAIM {tag}{path}: {problem} "
              f"(declared {declared}, actual {actual})",
              file=sys.stderr, flush=True)
        self._flight("sharding_claim", **record)
        return record

    def _flight(self, reason: str, **detail) -> None:
        try:
            from ..obs.sentinel import flight_dump

            flight_dump(reason, **detail)
        except Exception:  # noqa: BLE001 — detection must never raise out
            pass

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        with self._mu:
            watched: dict[str, dict] = {}
            for w in self._watched:
                agg = watched.setdefault(
                    w.name, {"compiles": 0, "steady_state_compiles": 0,
                             "warm": False})
                agg["compiles"] += w.compiles
                agg["steady_state_compiles"] += w.steady_state_compiles
                agg["warm"] = agg["warm"] or w.warm
            return {
                "enabled": enabled(),
                "watched": watched,
                "steady_state_compiles": sum(
                    v["steady_state_compiles"] for v in watched.values()),
                "storms": [s.to_dict() for s in self._storms],
                "transfers": list(self._transfers),
                "sharding": list(self._sharding),
            }


class _CompileWatch:
    """A forward with a signature counter and a warm-up boundary: a new
    (shape, dtype) signature of its arguments is a "compile"; one after
    :meth:`mark_warm` is a :class:`RecompileStorm`."""

    def __init__(self, fn, name: str, checker: _Checker):
        self._fn = fn
        self.name = name
        self._checker = checker
        self.warm = False
        self.compiles = 0
        self.steady_state_compiles = 0
        self._signatures: set[tuple] = set()
        self._mu = threading.Lock()
        checker.register(self)

    def cache_size(self) -> int:
        with self._mu:
            return len(self._signatures)

    def mark_warm(self) -> None:
        """Warm-up is over: the budget for new signatures is now zero."""
        self.warm = True

    def __call__(self, *args, **kwargs):
        sig = tuple(_abstract(a) for a in args)
        with self._mu:
            new = sig not in self._signatures
            if new:
                before = len(self._signatures)
                self._signatures.add(sig)
                self.compiles += 1
                storm = self.warm
                if storm:
                    self.steady_state_compiles += 1
        if new and storm:
            self._checker.record_storm(RecompileStorm(
                fn=self.name, shapes=sig, cache_before=before,
                cache_after=before + 1,
                thread=threading.current_thread().name,
                time=self._checker.clock()))
        return self._fn(*args, **kwargs)

    def __repr__(self) -> str:
        return f"_CompileWatch({self.name!r}, warm={self.warm})"


# the process-wide sync check: armed while any guard is open
_sync_mu = threading.Lock()
_sync_depth = 0
_sync_saved = 0


def _arm_sync() -> None:
    import torch

    global _sync_depth, _sync_saved
    with _sync_mu:
        if _sync_depth == 0:
            _sync_saved = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        _sync_depth += 1


def _disarm_sync() -> None:
    import torch

    global _sync_depth
    with _sync_mu:
        _sync_depth -= 1
        if _sync_depth == 0:
            torch.cuda.set_sync_debug_mode(_sync_saved)


def _is_sync_error(exc: BaseException) -> bool:
    return "synchronizing CUDA operation" in str(exc)


class _TransferGuard:
    """The input check, then the body under the sync check; violations
    are recorded on their way out (the exception still propagates — the
    finding raises at its line, the engine's containment types it)."""

    def __init__(self, tag: str, checker: _Checker, device, inputs):
        import torch

        self.tag = tag
        self._checker = checker
        self.device = None
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.device = device
        self.inputs = tuple(inputs)
        self._armed = False

    def __enter__(self) -> "_TransferGuard":
        import torch

        if self.device is not None:
            for i, value in enumerate(self.inputs):
                if not (isinstance(value, torch.Tensor)
                        and value.device == self.device):
                    err = ImplicitTransfer(
                        f"{self.tag}: input {i} ({_abstract(value)} on "
                        f"{getattr(value, 'device', 'the host')}) is not "
                        f"staged on {self.device}; the forward would copy "
                        "it implicitly")
                    self._checker.record_transfer(self.tag, err)
                    raise err
            if self.device.type == "cuda":
                _arm_sync()
                self._armed = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._armed:
            _disarm_sync()
        if exc is not None and _is_sync_error(exc):
            self._checker.record_transfer(self.tag, exc)
        return False


_checker: _Checker | None = None
_checker_mu = threading.Lock()


def _get() -> _Checker:
    global _checker
    if _checker is None:
        with _checker_mu:
            if _checker is None:
                _checker = _Checker()
    return _checker


def watch_compiles(fn, name: str):
    """Wrap a forward with the signature sentinel; returns ``fn``
    unchanged when the sanitizer is off (zero hot-path cost)."""
    if not enabled():
        return fn
    return _CompileWatch(fn, name, _get())


def mark_warm(fn) -> None:
    """Declare warm-up complete for a watched forward (no-op on an
    unwrapped fn — the off-mode engine calls this unconditionally)."""
    if isinstance(fn, _CompileWatch):
        fn.mark_warm()


def transfer_guard(tag: str, device=None, inputs=()):
    """Guard a hot section against implicit transfers: a no-op context
    manager when off; armed, every value of ``inputs`` must be a tensor
    on ``device`` (an :class:`ImplicitTransfer` otherwise), and on a CUDA
    device the body runs under the sync check. ``device=None`` checks
    nothing (a forward with no device, the CPU stubs of the tests)."""
    if not enabled():
        return contextlib.nullcontext()
    return _TransferGuard(tag, _get(), device, inputs)


def stage_h2d(*values, device=None):
    """The DECLARED host-to-device point — identity when off or without a
    device. Armed, each numpy array or tensor becomes a tensor on
    ``device`` (on a card through pinned memory, a copy that does not
    synchronise); other values (a model, a scalar) pass through."""
    if not enabled() or device is None:
        return values
    import torch

    device = torch.device(device)
    out = []
    for v in values:
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor) and v.device != device:
            if device.type == "cuda" and v.device.type == "cpu":
                v = v.pin_memory().to(device, non_blocking=True)
            else:
                v = v.to(device)
        out.append(v)
    return tuple(out)


def stage_d2h(tensor) -> np.ndarray:
    """A forward's result as a numpy array: ``tensor.cpu().numpy()``, or,
    armed and on a card, a copy into pinned memory that waits on a CUDA
    event instead of synchronising the stream (legal inside a guard)."""
    if not (tensor.is_cuda and enabled()):
        return tensor.cpu().numpy()
    import torch

    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()


def check_sharding(tag: str, named: dict, specs: dict,
                   placement) -> list[dict]:
    """Hold the local shards of ``named`` (parameter name -> tensor)
    against the shapes their declared ``specs`` give under ``placement``
    (``parallel/reshard.Placement``); returns the mismatch records (empty
    when off or in parity). A record's ``path`` is the JAX package's key
    string for the same dict entry.

    The headline failure this catches: a leaf DECLARED sharded that is
    actually whole on this rank — the silent fallback that makes every
    "fits because it is sharded" claim a lie. A leaf that is not a tensor
    (a host array never placed) and any other shape mismatch are findings
    too."""
    if not enabled():
        return []
    import torch

    from ..parallel.reshard import check_placement

    checker = _get()
    findings: list[dict] = []
    for name, leaf in named.items():
        spec = specs[name]
        problem = actual = None
        if not isinstance(leaf, torch.Tensor):
            problem = "leaf has no sharding (host array, never placed)"
        elif check_placement(tag, {name: leaf}, {name: spec}, placement):
            actual = tuple(leaf.shape)
            full = tuple(placement.shapes[name])
            if actual == full and placement.local_shape(name, spec) != full:
                problem = ("declared sharded but actually FULLY "
                           "REPLICATED — the silent-fallback failure")
            else:
                problem = "placement does not match the declared sharding"
        if problem is not None:
            rec = checker.record_sharding(tag, f"[{name!r}]", problem, spec,
                                          actual)
            if rec is not None:
                findings.append(rec)
    return findings


def report() -> dict:
    """Snapshot of watched forwards, storms, transfer violations, and
    sharding-claim mismatches."""
    return _get().report()


def reset(clock=time.monotonic) -> None:
    """Discard all recorded state (tests; each scenario gets a fresh
    checker). Watches made before the reset keep counting — into their
    original checker, which report() no longer reads."""
    global _checker
    with _checker_mu:
        _checker = _Checker(clock=clock)
