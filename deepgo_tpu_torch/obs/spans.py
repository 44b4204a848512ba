"""Context-manager span tracing: named host regions with parent ids.

The port's copy of ``deepgo_tpu/obs/spans.py``, its profiler bridge on
``torch.profiler`` and NVTX in place of ``jax.profiler.TraceAnnotation``.
A span is one named region of host work (a validation
pass, a checkpoint save, an elastic recovery) with an id, a parent id
(nesting is tracked per-context via ``contextvars``, so concurrently running
threads build independent trees), a status, and exception capture. Each
completed span is

  * streamed to the configured JSONL trace sink as an ``obs_span`` event;
  * folded into the process registry's ``deepgo_span_seconds`` histogram,
    keyed by span name, so p50/p99 per stage are live;
  * handed to every span listener (the flight recorder's ring);
  * bridged onto a ``torch.profiler.record_function`` range (and an NVTX
    range where CUDA is available) while active, so when a profiler
    capture is running (``utils.profiling.trace``) the same named region
    appears on the host timeline over the kernels it launched.

Spans deliberately do NOT wrap the per-step hot path: a JSONL line per
training step would be measurable overhead. Spans are for the coarse
stages whose individual occurrences matter. The hot path has the lean
forms: ``hot_span``, the same profiler range and the same histogram and
nothing else (no id, no context, no sink line, no listener, no NVTX);
``hot_laps``, back-to-back hot spans whose caller reads the clock itself,
for a per-dispatch path; ``hot_range``, the range alone.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import uuid

import torch
from torch.autograd import profiler as _autograd_profiler

from .registry import get_registry

SPAN_HELP = "duration of named host spans (obs/spans.py)"

# the active span id for the current execution context; threads started
# fresh see None (their spans root a new tree), which is the honest
# answer — a loader worker's I/O is not causally inside one train window
_current: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "deepgo_obs_span", default=None)

_trace_sink = None  # process-wide span sink (a JsonlSink, or None)

# completed-span listeners (the flight recorder's ring buffer rides here);
# listeners receive the same record dict the sink gets and must never be
# able to break a traced region — exceptions are swallowed per listener
_listeners: list = []


def add_span_listener(fn) -> None:
    """Register ``fn(record: dict)`` to observe every completed span."""
    if fn not in _listeners:
        _listeners.append(fn)


def remove_span_listener(fn) -> None:
    try:
        _listeners.remove(fn)
    except ValueError:
        pass


def set_trace_sink(sink) -> None:
    """Install the process-wide span sink (``None`` disables streaming).
    The registry histogram and the profiler bridge stay active either
    way — spans are cheap enough to always aggregate."""
    global _trace_sink
    _trace_sink = sink


def get_trace_sink():
    return _trace_sink


@contextlib.contextmanager
def trace_to(sink):
    """Scoped sink installation: the experiment's train() wraps itself in
    ``trace_to(JsonlSink(<run>/trace.jsonl))`` so spans stream to the run
    directory for exactly the duration of the run, with the previous sink
    (usually None) restored even when training raises."""
    global _trace_sink
    previous = _trace_sink
    _trace_sink = sink
    try:
        yield sink
    finally:
        _trace_sink = previous


def current_span_id() -> str | None:
    return _current.get()


def capture_context() -> str | None:
    """Snapshot the current span parent for an explicit cross-thread
    handoff.

    ``contextvars`` do NOT cross thread boundaries: a span opened inside
    a worker thread (the serving dispatcher, a loader thread) roots a new
    tree even when the work is causally inside a submitting request's
    span. The fix is an explicit handoff — the submitting thread calls
    ``capture_context()`` and ships the value with the work item; the
    worker wraps its processing in ``attach_context(captured)`` so spans
    it opens parent under the submitter's span. Request tracing
    (obs/tracing.py) uses the same capture to stamp each request's
    ``parent_span``."""
    return _current.get()


@contextlib.contextmanager
def attach_context(parent_id: str | None):
    """Adopt a captured span context on THIS thread for the duration of
    the block: spans opened inside parent under ``parent_id`` (from
    ``capture_context()`` on the originating thread). Always restores the
    previous context, even when the body raises — a worker that processes
    many handoffs must not leak one request's context into the next."""
    token = _current.set(parent_id)
    try:
        yield
    finally:
        _current.reset(token)


_nvtx: bool | None = None  # whether NVTX ranges can be opened (lazy)


def _nvtx_works(torch) -> bool:
    """Whether this build can push an NVTX range (the NVTX library is
    optional in a CUDA build of PyTorch)."""
    try:
        torch.cuda.nvtx.range_push("deepgo")
        torch.cuda.nvtx.range_pop()
        return True
    except (AttributeError, RuntimeError):
        return False


@contextlib.contextmanager
def _profiler_range(name: str):
    """A ``torch.profiler.record_function`` range for ``name``, inside an
    NVTX range where CUDA is available: a span's host region lines up with
    the kernels it caused, in a torch.profiler trace and in an NVTX
    timeline. Outside a capture the range costs one profiler-op call,
    microseconds against the coarse regions spans mark."""
    global _nvtx
    if _nvtx is None:
        _nvtx = torch.cuda.is_available() and _nvtx_works(torch)
    with contextlib.ExitStack() as stack:
        if _nvtx:
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(torch.profiler.record_function(name))
        yield


class Span:
    """One open span; exposed so the body can attach fields mid-flight
    (``span.fields["step"] = n``) that land in the JSONL record."""

    __slots__ = ("name", "span_id", "parent_id", "fields", "t0_wall",
                 "t0_mono")

    def __init__(self, name: str, parent_id: str | None, fields: dict):
        self.name = name
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.fields = fields
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()


@contextlib.contextmanager
def span(name: str, registry=None, **fields):
    """Trace one named region: ``with span("validate", step=n): ...``.

    On exit the record carries span/parent ids, wall start time, duration,
    ``status`` ("ok" | "error"), and the exception repr when the body
    raised — the exception itself always propagates (observability must
    never change control flow)."""
    parent = _current.get()
    s = Span(name, parent, dict(fields))
    token = _current.set(s.span_id)
    status, error = "ok", None
    try:
        with _profiler_range(name):
            yield s
    except BaseException as e:
        status, error = "error", repr(e)
        raise
    finally:
        _current.reset(token)
        duration = time.monotonic() - s.t0_mono
        reg = registry or get_registry()
        reg.histogram("deepgo_span_seconds", SPAN_HELP).observe(
            duration, name=name, status=status)
        sink = _trace_sink
        if sink is not None or _listeners:
            record = {
                "name": s.name,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "t_start": s.t0_wall,
                "duration_s": round(duration, 9),
                "status": status,
                **s.fields,
            }
            if error is not None:
                record["error"] = error
            if sink is not None:
                try:
                    sink.write("obs_span", **record)
                except (OSError, ValueError):
                    # a full disk or a concurrently closed sink must not
                    # turn a healthy traced region into a crash
                    pass
            for fn in list(_listeners):
                try:
                    fn(dict(record))
                except Exception:  # noqa: BLE001 — observers never raise out
                    pass


_NO_RANGE = contextlib.nullcontext()


def hot_range(name: str):
    """The profiler range of a hot region (``hot_span``'s, or alone where
    nothing times the region): the ``record_function`` range ``span``
    opens, while a profiler capture runs; outside one a null context
    (torch's own flag says so for a tenth of a microsecond, where opening
    a range costs several through the dispatcher)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_RANGE


class hot_span:
    """The hot-path form of ``span``: ``with hot_span("loader.sample"): ...``.

    It opens ``hot_range(name)``, so a capture shows the region by name
    over the kernels it launched. On exit it observes its
    ``time.perf_counter()`` duration into ``deepgo_span_seconds{name,
    status}`` ("error" when the body raised; the exception propagates).
    Given ``histogram`` (a region the port already times), it observes
    into that one instead, under ``labels``, and only a region that
    returned, as the timer it replaces did. Nothing else: no id, no
    context variable, no sink line, no listener, no NVTX range."""

    __slots__ = ("_name", "_histogram", "_labels", "_range", "_t0")

    def __init__(self, name: str, histogram=None, **labels):
        self._name = name
        self._histogram = histogram
        self._labels = labels

    def __enter__(self):
        self._range = hot_range(self._name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, kind, value, traceback):
        duration = time.perf_counter() - self._t0
        self._range.__exit__(kind, value, traceback)
        if self._histogram is None:
            get_registry().histogram("deepgo_span_seconds", SPAN_HELP).observe(
                duration, name=self._name,
                status="ok" if kind is None else "error")
        elif kind is None:
            self._histogram.observe(duration, **self._labels)
        return False


class hot_laps:
    """Back-to-back hot spans on a per-dispatch path, where a ``hot_span``
    block each costs too much host time: the caller reads the clock
    (``time.perf_counter()``) at each boundary and hands the stamps over
    once, ``names[i]`` running from stamp ``i`` to stamp ``i + 1``.

    Made once per path, it binds each name's ``deepgo_span_seconds{name,
    status="ok"}`` series in the registry current then, as
    ``AsyncLoader`` binds its families: a pass costs one call and an
    observation a span. While a profiler capture runs (``capturing()``)
    the caller opens ``hot_span`` blocks of the same names instead, for
    their ranges."""

    __slots__ = ("names", "_spans", "_ok")

    def __init__(self, *names: str):
        self.names = names
        self._spans = get_registry().histogram("deepgo_span_seconds",
                                               SPAN_HELP)
        self._ok = tuple(self._spans.observer(name=n, status="ok")
                         for n in names)

    def observe(self, stamps) -> None:
        """A pass that returned: ``len(names) + 1`` stamps."""
        t0 = stamps[0]
        for ok, t1 in zip(self._ok, stamps[1:]):
            ok(t1 - t0)
            t0 = t1

    def failed(self, stamps) -> None:
        """A pass whose last span raised: the spans before it as "ok", and
        that one as "error"."""
        self.observe(stamps[:-1])
        self._spans.observe(stamps[-1] - stamps[-2],
                            name=self.names[len(stamps) - 2], status="error")


def capturing() -> bool:
    """Whether a profiler capture runs (``hot_laps``' callers switch to
    ``hot_span`` blocks then)."""
    return _autograd_profiler._is_profiler_enabled
