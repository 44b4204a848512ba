"""Runtime lock-order sanitizer (``DEEPGO_LOCKCHECK=1``).

The port's copy of ``deepgo_tpu/analysis/lockcheck.py``, the same checker
under the same switch; the port's locks are made here under the JAX
package's names, so a report reads the same in either package. The
serving dispatcher, supervisor, fleet router, replay buffer, and obs
registry each guard their state with one or two locks. Individually every
acquisition is trivially correct; what nothing else checks is the *global*
order — a dispatcher thread taking ``engine -> registry`` while another
thread takes ``registry -> engine`` is a deadlock that only fires under
production interleavings, the bug class a chaos campaign exists to surface.

Opt-in instrumentation: :func:`make_lock` / :func:`make_rlock` return a
plain ``threading.Lock``/``RLock`` unless the sanitizer is enabled (so
the hot paths — the obs registry is touched every step — pay nothing by
default), and a :class:`TrackedLock` when it is. Tracked locks maintain a
per-thread stack of held locks and a global acquired-while-holding graph:

  * edge ``A -> B`` is recorded the first time any thread acquires ``B``
    while holding ``A`` (with file:line of both acquisitions and the
    thread name — threads are named precisely so this report can
    attribute them);
  * a new edge that closes a directed cycle is an **order inversion**:
    a typed ``lock_order_cycle`` record is appended to the report and
    dumped through the obs flight recorder (flight-NNNN.json) so the
    postmortem carries the registry/span context around the detection;
  * a lock held longer than ``hold_warn_s`` (default 0.2 s) is a
    **lock-held-across-blocking-call hazard** — the cheap runtime proxy
    for "don't do I/O or a forward pass under a mutex" — reported once
    per acquisition site.

Detection never raises and never blocks the production path: the
sanitizer's own mutex is a leaf (nothing else is acquired under it), and
re-entry from the flight-recorder dump is cut by a thread-local guard.

Armed around a chaos campaign (``enable()`` before the fleet is built), a
campaign doubles as a race hunt; ``report()['cycles']`` must stay empty.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_ENV = "DEEPGO_LOCKCHECK"
_HOLD_ENV = "DEEPGO_LOCKCHECK_HOLD_S"
_force: bool | None = None


def enabled() -> bool:
    """Is the sanitizer on? Programmatic :func:`enable` wins over the
    ``DEEPGO_LOCKCHECK`` environment variable."""
    if _force is not None:
        return _force
    return os.environ.get(_ENV, "0") not in ("", "0")


def enable(on: bool = True) -> None:
    """Programmatic override (tests, bench). ``enable(None)`` restores
    environment-variable control."""
    global _force
    _force = on


def _caller_site() -> str:
    """file:line of the nearest frame outside this module — the
    acquisition site the report attributes edges to."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return "?"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


class _Sanitizer:
    """Global acquisition graph + per-thread held stacks."""

    def __init__(self, clock=time.monotonic, hold_warn_s: float | None = None):
        self.clock = clock
        if hold_warn_s is None:
            hold_warn_s = float(os.environ.get(_HOLD_ENV, "0.2"))
        self.hold_warn_s = hold_warn_s
        # leaf mutex: nothing is ever acquired while this is held
        self._mu = threading.Lock()
        self._edges: dict[str, dict[str, dict]] = {}
        self._cycles: list[dict] = []
        self._hazards: list[dict] = []
        self._seen_cycles: set[tuple] = set()
        self._seen_hazards: set[tuple] = set()
        self._locks: set[str] = set()
        self._tls = threading.local()

    # -- per-thread state --------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _reentered(self) -> bool:
        return getattr(self._tls, "busy", False)

    # -- lock registration -------------------------------------------------

    def register(self, name: str) -> None:
        with self._mu:
            self._locks.add(name)

    # -- acquisition tracking ----------------------------------------------

    def note_acquired(self, name: str, site: str) -> None:
        if self._reentered():
            return
        stack = self._stack()
        thread = threading.current_thread().name
        new_cycle = None
        with self._mu:
            for held, held_site, _t in stack:
                if held == name:  # RLock re-entry: never a self-edge
                    continue
                edge = self._edges.setdefault(held, {}).get(name)
                if edge is None:
                    edge = self._edges[held][name] = {
                        "count": 0, "site": site, "held_site": held_site,
                        "thread": thread,
                    }
                    cycle = self._find_path(name, held)
                    if cycle is not None:
                        new_cycle = self._record_cycle(
                            held, name, cycle, site, held_site, thread)
                edge["count"] += 1
        stack.append((name, site, self.clock()))
        if new_cycle is not None:
            self._report_cycle(new_cycle)

    def note_released(self, name: str) -> None:
        if self._reentered():
            return
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                _, site, t0 = stack.pop(i)
                held_s = self.clock() - t0
                if held_s > self.hold_warn_s:
                    self._record_hazard(name, site, held_s)
                return

    # -- graph analysis ----------------------------------------------------

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        """DFS for src -> ... -> dst in the edge graph (called with _mu
        held, BEFORE the new dst->src... i.e. held->name edge would close
        it). A path means the new edge completes a cycle."""
        seen = set()
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self._edges.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def _record_cycle(self, held: str, name: str, path: list[str],
                      site: str, held_site: str, thread: str) -> dict | None:
        key = tuple(sorted(set(path) | {held}))
        if key in self._seen_cycles:
            return None
        self._seen_cycles.add(key)
        record = {
            "kind": "lock_order_cycle",
            "cycle": [held] + path,  # held -> name -> ... -> held
            "edge": {"from": held, "to": name,
                     "site": site, "held_site": held_site},
            "thread": thread,
            "time": self.clock(),
        }
        self._cycles.append(record)
        return record

    def _record_hazard(self, name: str, site: str, held_s: float) -> None:
        with self._mu:
            if (name, site) in self._seen_hazards:
                return
            self._seen_hazards.add((name, site))
            self._hazards.append({
                "kind": "lock_held_across_blocking_call",
                "lock": name,
                "site": site,
                "held_s": round(held_s, 4),
                "threshold_s": self.hold_warn_s,
                "thread": threading.current_thread().name,
            })

    def _report_cycle(self, record: dict) -> None:
        """Dump the inversion through the flight recorder (outside _mu;
        the recorder's registry snapshot re-enters tracked locks, which
        the thread-local guard turns into no-ops instead of recursion)."""
        print(f"lockcheck: ORDER INVERSION {' -> '.join(record['cycle'])} "
              f"(edge {record['edge']['from']} -> {record['edge']['to']} "
              f"at {record['edge']['site']}, thread {record['thread']})",
              file=sys.stderr, flush=True)
        self._tls.busy = True
        try:
            from ..obs.sentinel import flight_dump

            flight_dump("lock_order_cycle", **record)
        except Exception:  # noqa: BLE001 — detection must never raise out
            pass
        finally:
            self._tls.busy = False

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        with self._mu:
            return {
                "enabled": enabled(),
                "locks": sorted(self._locks),
                "edges": {a: {b: e["count"] for b, e in outs.items()}
                          for a, outs in self._edges.items()},
                "cycles": list(self._cycles),
                "hazards": list(self._hazards),
            }


class TrackedLock:
    """A ``threading.Lock``/``RLock`` that reports to the sanitizer."""

    __slots__ = ("name", "_inner", "_san")

    def __init__(self, name: str, inner, san: _Sanitizer):
        self.name = name
        self._inner = inner
        self._san = san
        san.register(name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._san.note_acquired(self.name, _caller_site())
        return ok

    def release(self) -> None:
        self._san.note_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TrackedLock({self.name!r})"


_sanitizer: _Sanitizer | None = None
_sanitizer_mu = threading.Lock()


def _get() -> _Sanitizer:
    global _sanitizer
    if _sanitizer is None:
        with _sanitizer_mu:
            if _sanitizer is None:
                _sanitizer = _Sanitizer()
    return _sanitizer


def make_lock(name: str):
    """A named mutex: plain ``threading.Lock`` when the sanitizer is off
    (zero overhead — this sits on the obs-registry hot path), tracked
    when ``DEEPGO_LOCKCHECK=1``."""
    if not enabled():
        return threading.Lock()
    return TrackedLock(name, threading.Lock(), _get())


def make_rlock(name: str):
    """Reentrant flavor of :func:`make_lock` (the replay buffer's seal
    path re-enters its own mutex)."""
    if not enabled():
        return threading.RLock()
    return TrackedLock(name, threading.RLock(), _get())


def report() -> dict:
    """Snapshot of the acquisition graph, cycles, and hazards."""
    return _get().report()


def reset(clock=time.monotonic, hold_warn_s: float | None = None) -> None:
    """Discard all recorded state (tests; each scenario gets a fresh
    graph). Locks made before the reset keep reporting — into the new
    sanitizer."""
    global _sanitizer
    with _sanitizer_mu:
        _sanitizer = _Sanitizer(clock=clock, hold_warn_s=hold_warn_s)
