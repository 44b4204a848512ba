"""Deterministic fault injection for exercising the crash-safety paths.

The port's copy of ``deepgo_tpu/utils/faults.py``: the same grammar and
counters, so one plan string gives the same plan, and the same due/not-due
sequence at every site, in either package. A ``FaultPlan`` is parsed from
the ``DEEPGO_FAULTS`` environment variable (or installed programmatically /
via ``ExperimentConfig.faults``) and consulted at named *fault points*. The
sites the port checks:

  site             where it fires
  ----             ---------------
  ckpt_write       inside the atomic checkpoint write (checkpoint.save_checkpoint)
  loader_io        the memmap gather in GoDataset.batch_at
  train_step       just before a training step executes (experiment._train,
                   and each step of the loop's learner window)
  kill             after a training step completes, keyed on the step number
                   (the experiment's and the loop learner's global step)
  dist_collective  host-side before every step call of an elastic run
  serving_dispatch the serving dispatcher loop, once per coalescing window,
                   OUTSIDE the per-batch containment — an injected fault
                   here kills the dispatcher thread (the death the
                   SupervisedEngine restart absorbs); the replica-scoped
                   ``serving_dispatch.<engine name>`` kills one engine
  serving_forward  inside the serving dispatch, alongside the forward — an
                   injected fault here fails ONE coalesced batch
                   (BatchDispatchError; the poison-isolation path)
  serving_slow     (gray, ``maybe_slow``) inside the timed dispatch window
  serving_corrupt  (gray, ``corrupt_due``) on the rows after the
                   device-to-host copy
  fleet_route      inside each FleetRouter placement attempt — absorbed
                   like a replica failure: the candidate is excluded, the
                   request re-routes, the failover counter ticks
  fleet_reload     once per replica swap during a rolling weight reload —
                   a fault surfaces as a typed FleetReloadError while the
                   draining replica rejoins and the fleet keeps serving
  loop_ingest      inside ReplayBuffer.ingest_game (loop/replay.py) —
                   transients are absorbed by the bounded-jitter retry,
                   hard faults kill the actor BEFORE the game is acked
                   (the loop supervisor restarts it; acked games are
                   already durable, so none are ever lost)
  loop_gate        at the start of ArenaGatekeeper.evaluate — a hard
                   fault kills the gatekeeper component; the service
                   re-queues the challenger so the restarted gatekeeper
                   re-gates it instead of dropping the window
  session_wal      inside the session store's fsync'd WAL append
                   (sessions/store.py), BEFORE the ack — transients are
                   absorbed by the bounded retry, hard faults surface typed
                   with the move un-acked and the in-memory game untouched
  session_reply    per engine-reply attempt in the interactive game
                   service (sessions/service.py), before the fleet
                   submit — a transient burns one deadline tier and
                   escalates to the next budget; a hard fault surfaces
                   typed (the session state is unchanged either way)

Every injected fault is a Python exception, a sleep or a perturbed host
row at a fault site, never a device fault.

Grammar (comma-separated ``site:kind@arg`` specs):

  DEEPGO_FAULTS="ckpt_write:fail@2,loader_io:transient@5,kill:step@7"

  fail@N       the Nth hit of the site raises InjectedFailure (a hard,
               non-retryable fault; later hits succeed)
  transient@N  the first N hits raise TransientFault — an OSError, so
               retry_with_backoff absorbs it like a real flaky filesystem
  step@K       (kill site only) SIGKILL this process once the training
               step counter reaches K: no cleanup, no atexit, the honest
               preemption
  slow@MS      GRAY failure: every hit of the site sleeps MS milliseconds
               while the spec is installed — a brownout, not a crash. The
               site stays alive and "healthy"; only its latency lies.
               Consulted through ``maybe_slow``, never raised.
  corrupt@N    GRAY failure: the first N hits return silently WRONG
               output — the site must ask ``corrupt_due`` and perturb its
               own result. Nothing raises; the corruption is only
               detectable by checking answers.

Gray kinds (slow/corrupt) are value-consulted, not raise-based:
``check()`` ignores them entirely, so a site that only calls ``check``
never pays for — or trips over — a gray spec aimed elsewhere. Sites
that support gray faults consult ``maybe_slow(site, name)`` /
``corrupt_due(site, name)``, which also match the replica-scoped form
``site.<name>`` — ``serving_slow.fleet-1:slow@40`` brownouts exactly
one replica of a fleet while its peers stay fast.

The plan is process-local mutable state on purpose: counters advance as
sites are hit, which is what makes "fail the 2nd write" expressible.
``add``/``remove`` mutate the installed plan in place, which is what
lets a test open and close fault windows on a timeline instead of
arming everything at t=0.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from dataclasses import dataclass, field


class FaultError(Exception):
    """Base for injected faults (never raised by real I/O)."""


class InjectedFailure(FaultError, RuntimeError):
    """A hard injected fault: not retryable, must surface or be survived
    by design (e.g. a failed periodic checkpoint keeps training)."""


class TransientFault(FaultError, OSError):
    """A transient injected fault. Subclasses OSError so the production
    retry policy (retry_with_backoff's default ``retry_on``) treats it
    exactly like a real transient I/O error."""


_KINDS = ("fail", "transient", "step", "slow", "corrupt")

# the raise/kill kinds check() owns; slow/corrupt are value-consulted
_CHECK_KINDS = ("fail", "transient", "step")


@dataclass
class FaultSpec:
    site: str
    kind: str  # one of _KINDS
    arg: int
    hits: int = field(default=0, compare=False)
    fired: bool = field(default=False, compare=False)


class FaultPlan:
    """A parsed set of fault specs, counters included."""

    def __init__(self, specs: list[FaultSpec]):
        self.specs = specs

    def __bool__(self) -> bool:
        return bool(self.specs)

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        specs = []
        for raw in (text or "").split(","):
            raw = raw.strip()
            if not raw:
                continue
            site, sep, rest = raw.partition(":")
            kind, sep2, arg = rest.partition("@")
            if not sep or not sep2 or not site or kind not in _KINDS:
                raise ValueError(
                    f"bad fault spec {raw!r}: expected site:kind@arg with "
                    f"kind in {_KINDS} (e.g. ckpt_write:fail@2, "
                    f"loader_io:transient@5, kill:step@7)"
                )
            try:
                arg_n = int(arg)
            except ValueError:
                raise ValueError(
                    f"bad fault spec {raw!r}: arg must be an integer"
                ) from None
            if arg_n < 1:
                raise ValueError(f"bad fault spec {raw!r}: arg must be >= 1")
            if (kind == "step") != (site == "kill"):
                raise ValueError(
                    f"bad fault spec {raw!r}: step@K is for the kill site; "
                    f"other sites take fail@N or transient@N"
                )
            specs.append(FaultSpec(site, kind, arg_n))
        return cls(specs)

    def add(self, text: str) -> list[FaultSpec]:
        """Parse ``text`` and merge its specs into this plan (counters of
        existing specs untouched). Returns the specs added."""
        added = FaultPlan.parse(text).specs
        self.specs.extend(added)
        return added

    def remove(self, site: str, kind: str | None = None) -> int:
        """Drop every spec at ``site`` (optionally only of ``kind``);
        returns how many were removed. Closing a fault window."""
        keep, dropped = [], 0
        for spec in self.specs:
            if spec.site == site and (kind is None or spec.kind == kind):
                dropped += 1
            else:
                keep.append(spec)
        self.specs[:] = keep
        return dropped

    def slow_s(self, site: str) -> float:
        """Total injected delay (seconds) due at this hit of ``site`` —
        0.0 when no slow spec matches. Advances slow hit counters."""
        total = 0.0
        for spec in self.specs:
            if spec.kind == "slow" and spec.site == site:
                spec.hits += 1
                total += spec.arg / 1000.0
        return total

    def corrupt_hit(self, site: str) -> bool:
        """True when a corrupt spec at ``site`` still owes corruption
        (first N hits). Advances corrupt hit counters."""
        due = False
        for spec in self.specs:
            if spec.kind == "corrupt" and spec.site == site:
                spec.hits += 1
                if spec.hits <= spec.arg:
                    due = True
        return due

    def check(self, site: str, step: int | None = None) -> None:
        """Advance counters for ``site``; raise / kill if a spec is due.
        Gray kinds (slow/corrupt) are ignored here — they are consulted
        by value through ``maybe_slow`` / ``corrupt_due``."""
        for spec in self.specs:
            if spec.site != site or spec.kind not in _CHECK_KINDS:
                continue
            if spec.kind == "step":
                if step is None or spec.fired:
                    continue
                if step >= spec.arg:
                    spec.fired = True
                    print(
                        f"fault injection: SIGKILL at step {step} "
                        f"(kill:step@{spec.arg})",
                        file=sys.stderr,
                        flush=True,
                    )
                    sys.stdout.flush()
                    os.kill(os.getpid(), signal.SIGKILL)
                continue
            spec.hits += 1
            if spec.kind == "fail" and spec.hits == spec.arg:
                raise InjectedFailure(
                    f"injected hard fault at {site} (hit {spec.hits})"
                )
            if spec.kind == "transient" and spec.hits <= spec.arg:
                raise TransientFault(
                    f"injected transient fault at {site} "
                    f"(hit {spec.hits}/{spec.arg})"
                )


_plan: FaultPlan | None = None


def active_plan() -> FaultPlan:
    """The process-wide plan, lazily parsed from DEEPGO_FAULTS."""
    global _plan
    if _plan is None:
        _plan = FaultPlan.parse(os.environ.get("DEEPGO_FAULTS", ""))
    return _plan


def install(plan: FaultPlan | str) -> FaultPlan:
    """Replace the active plan (tests, or ExperimentConfig.faults)."""
    global _plan
    _plan = FaultPlan.parse(plan) if isinstance(plan, str) else plan
    return _plan


def reset() -> None:
    """Drop the active plan; the next check() re-reads DEEPGO_FAULTS."""
    global _plan
    _plan = None


def check(site: str, step: int | None = None) -> None:
    """Fault point hook. A no-op (one truthiness test) when no plan is
    configured, so production paths pay nothing for carrying it."""
    plan = active_plan()
    if plan:
        plan.check(site, step)


def add(text: str) -> list[FaultSpec]:
    """Merge specs into the active plan (a fault window opens)."""
    return active_plan().add(text)


def remove(site: str, kind: str | None = None) -> int:
    """Remove specs at ``site`` from the active plan."""
    plan = _plan
    return plan.remove(site, kind) if plan is not None else 0


def maybe_slow(site: str, name: str | None = None,
               sleep=time.sleep) -> float:
    """Gray-failure hook: sleep any injected brownout delay due at
    ``site`` (and, when ``name`` is given, at the replica-scoped site
    ``site.name``); returns the seconds slept. The sleep happens HERE,
    inside the faults harness, so serving code never needs a bare
    time.sleep for injection."""
    plan = active_plan()
    if not plan:
        return 0.0
    delay = plan.slow_s(site)
    if name is not None:
        delay += plan.slow_s(f"{site}.{name}")
    if delay > 0.0:
        sleep(delay)
    return delay


def corrupt_due(site: str, name: str | None = None) -> bool:
    """Gray-failure hook: True when this hit of ``site`` (or of the
    replica-scoped ``site.name``) must return a corrupted result. The
    call site owns the perturbation; this only answers "is it due"."""
    plan = active_plan()
    if not plan:
        return False
    due = plan.corrupt_hit(site)
    if name is not None:
        due = plan.corrupt_hit(f"{site}.{name}") or due
    return due
