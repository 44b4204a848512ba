"""Deterministic fault injection for exercising the crash-safety paths.

The port's copy of the raise-and-kill half of ``deepgo_tpu/utils/faults.py``.
A ``FaultPlan`` is parsed from the ``DEEPGO_FAULTS`` environment variable
(or installed programmatically / via ``ExperimentConfig.faults``) and
consulted at named fault points. The sites the port checks:

  site             where it fires
  ----             ---------------
  ckpt_write       inside the atomic checkpoint write (checkpoint.save_checkpoint)
  loader_io        the memmap gather in GoDataset.batch_at
  train_step       just before a training step executes (experiment._train)
  kill             after a training step completes, keyed on the step number
  dist_collective  host-side before every step call of an elastic run

Grammar (comma-separated ``site:kind@arg`` specs), as in the JAX package:

  DEEPGO_FAULTS="ckpt_write:fail@2,loader_io:transient@5,kill:step@7"

  fail@N       the Nth hit of the site raises InjectedFailure
  transient@N  the first N hits raise TransientFault (an OSError, so
               retry_with_backoff absorbs it)
  step@K       (kill site only) SIGKILL this process once the training step
               counter reaches K
  slow@MS, corrupt@N  parsed as in the JAX package; ``check`` ignores them
               (their sites, in serving, are not ported yet)

The plan is process-local mutable state on purpose: counters advance as
sites are hit, which is what makes "fail the 2nd write" expressible.
"""

from __future__ import annotations

import os
import signal
import sys
from dataclasses import dataclass, field


class FaultError(Exception):
    """Base for injected faults (never raised by real I/O)."""


class InjectedFailure(FaultError, RuntimeError):
    """A hard injected fault: not retryable."""


class TransientFault(FaultError, OSError):
    """A transient injected fault; an OSError, so the retry policy treats
    it like a real transient I/O error."""


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

    def check(self, site: str, step: int | None = None) -> None:
        """Advance counters for ``site``; raise / kill if a spec is due."""
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
    """Fault point hook: one truthiness test when no plan is configured."""
    plan = active_plan()
    if plan:
        plan.check(site, step)
