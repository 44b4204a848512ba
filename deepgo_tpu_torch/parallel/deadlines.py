"""Deadline-wrapped process-group bootstrap and first step.

The port of ``deepgo_tpu/parallel/deadlines.py``. A wedged collective, or
a rendezvous dialing a coordinator that will never answer, blocks inside a
C call holding the GIL, so no in-process timer can interrupt it. The
external-process watchdog (``utils/watchdog.py``) is armed around the two
places a multi-process job can wedge forever:

  * **bootstrap** — ``initialize_with_deadline`` retries the rendezvous
    with bounded full-jitter backoff, wraps reachability failures in a
    typed ``CoordinatorUnreachable``, and keeps the watchdog armed across
    the whole retry envelope, so a *hanging* dial still dies loud.
  * **the first step** — ``guard_first_call`` arms the watchdog around a
    step function's first call only (the first collective, synchronised
    to completion inside the guard); later calls pass straight through.

The ``dist_init`` fault site fires inside the retried bootstrap attempt
(transients are absorbed by the retry, hard faults surface).
"""

from __future__ import annotations

import contextlib
import functools
import time

from ..utils import watchdog
from ..utils.retry import retry_with_backoff
from . import distributed
from .liveness import CoordinatorUnreachable


def _reachability_errors() -> tuple:
    """Exception types that mean "the rendezvous is not answering" (as
    opposed to a logic error): OS-level connect failures plus the
    network and store errors ``torch.distributed`` raises."""
    import torch.distributed as dist

    return (ConnectionError, OSError, TimeoutError, dist.DistNetworkError,
            dist.DistStoreError)


@contextlib.contextmanager
def deadline(label: str, timeout_s: float, diagnostic_json: str | None = None,
             arm=watchdog.arm):
    """Arm the external watchdog for the duration of the block; a block
    that outlives ``timeout_s`` is SIGKILLed (loud, diagnosable) instead of
    hanging. ``timeout_s <= 0`` disables (yields an unarmed handle)."""
    wd = (arm(label, timeout_s, diagnostic_json=diagnostic_json)
          if timeout_s and timeout_s > 0 else watchdog.Watchdog(None))
    try:
        yield wd
    finally:
        wd.disarm()


def initialize_with_deadline(coordinator: str | None = None,
                             num_processes: int | None = None,
                             process_id: int | None = None, *,
                             timeout_s: float = 120.0,
                             attempts: int = 5,
                             base_delay: float = 0.5,
                             max_delay: float = 8.0,
                             rng=None,
                             sleep=time.sleep,
                             arm=watchdog.arm, device="cuda") -> None:
    """Join the default process group, loudly bounded in time.

    Reachability failures (connect refused or reset, a store that times
    out, injected ``dist_init`` transients) are
    retried up to ``attempts`` times with **full-jitter** exponential
    backoff — every host observed the same coordinator restart at the same
    instant, and deterministic delays would re-synchronize the herd into
    thundering re-dials. The final failure raises a typed
    ``CoordinatorUnreachable`` naming the coordinator. A dial that *hangs*
    instead of failing is SIGKILLed by the external watchdog after
    ``timeout_s`` (0 disables). Hard injected faults (``dist_init:fail@N``)
    are logic-level and propagate immediately, un-retried.

    Single-process runs (no coordinator, ``num_processes=1``) stay the
    no-op they always were — minus the armed watchdog, which still
    protects the (local, instant) bootstrap path at negligible cost.
    """
    reach = _reachability_errors()

    def attempt() -> None:
        try:
            distributed.initialize(coordinator, num_processes, process_id,
                                   device=device)
        except reach as e:
            raise CoordinatorUnreachable(
                f"coordinator {coordinator or '<auto>'} unreachable: "
                f"{type(e).__name__}: {e}") from e

    with deadline(f"dist-init({coordinator or 'local'})", timeout_s, arm=arm):
        retry_with_backoff(
            attempt,
            attempts=attempts,
            base_delay=base_delay,
            max_delay=max_delay,
            retry_on=(CoordinatorUnreachable,),
            jitter=True,
            rng=rng,
            sleep=sleep,
        )


def _synchronize(out) -> None:
    """Wait for the CUDA work behind every tensor in ``out``."""
    import torch

    stack = [out]
    devices = set()
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            if item.is_cuda:
                devices.add(item.device)
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
        elif isinstance(item, dict):
            stack.extend(item.values())
    for device in devices:
        torch.cuda.synchronize(device)


def guard_first_call(fn, label: str, timeout_s: float, arm=watchdog.arm):
    """Wrap a step function so its FIRST call runs under the external
    watchdog and is synchronised to completion.

    The first step is where a broken multi-process job wedges: its first
    all-reduce needs every participant, so one dead peer turns the call
    into a silent hang. Synchronising on the outputs inside the guard
    makes the deadline cover *execution*, not just the enqueue. Every
    later call passes through untouched — steady-state steps are watched
    by the heartbeat ledger, not a per-call watchdog."""
    state = {"first_done": False}

    @functools.wraps(fn)
    def guarded(*args, **kwargs):
        if state["first_done"]:
            return fn(*args, **kwargs)
        with deadline(label, timeout_s, arm=arm):
            out = fn(*args, **kwargs)
            _synchronize(out)
        state["first_done"] = True
        return out

    return guarded
