"""Bounded retry with exponential backoff for transient I/O faults.

The port's copy of ``deepgo_tpu/utils/retry.py``. Only exceptions in
``retry_on`` (default: ``OSError``) are retried; any other exception is a
logic error and propagates immediately. ``jitter=True`` draws each sleep
uniformly from [0, d], d the deterministic exponential delay, so callers
that fail together (every loader thread on one flaky mount) do not retry
in lockstep.
"""

from __future__ import annotations

import random
import sys
import time


def retry_with_backoff(
    fn,
    *,
    attempts: int = 5,
    base_delay: float = 0.05,
    factor: float = 2.0,
    max_delay: float = 2.0,
    retry_on: tuple = (OSError,),
    on_retry=None,
    sleep=time.sleep,
    jitter: bool = False,
    rng: random.Random | None = None,
):
    """Call ``fn()``; retry ``retry_on`` failures up to ``attempts`` total
    tries, sleeping ``base_delay * factor**k`` (capped at ``max_delay``)
    between tries, or with ``jitter=True`` a uniform draw from [0, that].
    The final failure re-raises. ``on_retry(exc, attempt, delay)`` observes
    each absorbed failure (default: a note on stderr); ``sleep`` and
    ``rng`` are injectable for tests."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if jitter and rng is None:
        rng = random.Random()
    delay = base_delay
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts:
                raise
            actual = rng.uniform(0.0, delay) if jitter else delay
            if on_retry is not None:
                on_retry(e, attempt, actual)
            else:
                print(
                    f"transient fault ({e}); retry {attempt}/{attempts - 1} "
                    f"in {actual:.2f}s",
                    file=sys.stderr,
                    flush=True,
                )
            sleep(actual)
            delay = min(delay * factor, max_delay)
