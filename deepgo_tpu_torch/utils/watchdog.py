"""External-process watchdog for a blocked call.

The port's copy of ``deepgo_tpu/utils/watchdog.py``. A call wedged inside C
code that holds the GIL (a collective whose peer died, a rendezvous that
never answers) cannot be interrupted by a signal handler or a timer thread
of its own process. The watchdog is another *process*: a child, started
without ``PYTHONPATH``, polls its parentage once a second; if the parent is
still alive after ``timeout_s`` it prints a diagnostic (optionally a JSON
line on stdout) and SIGKILLs it.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys


def _poll_count(timeout_s: float) -> int:
    """1-second child polls needed to cover ``timeout_s``, rounded UP.

    ``int()`` truncation made ``timeout_s=1.5`` fire after ~1s — an early
    kill is strictly worse than a late one for a watchdog (it murders a
    healthy process), so fractional budgets always round away from the
    trigger. The minimum of one poll keeps a zero/negative budget from
    producing an instant kill loop."""
    return max(1, math.ceil(float(timeout_s)))


class Watchdog:
    """Handle for an armed watchdog child; ``disarm()`` on success."""

    def __init__(self, proc: subprocess.Popen | None):
        self._proc = proc

    def disarm(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                self._proc.kill()
                self._proc.wait()
            self._proc = None


def arm(label: str, timeout_s: float = 120.0,
        diagnostic_json: str | None = None, flight: bool = False) -> Watchdog:
    """Arm an external watchdog that SIGKILLs this process after timeout_s.

    The child exits on its own when this process finishes (reparenting
    check), so even an un-disarmed watchdog cannot kill an innocent later
    process. ``diagnostic_json``, if given, is printed verbatim to the
    shared stdout right before the kill so line-oriented consumers still
    get a parseable record. Disabling is the caller's job (each surface
    owns its knob, e.g. BENCH_WATCHDOG / GRAFT_WATCHDOG): pass through to
    ``Watchdog(None)`` there rather than arming.

    ``flight=True`` sends the parent SIGUSR1 one second before the kill —
    the flight-recorder grace signal (obs/sentinel.install_signal_dump):
    a parent wedged at the *Python* level (deadlocked threads, a stuck
    queue wait) dumps its ring-buffer black box before dying. Only pass
    it after installing the handler: SIGUSR1's default action terminates.
    A parent wedged inside a GIL-held C call cannot run the handler — the
    kill still proceeds, just without the dump."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    lines = [
        "import os, signal, sys, time",
        f"ppid = {os.getpid()}",
        f"label = {str(label)!r}",
        f"for _ in range({_poll_count(timeout_s)}):",
        "    time.sleep(1)",
        "    if os.getppid() != ppid:",
        "        sys.exit(0)",
    ]
    if flight:
        lines += [
            "try:",
            "    os.kill(ppid, signal.SIGUSR1)",
            "    time.sleep(1)",
            "except OSError:",
            "    sys.exit(0)",
        ]
    if diagnostic_json is not None:
        lines += [
            f"sys.stdout.write({diagnostic_json + chr(10)!r})",
            "sys.stdout.flush()",
        ]
    lines += [
        "sys.stderr.write('watchdog: %s still blocked after "
        f"{float(timeout_s)}s (device claim likely wedged); "
        "killing %d\\n' % (label, ppid))",
        "sys.stderr.flush()",
        "os.kill(ppid, signal.SIGKILL)",
    ]
    proc = subprocess.Popen([sys.executable, "-c", "\n".join(lines)], env=env)
    return Watchdog(proc)
