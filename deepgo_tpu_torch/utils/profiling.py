"""Profiler integration.

The port of ``deepgo_tpu/utils/profiling.py`` on ``torch.profiler``: a
context manager that captures a host and device trace of a region into a
Chrome trace file. Host-side spans (``deepgo_tpu_torch.obs.spans``) open
``record_function`` ranges, so a capture taken here shows the obs stages
on the host timeline above the kernels they launched.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


# Device work between enabling the capture's device tracing and opening its
# window. On an H100 the first device records of a capture can carry
# timestamps that the profiler places outside its window, and it drops them:
# a profiled run then lost the first train step's kernels from its trace.
# The warm-up's own records take that place and fall before the window.
WARMUP_OPS = 64
WARMUP_S = 0.25


def _warm_up() -> None:
    x = torch.zeros(1, device="cuda")
    for _ in range(WARMUP_OPS):
        x.add_(1.0)
    torch.cuda.synchronize()
    time.sleep(WARMUP_S)


@contextlib.contextmanager
def trace(out_dir: str | None, metrics=None):
    """Capture a host (and, where CUDA is available, device) trace into
    ``out_dir/trace.json`` (no-op when ``out_dir`` is None); yields the
    ``torch.profiler.profile`` (None when off).

    On CUDA the window opens after a short device warm-up (``WARMUP_OPS``
    tiny kernels, then ``WARMUP_S`` seconds) and closes after the device
    has finished the region's work, so every kernel the region launched
    is in the trace. A raised start (a profiler already active on this
    thread) is cleaned up before propagating: the stop is attempted so no
    half-started session dangles into the next capture. ``metrics`` (a
    MetricsWriter/JsonlSink) gets a ``profile_trace`` event naming the
    output dir, so traces are discoverable from the run's event stream."""
    if not out_dir:
        yield None
        return
    os.makedirs(out_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.prepare_trace()
        if cuda:
            _warm_up()
        prof.start_trace()
    except Exception:
        # a partially-started session would poison every later capture;
        # best-effort stop, then surface the original failure
        try:
            prof.stop_trace()
        except Exception:  # noqa: BLE001 — the start's error is the one to see
            pass
        raise
    if metrics is not None:
        metrics.write("profile_trace", out_dir=os.path.abspath(out_dir))
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop_trace()
        prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))

