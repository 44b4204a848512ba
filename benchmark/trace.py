"""The traced run: the profiler around windows, reduced to summaries.

A run with ``--trace 1`` drives its window three times (``phases``):

- ``clock``: untraced, for the metrics read by the host clock, which the
  profiler would slow;
- ``device``: the profiler on the card's activity alone, whose cost on the
  host is small, for the card's busy and idle time and its kernels;
- ``host``: the profiler on the host's ops too, which links each kernel to
  the op that launched it (the convolutions) and tells what the host was
  doing in each idle gap. Kernel times hold under it; the host runs
  slower.

``summarize`` reduces one capture's events on this process's card to:

- ``busy_s``: the union of the intervals in which a kernel, copy or fill
  ran on the card;
- ``window_s``: the traced window, by the host clock;
- ``category_s``: device seconds by what launched the work. A kernel is
  charged to ``conv`` when a convolution op launched it (the host op that
  the profiler links to it has ``convolution`` in its name), to
  ``expand`` when its name is the expansion kernel's, else to ``other``;
- ``ops``: device seconds by kernel name;
- ``gaps``: the card's idle time between operations, charged to the
  innermost host event open at the gap's start on the thread that
  launches most of the work ("host:between_operations" when none is).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


class Capture:
    """``with Capture(host) as cap: ...`` profiles the block, the host's ops
    too where ``host``; the caller times its window inside, the card
    synchronised at both ends."""

    def __init__(self, host: bool):
        self.activities = [ProfilerActivity.CUDA]
        if host or not torch.cuda.is_available():
            self.activities.insert(0, ProfilerActivity.CPU)

    def __enter__(self):
        self._prof = profile(activities=self.activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def events(self) -> list:
        return self._prof.profiler.kineto_results.events()


def _on_device(e) -> bool:
    return e.device_type() == DeviceType.CUDA


def _annotation(e) -> bool:
    """A ``record_function`` range: on the host, or its mirror on the
    device timeline, which spans kernels and is no device work itself."""
    try:
        return bool(e.is_user_annotation())
    except AttributeError:
        return False


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, window_s: float, device_index: int) -> dict:
    """Reduce one process's profiler events (see the module docstring)."""
    device, host = [], []
    for e in events:
        if not _on_device(e):
            host.append(e)
        elif e.device_index() == device_index and not _annotation(e):
            device.append(e)
    # a device event that carries a host event's name mirrors a
    # record_function range on the device timeline
    names = {e.name() for e in host}
    device = [e for e in device if e.name() not in names]
    by_corr = {e.correlation_id(): e for e in host}
    # host events per thread, for the gaps
    threads = defaultdict(list)
    for e in host:
        if not e.name().startswith("cuda"):
            threads[e.start_thread_id()].append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    for spans in threads.values():
        spans.sort(key=lambda s: (s[0], -s[1]))
    starts = {t: [s[0] for s in spans] for t, spans in threads.items()}

    def innermost(thread, t_ns):
        """The innermost host event open at ``t_ns`` on ``thread`` (the
        latest-starting one that has not ended), or None."""
        spans = threads.get(thread, [])
        i = bisect.bisect_right(starts.get(thread, []), t_ns)
        for s, e, name in reversed(spans[max(0, i - 2000):i]):
            if e > t_ns:
                return name
        return None

    category = defaultdict(float)
    ops = defaultdict(float)
    launches = defaultdict(int)
    intervals = []
    for e in device:
        s, d = e.start_ns(), e.duration_ns()
        intervals.append((s, s + d))
        name = e.name()
        secs = d / 1e9
        ops[name] += secs
        link = by_corr.get(e.linked_correlation_id())
        if link is not None:
            launches[link.start_thread_id()] += 1
        if "expand_planes_kernel" in name:
            category["expand"] += secs
        elif link is not None and "convolution" in link.name():
            category["conv"] += secs
        else:
            category["other"] += secs
    busy = _merge(intervals)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = defaultdict(float)
    main = max(launches, key=launches.get) if launches else None
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        name = innermost(main, end) if main is not None else None
        gaps[name or "host:between_operations"] += (nxt - end) / 1e9
    return {"busy_s": busy_s, "window_s": window_s,
            "category_s": dict(category), "ops": dict(ops),
            "gaps": dict(gaps), "device_ops": len(device)}


def _label(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]+", "_", name)[:64]


def breakdown(summaries: dict, top: int = 10) -> dict:
    """The ``breakdown`` of a result line: the device operations that took
    most time (the ``device`` phase) and the longest idle gaps by what the
    host was doing (the ``host`` phase)."""
    def first(d):
        return [[_label(k), v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": first(summaries["device"]["ops"]),
            "idle_gaps": first(summaries["host"]["gaps"])}


def phases(drive, seconds: float, host_seconds: float, device_index: int
           ) -> tuple[dict, dict]:
    """Drive the window untraced, then under each capture (see the module
    docstring); ``drive(seconds)`` returns the window's counters with its
    ``window_s``. Returns (summaries, counters), each keyed by phase."""
    counters = {"clock": drive(seconds)}
    summaries = {}
    for phase, host, length in (("device", False, seconds),
                                ("host", True, host_seconds)):
        with Capture(host) as cap:
            counters[phase] = drive(length)
        summaries[phase] = summarize(cap.events(),
                                     counters[phase]["window_s"],
                                     device_index)
    return summaries, counters
