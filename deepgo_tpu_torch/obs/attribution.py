"""Step-time attribution: where each training step's wall-clock went.

The port's copy of ``deepgo_tpu/obs/attribution.py``: a pure function of a
registry snapshot, so it reads either package's runs. Of the seconds a
training run spent, how many fed the device and how many leaked into the
input pipeline, dispatch overhead, liveness bookkeeping, or checkpoint
I/O? FireCaffe (arXiv:1511.00175) and arXiv:1711.00705 frame scaling
losses exactly this way — attribute the gap or you will optimize the wrong
thing. This module decomposes the measured train-loop wall-clock
(``deepgo_train_wall_seconds_total``) into named buckets, each read from a
hot-path histogram or span the loop already feeds:

  bucket      source metric                                   meaning
  ------      -------------                                   -------
  loader_wait deepgo_loader_wait_seconds (minus inline h2d)   consumer blocked in AsyncLoader.get(): sampling + queueing
  h2d         deepgo_h2d_seconds{path=inline}                 host->device transfer paid on the consumer's clock
  compile     deepgo_train_dispatch_seconds{phase=first}      first step-call per program: first-call set-up
  dispatch    deepgo_train_dispatch_seconds{phase=steady}     host time inside warm step calls (dispatch overhead)
  compute     deepgo_train_fetch_seconds                      blocked on the window's loss fetch — the device fence
  collective  deepgo_collective_seconds                       host-side cross-host array assembly (multi-process runs)
  checkpoint  deepgo_span_seconds{name=checkpoint_save}       periodic checkpoint writes
  validate    deepgo_span_seconds{name=validate}              validation passes
  liveness    deepgo_train_hook_seconds                       window hook: heartbeat write + ledger poll + liveness check
                                                              (the port's part=window series: metrics lines, progress print, flight tick)

Everything not covered is the **residual**, reported explicitly (the
acceptance bar: >= 95 % of wall-clock attributed on a dryrun train, the
rest named, never hidden). ``useful_compute_fraction`` is the compute
bucket's share — a *lower bound* on device utilization, since device work
overlapped with host-side stages (async dispatch) is invisible to a
host-clock decomposition.

Cross-host: each elastic host snapshots its registry into its own
``elastic-NNNN.jsonl`` stream at shutdown, so ``attribute_run`` joins the
per-host decompositions and reports the FireCaffe-style scaling view:
per-host samples/sec, fleet aggregate, and the per-host non-compute
fractions that bound scaling efficiency.

When the snapshot carries the cost-ledger gauges (obs/costmodel.py —
the train loop prices its own step at start), the decomposition
gains a ``roofline`` block: achieved FLOP/s and MFU against the recorded
platform peak, so "the compute bucket is 60% of wall" and "that compute
ran at 4% MFU" finally live in one table.

Consumer: the offline run report (``obs/report.py``) appends the
attribution table.
"""

from __future__ import annotations

import glob
import os

# (bucket, metric, label filter or None) — the decomposition table above,
# in display order. Label filters match series whose labels are a superset.
_BUCKETS = (
    ("loader_wait", "deepgo_loader_wait_seconds", None),
    ("h2d", "deepgo_h2d_seconds", {"path": "inline"}),
    ("compile", "deepgo_train_dispatch_seconds", {"phase": "first"}),
    ("dispatch", "deepgo_train_dispatch_seconds", {"phase": "steady"}),
    ("compute", "deepgo_train_fetch_seconds", None),
    ("collective", "deepgo_collective_seconds", None),
    ("checkpoint", "deepgo_span_seconds", {"name": "checkpoint_save"}),
    ("validate", "deepgo_span_seconds", {"name": "validate"}),
    ("liveness", "deepgo_train_hook_seconds", None),
)


def _parse_label(label: str) -> dict:
    """The snapshot's ``"k=v,k2=v2"`` series key back into a dict."""
    if not label:
        return {}
    out = {}
    for part in label.split(","):
        k, _, v = part.partition("=")
        out[k] = v
    return out


def _series_sum(metrics: dict, name: str, where: dict | None = None,
                field: str = "sum") -> float:
    """Sum one field over a metric's matching series in a registry
    snapshot (the ``{name: {kind, series: {label: snap}}}`` shape that
    ``obs_snapshot`` events and ``MetricsRegistry.snapshot()`` carry)."""
    m = metrics.get(name)
    if not m:
        return 0.0
    total = 0.0
    for label, snap in m.get("series", {}).items():
        if where is not None:
            labels = _parse_label(label)
            if any(labels.get(k) != str(v) for k, v in where.items()):
                continue
        if isinstance(snap, dict):
            total += float(snap.get(field) or 0.0)
        elif snap is not None:
            total += float(snap)  # counter/gauge series are bare numbers
    return total


def _series_one(metrics: dict, name: str, where: dict | None = None):
    """First matching series value (gauges/counters are bare numbers in a
    snapshot) or None — for metrics that carry exactly one relevant
    series, where summing label sets would double count."""
    m = metrics.get(name)
    if not m:
        return None
    for label, value in m.get("series", {}).items():
        if where is not None:
            labels = _parse_label(label)
            if any(labels.get(k) != str(v) for k, v in where.items()):
                continue
        if value is not None and not isinstance(value, dict):
            return float(value)
    return None


def _roofline_from_snapshot(metrics: dict, wall: float,
                            steps: float) -> dict | None:
    """The MFU join: the train step's cost-ledger gauges (written by
    Experiment at train start, obs/costmodel.py) against the measured
    wall-clock and step count of the same snapshot. The ledger rides in
    the snapshot itself — including the detected platform peak — so the
    join works offline on another machine (the report over a copied run
    dir) without re-detecting hardware it cannot see. MFU is against ONE
    chip's peak — on a data-parallel host the ratio reads as host-level
    utilization only when the whole batch fit one chip's program."""
    flops = _series_one(metrics, "deepgo_cost_flops", {"fn": "train_step"})
    if not flops or not steps or not wall:
        return None
    achieved = flops * steps / wall
    out = {
        "flops_per_step": flops,
        "achieved_flops_per_s": round(achieved),
    }
    peak = _series_one(metrics, "deepgo_cost_peak_flops_per_sec")
    bw = _series_one(metrics, "deepgo_cost_peak_hbm_bytes_per_sec")
    bytes_ = _series_one(metrics, "deepgo_cost_bytes", {"fn": "train_step"})
    out["mfu"] = round(achieved / peak, 6) if peak else None
    if bytes_:
        ai = flops / bytes_
        out["arithmetic_intensity"] = round(ai, 3)
        if peak and bw:
            out["bound"] = "compute" if ai >= peak / bw else "memory"
    hbm = _series_one(metrics, "deepgo_cost_hbm_peak_bytes",
                      {"fn": "train_step"})
    if hbm is not None:
        out["hbm_peak_bytes"] = hbm
    return out


def attribute_snapshot(metrics: dict) -> dict | None:
    """Decompose one registry snapshot's train wall-clock into buckets.

    Returns None when the snapshot carries no
    ``deepgo_train_wall_seconds_total`` (nothing trained in that process,
    so there is no denominator to attribute against)."""
    wall = _series_sum(metrics, "deepgo_train_wall_seconds_total")
    if wall <= 0:
        return None
    buckets: dict[str, dict] = {}
    attributed = 0.0
    for bucket, metric, where in _BUCKETS:
        seconds = _series_sum(metrics, metric, where)
        if bucket == "loader_wait":
            # inline h2d happens *inside* get(): carve it out so the two
            # buckets partition the loader time instead of double counting
            seconds = max(0.0, seconds - _series_sum(
                metrics, "deepgo_h2d_seconds", {"path": "inline"}))
        if seconds <= 0:
            continue
        buckets[bucket] = {
            "seconds": round(seconds, 6),
            "fraction": round(seconds / wall, 4),
        }
        attributed += seconds
    residual = wall - attributed
    steps = _series_sum(metrics, "deepgo_train_steps_total")
    samples = _series_sum(metrics, "deepgo_train_samples_total")
    out = {
        "wall_s": round(wall, 6),
        "buckets": buckets,
        "attributed_fraction": round(attributed / wall, 4),
        # residual may legitimately go slightly negative when a bucketed
        # stage ran outside the measured loop (e.g. warmup before the
        # clock started); report it signed — honesty over cosmetics
        "residual_s": round(residual, 6),
        "residual_fraction": round(residual / wall, 4),
        "useful_compute_fraction": round(
            buckets.get("compute", {}).get("seconds", 0.0) / wall, 4),
        "steps": int(steps),
    }
    if samples and wall:
        out["samples_per_sec"] = round(samples / wall, 1)
    roofline = _roofline_from_snapshot(metrics, wall, steps)
    if roofline is not None:
        out["roofline"] = roofline
    # h2d paid off the consumer's clock (uploader thread) overlaps with
    # compute — outside the decomposition, reported for completeness
    overlapped = _series_sum(metrics, "deepgo_h2d_seconds",
                             {"path": "uploader"})
    if overlapped:
        out["overlapped_h2d_s"] = round(overlapped, 6)
    return out


def attribute_run(run_dir: str) -> dict | None:
    """The per-run attribution: per-host decompositions joined across the
    elastic streams when present, else the single-host ``metrics.jsonl``
    close-time snapshot. Returns None when no snapshot exists (a run that
    never trained, or predates this instrumentation)."""
    from .report import read_events

    hosts: dict[str, dict] = {}
    for p in sorted(glob.glob(os.path.join(run_dir, "elastic-*.jsonl"))):
        snaps = [r for r in read_events(p) if r.get("kind") == "obs_snapshot"]
        if not snaps:
            continue
        att = attribute_snapshot(snaps[-1].get("metrics", {}))
        if att is not None:
            host = snaps[-1].get("host")
            if host is None:  # fall back to the stream's file id
                host = os.path.basename(p).split("-")[1].split(".")[0]
            hosts[str(host)] = att
    if not hosts:
        snaps = [r for r in
                 read_events(os.path.join(run_dir, "metrics.jsonl"))
                 if r.get("kind") == "obs_snapshot"]
        if snaps:
            att = attribute_snapshot(snaps[-1].get("metrics", {}))
            if att is not None:
                hosts["0"] = att
    if not hosts:
        return None
    out: dict = {"hosts": hosts, "num_hosts": len(hosts)}
    if len(hosts) > 1:
        # the FireCaffe-style scaling view: each host's useful-compute
        # fraction bounds how efficiently added hosts can possibly pay off
        # (time not spent computing does not scale down with more hosts)
        sps = {h: a.get("samples_per_sec") for h, a in hosts.items()}
        known = [v for v in sps.values() if v]
        fracs = [a["useful_compute_fraction"] for a in hosts.values()]
        out["scaling"] = {
            "per_host_samples_per_sec": sps,
            "aggregate_samples_per_sec": round(sum(known), 1),
            "useful_compute_fraction_min": round(min(fracs), 4),
            "useful_compute_fraction_mean": round(
                sum(fracs) / len(fracs), 4),
            "non_compute_fraction_mean": round(
                1.0 - sum(fracs) / len(fracs), 4),
        }
    return out


def format_attribution(att: dict) -> str:
    """Fixed-width rendering of ``attribute_run``'s output, one column
    per host — the table the run report appends."""
    hosts = att["hosts"]
    ids = sorted(hosts)
    names = [b for b, _, _ in _BUCKETS]
    lines = [f"step-time attribution ({len(ids)} host"
             f"{'s' if len(ids) != 1 else ''}):"]
    header = ["bucket"] + [f"host{h}_s (frac)" for h in ids]
    rows = []
    for bucket in names:
        if not any(bucket in hosts[h]["buckets"] for h in ids):
            continue
        row = [bucket]
        for h in ids:
            b = hosts[h]["buckets"].get(bucket)
            row.append(f"{b['seconds']:.3f} ({b['fraction']:.1%})"
                       if b else "-")
        rows.append(row)
    for label, key in (("(residual)", "residual_s"), ("wall", "wall_s")):
        row = [label]
        for h in ids:
            v = hosts[h][key]
            if key == "residual_s":
                row.append(f"{v:.3f} ({hosts[h]['residual_fraction']:.1%})")
            else:
                row.append(f"{v:.3f}")
        rows.append(row)
    widths = [max(len(header[i]), *(len(r[i]) for r in rows))
              for i in range(len(header))]
    lines.append("  ".join(c.ljust(w) for c, w in zip(header, widths)))
    lines.append("  ".join("-" * w for w in widths))
    for r in rows:
        lines.append("  ".join(v.ljust(w) for v, w in zip(r, widths)))
    for h in ids:
        a = hosts[h]
        extra = (f"  host{h}: attributed {a['attributed_fraction']:.1%}, "
                 f"useful compute {a['useful_compute_fraction']:.1%}")
        if a.get("samples_per_sec"):
            extra += f", {a['samples_per_sec']:.0f} samples/sec"
        lines.append(extra)
        roof = a.get("roofline")
        if roof:
            mfu = (f"MFU {roof['mfu']:.2%}" if roof.get("mfu") is not None
                   else "MFU unknown (no platform peak)")
            line = (f"  host{h} roofline: {mfu}, "
                    f"{roof['achieved_flops_per_s'] / 1e9:.1f} GFLOP/s "
                    "achieved")
            if roof.get("bound"):
                line += f", {roof['bound']}-bound"
            lines.append(line)
    scaling = att.get("scaling")
    if scaling:
        lines.append(
            f"  fleet: {scaling['aggregate_samples_per_sec']:.0f} "
            f"samples/sec aggregate; mean useful-compute "
            f"{scaling['useful_compute_fraction_mean']:.1%} (bounds "
            f"scaling efficiency; the "
            f"{scaling['non_compute_fraction_mean']:.1%} non-compute "
            f"share does not shrink with more hosts)")
    return "\n".join(lines)
