"""Device cost-model ledger: roofline / MFU attribution per entrypoint.

The port of ``deepgo_tpu/obs/costmodel.py``. The host-side stack
(attribution, SLOs, tracing) says where *wall-clock* went; this module says
whether the compute was anywhere near the card's roofline and how much
device memory an entrypoint needs:

  * an entrypoint (a ladder rung of the serving forward, the train and
    eval steps) is priced by running it ONCE on synthetic inputs under
    ``torch.utils.flop_counter.FlopCounterMode`` — the JAX ledger's XLA
    ahead-of-time ``cost_analysis()`` has no PyTorch counterpart — with
    the convolution rules replaced by ones that count only the taps that
    land inside a SAME-padded board, as XLA's cost model does (the
    counter's own dense rule overstates a 19x19 stack by ~10%, outside
    the 5 % band the analytic estimator is held to). On the card the
    allocator's peak over the run (``torch.cuda.max_memory_allocated``)
    gives the entry's device-memory bill. Rows are ``source="flop_counter"``;
  * entries publish ``deepgo_cost_*`` gauges into the registry and
    stream versioned ``cost_ledger`` JSONL events;
  * :meth:`CostLedger.roofline` joins the ledger with *measured* timings
    (per-bucket dispatch means, the train loop's step counters) into
    achieved FLOP/s and **MFU** against the card's peak, which comes from
    a table of known cards matched on ``torch.cuda.get_device_name``;
    :func:`evaluate_mfu_floor` compares two such blocks.

Discipline: pricing happens once, at warmup or train start, never on the
dispatch hot path. A run that fails (or counts nothing) degrades the row
to ``source="estimated"`` with the analytic estimator's FLOPs instead of
raising. The counter counts operations, not traffic, so rows carry no
bytes and no arithmetic intensity.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from ..analysis.lockcheck import make_lock
from .registry import MetricsRegistry, get_registry

# bumped when CostEntry/event fields change shape; rides in every
# cost_ledger event and roofline block so offline joins can dispatch
VERSION = 1

# dense bf16 peak FLOP/s, HBM bandwidth (bytes/s), HBM capacity (bytes)
# per card, matched by substring against torch.cuda.get_device_name
# (NVIDIA's data sheets, no sparsity, at the card's full power limit).
# First match wins, so the more specific names sort first; any other card
# is "unknown".
_CUDA_PEAKS = (
    ("h100 pcie", 756e12, 2.0e12, 80e9),
    ("h100 80gb hbm3", 989e12, 3.35e12, 80e9),
    ("h100 sxm", 989e12, 3.35e12, 80e9),
)


@dataclasses.dataclass(frozen=True)
class PlatformPeak:
    """The roofline's ceiling for one device. ``source`` says how much to
    trust it: "table" (a known card), "estimated" (the CPU
    fallback: core count x a nominal per-core FMA rate, so CI exercises
    the full join with honest quotation marks), or "unknown" (an
    unrecognized accelerator — MFU reads None rather than lying)."""

    platform: str
    device_kind: str
    flops_per_s: float | None
    hbm_bytes_per_s: float | None
    hbm_capacity_bytes: float | None
    source: str

    @property
    def ridge_flops_per_byte(self) -> float | None:
        """The roofline ridge point: arithmetic intensity above which the
        ceiling is compute, below which it is memory bandwidth."""
        if self.flops_per_s and self.hbm_bytes_per_s:
            return self.flops_per_s / self.hbm_bytes_per_s
        return None

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        ridge = self.ridge_flops_per_byte
        out["ridge_flops_per_byte"] = round(ridge, 3) if ridge else None
        return out


def _default_device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))


def detect_peak(device=None) -> PlatformPeak:
    """The peak for ``device`` (default: the current CUDA device, else the
    CPU). Known cards come from the table above (platform "gpu"); the CPU
    gets the JAX package's estimated peak, so the MFU plumbing runs
    everywhere; any other card is "unknown" with None ceilings."""
    device = torch.device(device) if device is not None else \
        _default_device()
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        low = kind.lower()
        for sub, flops, bw, cap in _CUDA_PEAKS:
            if sub in low:
                return PlatformPeak("gpu", kind, flops, bw, cap, "table")
        return PlatformPeak("gpu", kind, None, None, None, "unknown")
    if device.type == "cpu":
        # nominal modern x86 core: 2 FMA ports x 8 f32 lanes x 2 flops x
        # ~2 GHz = 64 GFLOP/s/core; ~3 GB/s/core sustained memory BW.
        # Deliberately coarse — the point is exercising the join, and the
        # "estimated" source tag rides every derived MFU.
        cores = os.cpu_count() or 1
        try:
            capacity = float(os.sysconf("SC_PHYS_PAGES")
                             * os.sysconf("SC_PAGE_SIZE"))
        except (ValueError, OSError, AttributeError):
            capacity = None
        return PlatformPeak("cpu", "cpu", cores * 64e9, cores * 3e9,
                            capacity, "estimated")
    return PlatformPeak(device.type, device.type, None, None, None,
                        "unknown")


# ---------------------------------------------------------------------------
# the analytic estimator (the degraded-mode fallback and the cross-check)


def _same_taps(size: int, k: int) -> int:
    """Sum over one spatial dim's output positions of the kernel taps that
    land inside a SAME-padded input of ``size`` — the count XLA actually
    charges for border outputs (a dense k·size count overcharges them)."""
    half = k // 2
    return sum(min(i + half, size - 1) - max(i - half, 0) + 1
               for i in range(size))


def analytic_flops(cfg, batch: int = 1) -> float:
    """Forward-pass conv FLOPs (MAC x 2) of one ``policy_cnn.ModelConfig``
    for ``batch`` 19x19 boards, counting SAME-padding border taps exactly
    as XLA's cost model and this module's FLOP-counter rule do (a dense
    ``k²·cin·cout·361`` count overstates the 19x19 stack by ~10%). Bias
    adds, ReLUs, and the plane expansion are excluded — sub-1% at these
    widths.
    """
    from .. import BOARD_SIZE

    total = 0.0
    for k, c_in, c_out in cfg.layer_shapes():
        taps = _same_taps(BOARD_SIZE, k)
        total += 2.0 * c_in * c_out * taps * taps
    return batch * total


def analytic_train_flops(cfg, batch: int = 1) -> float:
    """Train-step estimate: forward + backward ~= 3x forward (the
    standard estimate)."""
    return 3.0 * analytic_flops(cfg, batch)


# ---------------------------------------------------------------------------
# the FLOP counter's convolution rules


def _inside_taps(size: int, out: int, k: int, stride: int, pad: int,
                 dilation: int) -> int:
    """Sum over one spatial dim's ``out`` output positions of the kernel
    taps that land inside the unpadded input of ``size``."""
    return sum(1 for i in range(out) for t in range(k)
               if 0 <= i * stride - pad + t * dilation < size)


def _conv_macs(x_shape, w_shape, out_shape, stride, padding, dilation,
               groups: int = 1) -> int:
    """Multiply-adds of one convolution over in-bounds taps only."""
    c_out, c_in_group = w_shape[0], w_shape[1]
    macs = x_shape[0] * c_out * c_in_group
    for d, k in enumerate(w_shape[2:]):
        macs *= _inside_taps(x_shape[2 + d], out_shape[2 + d], k,
                             stride[d], padding[d], dilation[d])
    return macs


def _conv_flop(x_shape, w_shape, _bias, stride, padding, dilation,
               transposed, *args, out_shape=None, **kwargs) -> int:
    if transposed:
        from torch.utils.flop_counter import conv_flop_count

        return conv_flop_count(x_shape, w_shape, out_shape, transposed=True)
    groups = args[1] if len(args) > 1 else 1
    return 2 * _conv_macs(x_shape, w_shape, out_shape, stride, padding,
                          dilation, groups)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, stride,
                        padding, dilation, transposed, _output_padding,
                        groups, output_mask, out_shape=None, **kwargs) -> int:
    if transposed:
        from torch.utils.flop_counter import conv_backward_flop

        return conv_backward_flop(
            grad_out_shape, x_shape, w_shape, _bias, stride, padding,
            dilation, transposed, _output_padding, groups, output_mask,
            out_shape)
    # the input gradient and the weight gradient each take the forward's
    # multiply-adds over the same in-bounds taps
    macs = _conv_macs(x_shape, w_shape, grad_out_shape, stride, padding,
                      dilation, groups)
    return 2 * macs * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def flop_counter():
    """A ``FlopCounterMode`` that counts convolutions over in-bounds taps."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    return FlopCounterMode(display=False, custom_mapping={
        aten.convolution: _conv_flop,
        aten._convolution: _conv_flop,
        aten.convolution_backward: _conv_backward_flop,
    })


def _tensor_bytes(value) -> int:
    """Bytes of every CUDA tensor in ``value`` (tensors, modules, and
    dicts / lists / tuples of them)."""
    if isinstance(value, torch.Tensor):
        return value.nbytes if value.is_cuda else 0
    if isinstance(value, torch.nn.Module):
        return sum(_tensor_bytes(t) for t in
                   list(value.parameters()) + list(value.buffers()))
    if isinstance(value, dict):
        return sum(_tensor_bytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_tensor_bytes(v) for v in value)
    return 0


@dataclasses.dataclass(frozen=True)
class CostEntry:
    """One entrypoint's resource bill. ``source="flop_counter"`` rows
    carry the FLOP counter's count of one run (and, on the card, the
    allocator's HBM peak); ``"estimated"`` rows mean the run failed or
    counted nothing and ``flops`` is the analytic estimator's count with
    the byte/HBM fields None. ``bytes_accessed`` is always None: the
    counter counts operations, not traffic. ``compile_seconds`` is the
    pricing run's wall time (the JAX ledger's AOT compile time)."""

    fn: str
    bucket: int | None
    flops: float
    bytes_accessed: float | None
    hbm_peak_bytes: float | None
    hbm_argument_bytes: float | None
    hbm_output_bytes: float | None
    hbm_temp_bytes: float | None
    compile_seconds: float
    source: str
    platform: str

    @property
    def key(self) -> str:
        return self.fn if self.bucket is None else f"{self.fn}/b{self.bucket}"

    @property
    def arithmetic_intensity(self) -> float | None:
        if self.flops and self.bytes_accessed:
            return self.flops / self.bytes_accessed
        return None

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        ai = self.arithmetic_intensity
        out["arithmetic_intensity"] = round(ai, 3) if ai else None
        return out


class CostLedger:
    """The process ledger: measured entries + gauges + events + roofline.

    Thread-safe the repo's way (one lock via make_lock), but the intended
    use is single-threaded pricing passes at warmup or train start.
    ``device`` is where the entry helpers below run their entrypoints (and the
    card whose peak the ledger records)."""

    def __init__(self, registry: MetricsRegistry | None = None, sink=None,
                 device="cuda", clock=time.monotonic):
        from .. import resolve_device

        self._registry = registry or get_registry()
        self._sink = sink  # anything with .write(kind, **fields), or None
        self._clock = clock
        self._lock = make_lock("obs.costmodel")
        self._entries: list[CostEntry] = []
        self._aot_seconds = 0.0
        self.device = resolve_device(device)
        self.peak = detect_peak(self.device)
        reg = self._registry
        self._g_flops = reg.gauge(
            "deepgo_cost_flops",
            "FLOP-counter FLOPs of one entrypoint dispatch")
        self._g_bytes = reg.gauge(
            "deepgo_cost_bytes", "bytes accessed per dispatch")
        self._g_hbm = reg.gauge(
            "deepgo_cost_hbm_peak_bytes",
            "device-memory bill (arguments + the run's allocator peak) per "
            "entrypoint")
        self._g_compile = reg.gauge(
            "deepgo_cost_compile_seconds",
            "wall time of the pricing run per entrypoint")
        self._g_peak_flops = reg.gauge(
            "deepgo_cost_peak_flops_per_sec",
            "detected per-platform peak FLOP/s (the MFU denominator)")
        self._g_peak_bw = reg.gauge(
            "deepgo_cost_peak_hbm_bytes_per_sec",
            "detected per-platform HBM bandwidth (the roofline slope)")
        if self.peak.flops_per_s:
            self._g_peak_flops.set(self.peak.flops_per_s,
                                   platform=self.peak.platform,
                                   source=self.peak.source)
        if self.peak.hbm_bytes_per_s:
            self._g_peak_bw.set(self.peak.hbm_bytes_per_s,
                                platform=self.peak.platform,
                                source=self.peak.source)

    # -- building ----------------------------------------------------------

    def measure(self, fn: str, call, args: tuple, kwargs: dict | None = None,
                *, bucket: int | None = None,
                analytic: float | None = None) -> CostEntry:
        """Run ``call(*args, **kwargs)`` once under the FLOP counter and
        record its bill; on the card the allocator's peak over the run
        plus the CUDA tensors among ``args`` is its device-memory bill.

        Never raises for the run's reasons: a failed run, or one that
        counted nothing, degrades the row to ``source="estimated"`` with
        ``analytic`` FLOPs (0.0 when no estimator was given)."""
        t0 = self._clock()
        flops = None
        hbm_arg = hbm_tmp = hbm_peak = None
        on_card = self.device.type == "cuda"
        try:
            if on_card:
                torch.cuda.synchronize(self.device)
                base = torch.cuda.memory_allocated(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            with flop_counter() as counter:
                call(*args, **(kwargs or {}))
            flops = float(counter.get_total_flops()) or None
            if on_card:
                torch.cuda.synchronize(self.device)
                hbm_tmp = float(torch.cuda.max_memory_allocated(self.device)
                                - base)
                hbm_arg = float(_tensor_bytes(args))
                hbm_peak = hbm_arg + hbm_tmp
        except Exception:  # noqa: BLE001 — degraded mode, never crash
            flops = None
        compile_seconds = self._clock() - t0
        source = "flop_counter"
        if flops is None:
            source = "estimated"
            flops = float(analytic or 0.0)
            hbm_arg = hbm_tmp = hbm_peak = None
        entry = CostEntry(
            fn=fn, bucket=bucket, flops=flops, bytes_accessed=None,
            hbm_peak_bytes=hbm_peak, hbm_argument_bytes=hbm_arg,
            hbm_output_bytes=None, hbm_temp_bytes=hbm_tmp,
            compile_seconds=round(compile_seconds, 4), source=source,
            platform=self.peak.platform)
        self.add(entry)
        return entry

    def add(self, entry: CostEntry) -> None:
        """Record one entry: ledger row + gauges + the JSONL event."""
        with self._lock:
            self._entries.append(entry)
            self._aot_seconds += entry.compile_seconds
        labels = {"fn": entry.fn}
        if entry.bucket is not None:
            labels["bucket"] = entry.bucket
        self._g_flops.set(entry.flops, **labels)
        if entry.bytes_accessed is not None:
            self._g_bytes.set(entry.bytes_accessed, **labels)
        if entry.hbm_peak_bytes is not None:
            self._g_hbm.set(entry.hbm_peak_bytes, **labels)
        self._g_compile.set(entry.compile_seconds, **labels)
        if self._sink is not None:
            try:
                # entry.to_dict() already carries the platform
                self._sink.write("cost_ledger", version=VERSION,
                                 device_kind=self.peak.device_kind,
                                 **entry.to_dict())
            except Exception:  # noqa: BLE001 — bookkeeping never fatal
                pass

    # -- reading -----------------------------------------------------------

    @property
    def entries(self) -> list[CostEntry]:
        with self._lock:
            return list(self._entries)

    def get(self, fn: str, bucket: int | None = None) -> CostEntry | None:
        with self._lock:
            for e in self._entries:
                if e.fn == fn and e.bucket == bucket:
                    return e
        return None

    @property
    def aot_seconds(self) -> float:
        with self._lock:
            return round(self._aot_seconds, 3)

    def to_dict(self) -> dict:
        return {
            "version": VERSION,
            "platform": self.peak.platform,
            "device_kind": self.peak.device_kind,
            "peak": self.peak.to_dict(),
            "aot_seconds": self.aot_seconds,
            "entries": [e.to_dict() for e in self.entries],
        }

    def roofline(self, timings: dict | None = None) -> dict:
        """The ledger joined with measured timings.

        ``timings`` maps ``(fn, bucket) -> seconds per dispatch`` (bench
        medians, per-bucket dispatch means, per-step wall). Entries with
        a timing gain ``achieved_flops_per_s`` + ``mfu``; the rest stay
        priced-only (``mfu: None``) — the block shape is identical either
        way so gates and dashboards need no special cases."""
        timings = timings or {}
        entries = {}
        for e in self.entries:
            entries[e.key] = roofline_entry(
                e, self.peak, seconds_per_call=timings.get((e.fn, e.bucket)))
        return {
            "version": VERSION,
            "platform": self.peak.platform,
            "device_kind": self.peak.device_kind,
            "peak": self.peak.to_dict(),
            "aot_seconds": self.aot_seconds,
            "entries": entries,
        }


def roofline_entry(entry: CostEntry, peak: PlatformPeak,
                   seconds_per_call: float | None = None) -> dict:
    """One entrypoint's roofline verdict: the acceptance shape
    ``{flops, bytes, hbm_peak, achieved_flops_per_s, mfu, bound}`` plus
    the arithmetic the verdict came from."""
    ai = entry.arithmetic_intensity
    ridge = peak.ridge_flops_per_byte
    bound = None
    if ai is not None and ridge is not None:
        bound = "compute" if ai >= ridge else "memory"
    out = {
        "flops": entry.flops,
        "bytes": entry.bytes_accessed,
        "hbm_peak": entry.hbm_peak_bytes,
        "achieved_flops_per_s": None,
        "mfu": None,
        "bound": bound,
        "arithmetic_intensity": round(ai, 3) if ai else None,
        "compile_seconds": entry.compile_seconds,
        "source": entry.source,
    }
    if peak.hbm_capacity_bytes and entry.hbm_peak_bytes is not None:
        out["hbm_headroom_bytes"] = round(
            peak.hbm_capacity_bytes - entry.hbm_peak_bytes)
    if seconds_per_call and seconds_per_call > 0 and entry.flops:
        achieved = entry.flops / seconds_per_call
        out["achieved_flops_per_s"] = round(achieved)
        out["seconds_per_call"] = round(seconds_per_call, 6)
        if peak.flops_per_s:
            out["mfu"] = round(achieved / peak.flops_per_s, 4)
            # the entry's own ceiling: memory-bound entries cap below
            # peak FLOP/s at ai x bandwidth
            ceiling = peak.flops_per_s
            if ai is not None and peak.hbm_bytes_per_s:
                ceiling = min(ceiling, ai * peak.hbm_bytes_per_s)
            out["roofline_frac"] = round(achieved / ceiling, 4)
    return out


# ---------------------------------------------------------------------------
# entry helpers (the forwards and steps the port serves or trains)


def _boards(batch: int, wire: str = "packed"):
    """Empty-board inputs of one batch: the packed records and an int32
    vector for player / rank (numpy, the serving forwards' host inputs)."""
    import numpy as np

    if wire == "nibble":
        packed = np.zeros((batch, 1625), np.uint8)
    else:
        packed = np.zeros((batch, 9, 19, 19), np.uint8)
    ints = np.ones(batch, np.int32)
    return packed, ints


def _model(cfg, device):
    from ..models import policy_cnn

    return policy_cnn.init(torch.Generator().manual_seed(0), cfg,
                           device=device)


def _buckets(buckets):
    from ..serving.buckets import DEFAULT_BUCKETS

    return sorted(set(int(x) for x in (buckets or DEFAULT_BUCKETS)))


def ladder_entries(ledger: CostLedger, cfg, buckets=None, forward=None,
                   fn_name: str = "policy_forward") -> list[CostEntry]:
    """One entry per bucket-ladder rung of the serving forward
    (``make_log_prob_fn`` on the ledger's device unless ``forward`` is the
    engine's own), each priced on empty boards; the analytic fallback
    counts the rows the forward convolves (``serving.conv_rows``)."""
    from ..models.serving import conv_rows, make_log_prob_fn

    fn = forward if forward is not None else make_log_prob_fn(
        cfg, ledger.device)
    params = _model(cfg, ledger.device)
    out = []
    for b in _buckets(buckets):
        packed, ints = _boards(b)
        out.append(ledger.measure(
            fn_name, fn, (params, packed, ints, ints), bucket=b,
            analytic=analytic_flops(cfg, conv_rows(b, ledger.device))))
    return out


def variant_entries(ledger: CostLedger, cfg, variant: str, buckets=None,
                    forward=None) -> list[CostEntry]:
    """Price one named serving variant's forward over the ladder rungs
    (serving/variants.py); sym variants compute eight forwards a board,
    so their analytic fallback is 8x (the others convolve
    ``serving.conv_rows`` rows)."""
    from ..models.serving import conv_rows
    from ..serving.variants import variant_fn_name, variant_spec

    if variant == "f32":
        return ladder_entries(ledger, cfg, buckets=buckets, forward=forward)
    spec = variant_spec(cfg, variant, device=ledger.device)
    fn = forward if forward is not None else spec.forward
    params = spec.prepare(_model(cfg, ledger.device))
    out = []
    for b in _buckets(buckets):
        packed, ints = _boards(b)
        analytic = (8.0 * analytic_flops(cfg, b) if "sym" in variant
                    else analytic_flops(cfg, conv_rows(b, ledger.device)))
        out.append(ledger.measure(
            variant_fn_name(variant), fn, (params, packed, ints, ints),
            bucket=b, analytic=analytic))
    return out


def sym_entry(ledger: CostLedger, cfg, bucket: int = 8) -> CostEntry:
    """The unfused 8-fold dihedral ensemble forward
    (``make_sym_policy_fn``: one 8B-board forward, probabilities averaged),
    the reference the fused serving forward is tested against."""
    from ..models.serving import make_sym_policy_fn

    fn = make_sym_policy_fn(cfg, ledger.device)
    packed, ints = _boards(bucket)
    return ledger.measure(
        "sym_policy_forward", fn,
        (_model(cfg, ledger.device), packed, ints, ints),
        bucket=bucket, analytic=8.0 * analytic_flops(cfg, bucket))


def _train_batch(batch: int, device, wire: str, augment: bool) -> dict:
    packed, ints = _boards(batch, wire)
    out = {"packed": torch.from_numpy(packed).to(device),
           "player": torch.from_numpy(ints).to(device),
           "rank": torch.from_numpy(ints).to(device),
           "target": torch.zeros(batch, dtype=torch.int32, device=device)}
    if augment:
        out["sym"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return out


# identical train-step programs are priced once per process: the loop and
# the tests build many short Experiments over the same config, and
# re-running the same step would multiply the cost for identical numbers
_train_memo: dict[tuple, CostEntry] = {}


def train_entry(ledger: CostLedger, cfg, batch: int, optimizer=None,
                wire: str = "packed", augment: bool = False,
                fn_name: str = "train_step") -> CostEntry:
    """One single-device train step (``make_train_step``) at ``batch`` on
    a fresh model and optimizer state — the run's own model is never
    touched. FLOPs per step are identical under the K-step call, so this
    one row prices both dispatch shapes."""
    from ..training import make_train_step
    from ..training.optimizers import sgd

    memo_key = (fn_name, cfg, int(batch), wire, bool(augment),
                type(optimizer).__name__, ledger.peak.platform)
    cached = _train_memo.get(memo_key)
    if cached is not None:
        ledger.add(cached)
        return cached
    optimizer = optimizer or sgd(0.01, 1e-7, 0.0)
    step = make_train_step(cfg, optimizer, augment=augment, wire=wire)
    model = _model(cfg, ledger.device)
    state = optimizer.init(model)
    entry = ledger.measure(
        fn_name, step, (model, state,
                        _train_batch(batch, ledger.device, wire, augment)),
        bucket=batch, analytic=analytic_train_flops(cfg, batch))
    _train_memo[memo_key] = entry
    return entry


def eval_entry(ledger: CostLedger, cfg, batch: int, wire: str = "packed",
               fn_name: str = "eval_step") -> CostEntry:
    """The validation step (``make_eval_step``)."""
    from ..training import make_eval_step

    step = make_eval_step(cfg, wire=wire)
    return ledger.measure(
        fn_name, step, (_model(cfg, ledger.device),
                        _train_batch(batch, ledger.device, wire, False)),
        bucket=batch, analytic=analytic_flops(cfg, batch))


def standard_ledger(model: str = "full", buckets=None,
                    train_batch: int = 256, sym_bucket: int = 8,
                    device="cuda") -> CostLedger:
    """The ``cli cost`` sweep over one named model config, in one ledger:
    the serving ladder (f32 and int8), the sym ensembles (unfused, fused
    f32 and fused int8) and the train and eval steps. Each entry runs once
    on ``device`` (the FLOP counter prices what executes). ``train_batch=0``
    skips the train and eval steps, ``sym_bucket=0`` the ensembles."""
    from ..models import policy_cnn

    cfg = policy_cnn.CONFIGS[model]
    ledger = CostLedger(device=device)
    ladder_entries(ledger, cfg, buckets=buckets)
    variant_entries(ledger, cfg, "int8", buckets=buckets)
    if sym_bucket:
        sym_entry(ledger, cfg, bucket=sym_bucket)
        for variant in ("sym", "int8+sym"):
            variant_entries(ledger, cfg, variant, buckets=(sym_bucket,))
    if train_batch:
        train_entry(ledger, cfg, train_batch)
        eval_entry(ledger, cfg, train_batch)
    return ledger


# ---------------------------------------------------------------------------
# joins against measured timings


def _parse_label(label: str) -> dict:
    if not label:
        return {}
    out = {}
    for part in label.split(","):
        k, _, v = part.partition("=")
        out[k] = v
    return out


def dispatch_seconds_by_bucket(metrics: dict,
                               engine: str | None = None) -> dict[int, float]:
    """Mean coalesced-dispatch seconds per ladder rung, from the
    ``deepgo_serving_dispatch_seconds{engine,bucket}`` histogram in a
    registry snapshot (summed across engines — a fleet's replicas share
    one forward, so their rungs price identically). ``engine`` restricts
    the join to one engine's series — an f32 engine and an int8 engine
    in one process each divide ITS OWN dispatch times, not a blend."""
    m = (metrics or {}).get("deepgo_serving_dispatch_seconds") or {}
    sums: dict[int, float] = {}
    counts: dict[int, int] = {}
    for label, snap in (m.get("series") or {}).items():
        if not isinstance(snap, dict):
            continue
        labels = _parse_label(label)
        if engine is not None and labels.get("engine") != engine:
            continue
        bucket = labels.get("bucket")
        if bucket is None:
            continue
        try:
            b = int(bucket)
        except ValueError:
            continue
        sums[b] = sums.get(b, 0.0) + float(snap.get("sum") or 0.0)
        counts[b] = counts.get(b, 0) + int(snap.get("count") or 0)
    return {b: sums[b] / counts[b] for b in sums if counts.get(b)}


def evaluate_mfu_floor(fresh: dict | None, baseline: dict | None,
                       floor: float = 0.10) -> dict:
    """The MFU-floor gate: compare a fresh ``roofline`` block against the
    last-good capture's, entry by entry. An entrypoint whose MFU dropped
    by ``floor`` (relative) or more is a failure even when raw
    throughput passed — a "win" that spends hardware efficiency is a
    latent regression. Entries without MFU on either side (priced-only
    rows, unknown platforms) are skipped, never failed: the gate
    enforces what it can measure (the ``evaluate_gate`` discipline)."""
    out: dict = {"floor": floor, "checked": 0, "failures": []}
    fresh_entries = (fresh or {}).get("entries") or {}
    base_entries = (baseline or {}).get("entries") or {}
    if not fresh_entries or not base_entries:
        out.update(verdict="skip",
                   reason="no roofline block on one side — nothing to "
                          "compare")
        return out
    for key in sorted(set(fresh_entries) & set(base_entries)):
        f_mfu = (fresh_entries[key] or {}).get("mfu")
        b_mfu = (base_entries[key] or {}).get("mfu")
        if not f_mfu or not b_mfu:
            continue
        out["checked"] += 1
        drop = (b_mfu - f_mfu) / b_mfu
        if drop >= floor:
            out["failures"].append({
                "entry": key, "mfu": f_mfu, "baseline_mfu": b_mfu,
                "drop": round(drop, 4)})
    if not out["checked"]:
        out.update(verdict="skip",
                   reason="no entrypoint carries MFU on both sides")
    elif out["failures"]:
        worst = max(out["failures"], key=lambda f: f["drop"])
        out.update(verdict="fail",
                   reason=f"{worst['entry']} MFU dropped {worst['drop']:.1%} "
                          f"({worst['baseline_mfu']:.4f} -> "
                          f"{worst['mfu']:.4f}), floor {floor:.0%} — "
                          "throughput may have passed, hardware efficiency "
                          "did not")
    else:
        out.update(verdict="pass",
                   reason=f"MFU within floor on {out['checked']} "
                          "entrypoint(s)")
    return out


# ---------------------------------------------------------------------------
# the process-wide ledger (what the exporter's /cost route serves)

_ledger_lock = make_lock("obs.costmodel.global")
_process_ledger: CostLedger | None = None


def set_cost_ledger(ledger: CostLedger | None) -> None:
    """Install (or clear) the process ledger (``Experiment`` installs
    the one it priced its train step into)."""
    global _process_ledger
    with _ledger_lock:
        _process_ledger = ledger


def get_cost_ledger() -> CostLedger | None:
    with _ledger_lock:
        return _process_ledger


# ---------------------------------------------------------------------------
# rendering (cli cost / cli obs)


def _fmt_num(v, scale=1.0, suffix="") -> str:
    if v is None:
        return "-"
    return f"{v / scale:,.1f}{suffix}"


def format_ledger(ledger: CostLedger, timings: dict | None = None) -> str:
    """Fixed-width table of the ledger (+ roofline columns when timings
    are supplied) — the ledger's table view."""
    block = ledger.roofline(timings)
    peak = block["peak"]
    lines = [
        f"device cost ledger v{block['version']} — {block['platform']} "
        f"({block['device_kind']}), peak "
        f"{_fmt_num(peak['flops_per_s'], 1e12)} TFLOP/s @ "
        f"{_fmt_num(peak['hbm_bytes_per_s'], 1e9)} GB/s "
        f"(ridge {peak['ridge_flops_per_byte'] or '-'} FLOP/byte, "
        f"source: {peak['source']}); priced in {block['aot_seconds']}s",
    ]
    header = ["entrypoint", "GFLOPs", "MB moved", "AI", "HBM MB",
              "compile_s", "bound", "MFU", "src"]
    rows = []
    for key, e in block["entries"].items():
        rows.append([
            key,
            _fmt_num(e["flops"], 1e9),
            _fmt_num(e["bytes"], 2**20),
            f"{e['arithmetic_intensity']:.1f}"
            if e["arithmetic_intensity"] else "-",
            _fmt_num(e["hbm_peak"], 2**20),
            f"{e['compile_seconds']:.2f}",
            e["bound"] or "-",
            f"{e['mfu']:.2%}" if e["mfu"] else "-",
            e["source"],
        ])
    widths = [max(len(header[i]), *(len(r[i]) for r in rows))
              if rows else len(header[i]) for i in range(len(header))]
    lines.append("  ".join(h.ljust(w) for h, w in zip(header, widths)))
    lines.append("  ".join("-" * w for w in widths))
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)
