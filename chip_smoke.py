#!/usr/bin/env python3
"""Drive the PyTorch port's policy serving paths on one CUDA card and check them.

Run from the repository root, on a machine with one NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deepgo_tpu_torch/ops/csrc`` and
then, each phase failing the run on the first disagreement:

1. device: requires CUDA; reads the card's name and power limit.
2. build: compiles every kernel source (one nvcc each, in parallel).
3. kernels vs plain: the expansion kernel, and the sym kernel (gather of
   S dihedral views fused with the expansion) at S = 1, 3, 8, against their
   plain PyTorch versions on the card, exactly, in bf16 and float32 at
   B = 1, 8, 37, 512, over random uint8 records, out-of-range players and
   ranks 0..10; at S = 1 the sym kernel also equals the expansion kernel.
   Both are timed with CUDA events beside their bounds.
4. f32 path: ``policy_engine`` over the ``full`` config (12 layers x 128
   channels, bf16, random weights from a seed) answers bursts of concurrent
   single-board requests from 8 threads that land on every ladder rung.
   Every row is finite and normalised, bitwise equal to the direct forward
   at its rung, and within ``CROSS_RUNG_TOL`` of the same board's row at
   the top rung; the expansion kernel's launches equal the engine's
   forwards. Then, for the record, the direct forward's wall time per rung
   and a torch.profiler breakdown of one top-rung forward by kernel group.
5. variant path: ``policy_engine(variant="int8+sym")`` on ``full`` over a
   "grid net" (random weights snapped onto the int8 grid, sharp last-layer
   bias). Its tolerance gate passes at every rung; the same bursts as in 4;
   the same row checks against the direct fused forward; the sym kernel's
   launches equal the engine's forwards and the expansion kernel's stay 0.
   On the grid net int8+sym rows equal sym rows and int8 rows equal f32
   rows bitwise. Then wall time per rung and a profile of one top-rung
   fused forward (512 boards x 8 views).
6. card vs CPU: the float32 plain forward and the float32 fused sym forward
   on the card (TF32 off) against the CPU, which the CPU tests tie to the
   JAX package: max-abs <= 1e-4.

The last lines are a ``summary:`` JSON line of the paths' checks and
timings, the card line from nvidia-smi, one ``kernels`` JSON object, and
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from deepgo_tpu_torch.models import policy_cnn, quant
from deepgo_tpu_torch.models.serving import make_log_prob_fn
from deepgo_tpu_torch.ops import _build, cuda_expand
from deepgo_tpu_torch.ops import expand as plain_expand
from deepgo_tpu_torch.serving import (EngineConfig, policy_engine,
                                      variant_spec, verify_variant)

SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM non-tensor rate, for the compares
KERNEL_BATCHES = (1, 8, 37, 512)
SYMMETRIES = (1, 3, 8)
# Burst sizes of the engine paths: each lands on one rung of the default
# ladder (1, 8, 32, 128, 512) when it coalesces into one dispatch.
BURSTS = (1, 5, 20, 100, 400, 3, 60, 250, 7, 30)
THREADS = 8
# A board's log-probs at one rung against the top rung: cuDNN may choose a
# different convolution algorithm per batch size, which rounds differently
# in bf16 through 12 layers. Held over points with p >= 1e-3. The same
# tolerance holds two variants' rows against each other where cuDNN breaks
# the bitwise grid-net identities.
CROSS_RUNG_TOL = 0.05
F32_CARD_VS_CPU_TOL = 1e-4
CARD_VS_CPU_BOARDS = 16


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi printed no card")
    return out[0].strip()


def random_records(rng, b, players=(1, 2), ranks=(1, 9)):
    return (rng.integers(0, 256, size=(b, 9, 19, 19), dtype=np.uint8),
            rng.integers(players[0], players[1] + 1, size=b).astype(np.int32),
            rng.integers(ranks[0], ranks[1] + 1, size=b).astype(np.int32))


def _sleep_cycles_per_ms() -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_ms(fn, runs: int = 60, warmup: int = 5) -> dict:
    """Median device time of one call (CUDA events around it, with the
    stream held by a sleep until the host has queued the call, so the
    events see the device's work and not the host's launch overhead), and
    median host wall time of one call ending in a synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    wall = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(wall)
    cycles = int(_sleep_cycles_per_ms() * (2 * wall_ms + 0.05))
    device = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    return {"ms": statistics.median(device), "wall_ms": wall_ms}


def expand_bound(b: int, out_bytes: int, s: int = 1) -> tuple[float, str]:
    """Least time for the expansion of S views of b boards (S = 1: the
    plain expansion): bytes (each board read once, each output view
    written once) over the memory rate, or the compares (about 40 per
    point and view) over the non-tensor rate, whichever is larger."""
    moved = b * (9 * 361 + 8) + s * b * 361 * 37 * out_bytes
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = s * b * 361 * 40 / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def kernel_row(what: str, kernel_fn, plain_fn, b: int, s: int, dtype,
               out_bytes: int, err: float) -> dict:
    kernel = time_ms(kernel_fn)
    plain = time_ms(plain_fn, runs=30)
    bound, bound_by = expand_bound(b, out_bytes, s)
    row = {"batch": b, "symmetries": s, "dtype": str(dtype).split(".")[-1],
           "exact": True, "max_abs_err": err, "ms": kernel["ms"],
           "wall_ms": kernel["wall_ms"], "plain_ms": plain["ms"],
           "plain_wall_ms": plain["wall_ms"], "bound_ms": bound,
           "bound_by": bound_by}
    print(f"{what} B={b:4d} S={s} {row['dtype']:>8}: exact, "
          f"{kernel['ms'] * 1e3:.2f} us device "
          f"({kernel['wall_ms'] * 1e3:.1f} us wall), plain "
          f"{plain['ms'] * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
          f"({bound_by})", flush=True)
    return row


def kernel_inputs(rng, b):
    packed, player, rank = random_records(rng, b, players=(1, 2),
                                          ranks=(0, 10))
    odd = np.array([0, 3, -1, 255, 1, 2], np.int32)
    player[: min(b, 6)] = odd[: min(b, 6)]
    return [torch.from_numpy(a).cuda() for a in (packed, player, rank)]


def phase_kernel(rng) -> list[dict]:
    rows = []
    for b in KERNEL_BATCHES:
        args = kernel_inputs(rng, b)
        for dtype, out_bytes in ((torch.bfloat16, 2), (torch.float32, 4)):
            got = cuda_expand.expand_planes_cuda(*args, dtype=dtype)
            want = plain_expand.expand_planes(*args, dtype=dtype)
            torch.cuda.synchronize()
            check(got.shape == want.shape == (b, 19, 19, 37)
                  and got.is_contiguous(), f"kernel output shape at B={b}")
            err = (got.float() - want.float()).abs().max().item()
            check(torch.equal(got, want),
                  f"kernel != plain at B={b} {dtype} (max-abs {err})")
            rows.append(kernel_row(
                "kernel", lambda: cuda_expand.expand_planes_cuda(
                    *args, dtype=dtype),
                lambda: plain_expand.expand_planes(*args, dtype=dtype),
                b, 1, dtype, out_bytes, err))
    return rows


def phase_sym_kernel(rng) -> list[dict]:
    rows = []
    for b in KERNEL_BATCHES:
        args = kernel_inputs(rng, b)
        for s in SYMMETRIES:
            for dtype, out_bytes in ((torch.bfloat16, 2), (torch.float32, 4)):
                got = cuda_expand.expand_planes_sym_cuda(*args, symmetries=s,
                                                         dtype=dtype)
                want = plain_expand.expand_planes_sym(*args, symmetries=s,
                                                      dtype=dtype)
                torch.cuda.synchronize()
                check(got.shape == want.shape == (s * b, 19, 19, 37)
                      and got.is_contiguous(),
                      f"sym kernel output shape at B={b} S={s}")
                err = (got.float() - want.float()).abs().max().item()
                check(torch.equal(got, want), f"sym kernel != plain at "
                      f"B={b} S={s} {dtype} (max-abs {err})")
                if s == 1:
                    one = cuda_expand.expand_planes_cuda(*args, dtype=dtype)
                    torch.cuda.synchronize()
                    check(torch.equal(got, one), f"sym kernel at S=1 != "
                          f"expand kernel at B={b} {dtype}")
                rows.append(kernel_row(
                    "sym kernel",
                    lambda: cuda_expand.expand_planes_sym_cuda(
                        *args, symmetries=s, dtype=dtype),
                    lambda: plain_expand.expand_planes_sym(
                        *args, symmetries=s, dtype=dtype),
                    b, s, dtype, out_bytes, err))
    return rows


def run_bursts(engine, packed, player, rank):
    """Each burst's requests submitted together from THREADS threads; the
    next burst starts when every future of this one resolved."""
    futures = [None] * len(packed)
    start = 0
    for size in BURSTS:
        idx = range(start, start + size)
        gate = threading.Barrier(THREADS)
        errors = []

        def submit(part, gate=gate, errors=errors):
            try:
                gate.wait(timeout=60)
                for i in part:
                    futures[i] = engine.submit(packed[i], player[i], rank[i])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=submit,
                                    args=(idx[k::THREADS],))
                   for k in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not errors and not any(t.is_alive() for t in threads),
              f"submitters of burst {size} failed: {errors}")
        for i in idx:
            futures[i].result(timeout=120)
        start += size
    return futures


def serving_boards(rng):
    n = sum(BURSTS)
    return (rng.integers(0, 3, size=(n, 9, 19, 19), dtype=np.uint8),
            rng.integers(1, 3, size=n).astype(np.int32),
            rng.integers(1, 10, size=n).astype(np.int32))


def drive_engine(engine, boards, read_launches) -> dict:
    """Warm every rung, serve the bursts, read the launch counts (reset
    just before by the caller) and check every request was served once on
    the rungs of the ladder."""
    n = len(boards[0])
    try:
        t0 = time.perf_counter()
        warm = engine.warmup()
        t_warm = time.perf_counter() - t0
        t1 = time.perf_counter()
        futures = run_bursts(engine, *boards)
        t_serve = time.perf_counter() - t1
    finally:
        engine.close()
    launches = read_launches()
    stats = engine.stats()
    print(f"engine {engine.name}: {warm} rungs warmed in {t_warm:.2f} s; "
          f"{n} requests in {len(BURSTS)} bursts served in {t_serve:.2f} s",
          flush=True)
    print("engine stats: " + json.dumps(stats), flush=True)
    check(stats["boards"] == n and stats["dispatch_failures"] == 0
          and stats["timeouts"] == 0, "every request served once")
    hit = {int(k) for k in stats["bucket_hits"]}
    check(hit == set(engine.ladder.buckets), f"rungs hit {sorted(hit)} != "
          f"ladder {engine.ladder.buckets}")
    return {"futures": futures, "launches": launches, "stats": stats}


def direct(forward, params, ladder, boards, idx, bucket):
    """The boards ``idx`` through ``forward`` in chunks padded to
    ``bucket``, as the engine pads a dispatch."""
    packed, player, rank = boards
    out = []
    for s in range(0, len(idx), bucket):
        part = idx[s:s + bucket]
        out.append(forward(params, *ladder.pad(
            packed[part], player[part], rank[part], bucket))[:len(part)])
    return np.concatenate(out)


def check_rows(forward, params, ladder, boards, futures) -> float:
    """Engine rows finite, normalised, bitwise equal to ``forward`` at
    their rung and within CROSS_RUNG_TOL of the top rung; returns the
    cross-rung max-abs."""
    n = len(boards[0])
    rows = np.stack([f.result() for f in futures])
    buckets = np.array([f.bucket for f in futures])
    check(rows.shape == (n, 361) and rows.dtype == np.float32, "row shape")
    check(bool(np.isfinite(rows).all()), "finite rows")
    lse = np.log(np.exp(rows.astype(np.float64)).sum(axis=1))
    check(float(np.abs(lse).max()) <= 1e-3, f"rows normalised (max "
          f"|logsumexp| {np.abs(lse).max()})")
    for bucket in ladder.buckets:
        idx = np.flatnonzero(buckets == bucket)
        check(np.array_equal(rows[idx], direct(forward, params, ladder,
                                               boards, idx, bucket)),
              f"engine rows at rung {bucket} != direct forward bitwise")
    top = direct(forward, params, ladder, boards, np.arange(n),
                 ladder.max_bucket)
    mask = np.exp(top) >= 1e-3
    cross = float(np.abs(rows - top)[mask].max())
    print(f"engine rows bitwise equal to the direct forward at their rung; "
          f"max-abs vs the top rung over p >= 1e-3: {cross:.3g} "
          f"(tolerance {CROSS_RUNG_TOL})", flush=True)
    check(cross <= CROSS_RUNG_TOL, "rows across rungs")
    return cross


def rung_walls(forward, params, ladder, boards, label) -> dict:
    """Wall ms of one direct forward (numpy in, numpy out) per rung."""
    n = len(boards[0])
    per_rung = {}
    for bucket in ladder.buckets:
        idx = np.arange(bucket) % n
        t = time_ms(lambda: forward(params, *(a[idx] for a in boards)),
                    runs=20, warmup=3)
        per_rung[str(bucket)] = t["wall_ms"]
    print(f"{label} wall ms per rung (numpy in, numpy out): "
          + json.dumps(per_rung), flush=True)
    return per_rung


def phase_main_path(rng) -> dict:
    cfg = policy_cnn.CONFIGS["full"]
    check(cfg.num_layers == 12 and cfg.channels == 128
          and cfg.compute_dtype == "bfloat16", "full config")
    model = policy_cnn.init(torch.Generator().manual_seed(SEED), cfg,
                            device="cuda")
    boards = serving_boards(rng)

    cuda_expand.reset_launches()
    engine = policy_engine(model, cfg, config=EngineConfig(max_wait_ms=50.0),
                           device="cuda")
    served = drive_engine(engine, boards, lambda: cuda_expand.launches)
    stats = served["stats"]
    check(served["launches"] == stats["forwards"] >= 1,
          f"expand kernel launches {served['launches']} != engine forwards "
          f"{stats['forwards']}")
    forward = make_log_prob_fn(cfg, device="cuda")
    ladder = engine.ladder
    cross = check_rows(forward, model, ladder, boards, served["futures"])
    per_rung = rung_walls(forward, model, ladder, boards, "direct forward")
    idx = np.arange(ladder.max_bucket) % len(boards[0])
    profile = profile_forward(forward, model, *(a[idx] for a in boards))
    return {"launches": served["launches"], "stats": stats,
            "cross_rung": cross, "forward_wall_ms": per_rung,
            "profile": profile, "model": model,
            "boards": tuple(a[:64] for a in boards)}


def cpu_copy(model, cfg=None):
    """A copy of ``model`` on the CPU, of ``cfg`` (default: its own)."""
    out = type(model)(cfg or model.cfg)
    out.load_state_dict(model.state_dict())
    return out


def grid_net(cfg) -> policy_cnn.PolicyCNN:
    """A net the int8 scheme represents exactly (tests/test_quant.py's
    grid_net): He-normal weights from the seed snapped onto the
    power-of-two int8 grid, plus a sharp last-layer per-position bias of
    N(0, 4) from a numpy seed so the argmax has real margins. Quantized on
    the card and on the CPU, its weights must agree bitwise."""
    model = policy_cnn.init(torch.Generator().manual_seed(SEED), cfg,
                            device="cuda")
    qmodel = quant.quantize_params(model)
    on_cpu = quant.quantize_params(cpu_copy(model))
    for a, b in zip(qmodel.layers, on_cpu.layers):
        check(torch.equal(a.w_q.cpu(), b.w_q)
              and torch.equal(a.w_scale.cpu(), b.w_scale),
              "quantize_params on the card != on the CPU")
    snapped = quant.dequantize_params(qmodel)
    bias = np.random.default_rng(SEED).normal(0.0, 4.0, size=(19, 19, 1))
    with torch.no_grad():
        snapped.layers[-1].bias.copy_(torch.from_numpy(
            bias.astype(np.float32).transpose(2, 0, 1)))
    return snapped


def compare_variants(label, fa, pa, fb, pb, ladder, boards) -> dict:
    """Two variants' direct forwards on the same boards at rung 1 (8
    boards) and at the top rung (all boards): bitwise, or else within
    CROSS_RUNG_TOL over points with p >= 1e-3, with the difference
    printed."""
    n = len(boards[0])
    out = {}
    for bucket, idx in ((1, np.arange(8)), (ladder.max_bucket, np.arange(n))):
        a = direct(fa, pa, ladder, boards, idx, bucket)
        b = direct(fb, pb, ladder, boards, idx, bucket)
        exact = bool(np.array_equal(a, b))
        err = float(np.abs(a - b).max())
        err_mass = float(np.abs(a - b)[np.exp(b) >= 1e-3].max())
        print(f"{label} at rung {bucket}: "
              + ("bitwise equal" if exact else
                 f"NOT bitwise: max-abs {err:.3g}, over p >= 1e-3 "
                 f"{err_mass:.3g} (tolerance {CROSS_RUNG_TOL})"), flush=True)
        check(exact or err_mass <= CROSS_RUNG_TOL, f"{label} at rung "
              f"{bucket}")
        out[str(bucket)] = {"exact": exact, "max_abs": err,
                            "max_abs_p_ge_1e-3": err_mass}
    return out


def phase_variant_path(rng) -> dict:
    cfg = policy_cnn.CONFIGS["full"]
    model = grid_net(cfg)
    boards = serving_boards(rng)
    t0 = time.perf_counter()
    report = verify_variant(cfg, model, "int8+sym", device="cuda")
    t_gate = time.perf_counter() - t0
    print(f"int8+sym tolerance gate ({t_gate:.2f} s): "
          + json.dumps(report), flush=True)
    check(report["verdict"] == "pass"
          and set(report["rungs"]) == {"1", "8", "32", "128", "512"}
          and all(r["ok"] for r in report["rungs"].values()),
          "int8+sym passes its tolerance gate at every rung")

    engine = policy_engine(model, cfg, config=EngineConfig(max_wait_ms=50.0),
                           device="cuda", name="policy-int8+sym",
                           variant="int8+sym")
    check(engine.variant == "int8+sym"
          and engine.prepare_params is quant.quantize_params,
          "engine stamped with its variant")
    cuda_expand.reset_launches()
    served = drive_engine(engine, boards, lambda: (cuda_expand.sym_launches,
                                                   cuda_expand.launches))
    stats = served["stats"]
    sym_launches, expand_launches = served["launches"]
    check(sym_launches == stats["forwards"] >= 1 and expand_launches == 0,
          f"sym kernel launches {sym_launches} != engine forwards "
          f"{stats['forwards']}, or expand kernel launches "
          f"{expand_launches} != 0")
    print(f"int8+sym engine: sym kernel launched {sym_launches} times for "
          f"{stats['forwards']} forwards, expand kernel {expand_launches}",
          flush=True)

    spec = variant_spec(cfg, "int8+sym", device="cuda")
    forward, qmodel = spec.forward, spec.prepare(model)
    ladder = engine.ladder
    cross = check_rows(forward, qmodel, ladder, boards, served["futures"])
    identities = {
        "int8+sym vs sym": compare_variants(
            "int8+sym vs sym", forward, qmodel,
            variant_spec(cfg, "sym", device="cuda").forward, model, ladder,
            boards),
        "int8 vs f32": compare_variants(
            "int8 vs f32", variant_spec(cfg, "int8", device="cuda").forward,
            qmodel, make_log_prob_fn(cfg, device="cuda"), model, ladder,
            boards)}
    per_rung = rung_walls(forward, qmodel, ladder, boards,
                          "fused int8+sym forward")
    idx = np.arange(ladder.max_bucket) % len(boards[0])
    profile = profile_forward(forward, qmodel, *(a[idx] for a in boards))
    return {"launches": sym_launches, "expand_launches": expand_launches,
            "stats": stats, "gate_s": t_gate,
            "gate": {k: report[k] for k in ("verdict", "worst_top1",
                                            "worst_drift")},
            "cross_rung": cross, "identities": identities,
            "forward_wall_ms": per_rung, "profile": profile, "model": model,
            "boards": tuple(a[:64] for a in boards)}


def _kernel_group(name: str) -> str:
    lower = name.lower()
    if "expand_planes_sym" in lower:
        return "sym expand kernel"
    if "expand_planes" in lower:
        return "expand kernel"
    if "memcpy htod" in lower:
        return "h2d copy"
    if "memcpy dtoh" in lower:
        return "d2h copy"
    if "softmax" in lower:
        return "log_softmax"
    if any(k in lower for k in ("conv", "xmma", "cudnn", "gemm", "sm90")):
        return "convolution"
    if "gather" in lower:
        return "inverse gather"
    if "reduce" in lower:
        return "reductions (logsumexp)"
    return "elementwise (casts, scale, bias add, relu)"


def profile_forward(forward, model, packed, player, rank, runs: int = 5):
    """Device time of one forward by kernel group, from torch.profiler over
    ``runs`` forwards, beside the host wall time of one forward. Reports
    nothing (and says so) when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    forward(model, packed, player, rank)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            forward(model, packed, player, rank)
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    groups, kernels = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3 / runs
        group = _kernel_group(evt.key)
        groups[group] = groups.get(group, 0.0) + ms
        kernels[evt.key[:100]] = kernels.get(evt.key[:100], 0.0) + ms
    device_ms = sum(groups.values())
    if device_ms == 0.0:
        print("profile: torch.profiler recorded no device time", flush=True)
        return None
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    out = {"batch": len(packed), "wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy_share": device_ms / wall_ms, "groups_ms": groups,
           "top_kernels_ms": top}
    print("profile of one forward: " + json.dumps(out), flush=True)
    return out


def phase_card_vs_cpu(label, make_forward, model, boards) -> float:
    """``make_forward(cfg, device=...)``'s float32 forward of ``model``'s
    weights on the card (TF32 off) against the same on the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(model.cfg, compute_dtype="float32")
    card = make_forward(cfg, device="cuda")(cpu_copy(model, cfg).cuda(),
                                             *boards)
    cpu = make_forward(cfg, device="cpu")(cpu_copy(model, cfg), *boards)
    err = float(np.abs(card - cpu).max())
    print(f"card vs CPU, {label}, float32 with cudnn.allow_tf32 = False and "
          f"cuda.matmul.allow_tf32 = False, over {len(boards[0])} boards: "
          f"max-abs {err:.3g} (tolerance {F32_CARD_VS_CPU_TOL})", flush=True)
    check(np.isfinite(card).all() and err <= F32_CARD_VS_CPU_TOL,
          f"card vs CPU float32, {label}")
    return err


def kernel_entry(name, replaces, launches, rows, top) -> dict:
    return {"name": name, "route": "cuda",
            "source": "deepgo_tpu_torch/ops/csrc/expand.cu",
            "replaces": replaces, "launches": launches,
            "exact": all(r["exact"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "kernel_ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "shape": f"B={top['batch']} S={top['symmetries']} {top['dtype']}",
            "by_shape": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card {kind}", flush=True)
    torch.backends.cudnn.benchmark = False  # one algorithm per shape

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in sorted(_build.build_log.items()):
        print(f"nvcc {name}: {log.strip()}", flush=True)

    rng = np.random.default_rng(SEED)
    kernel_rows = phase_kernel(rng)
    sym_rows = phase_sym_kernel(rng)
    path = phase_main_path(rng)
    var = phase_variant_path(rng)
    f32_err = phase_card_vs_cpu("plain forward", make_log_prob_fn,
                                path["model"], path["boards"])
    sym_err = phase_card_vs_cpu(
        "fused sym forward", quant.make_fused_sym_policy_fn, var["model"],
        tuple(a[:CARD_VS_CPU_BOARDS] for a in var["boards"]))

    def top_row(rows, s):
        return next(r for r in rows if r["batch"] == 512
                    and r["symmetries"] == s and r["dtype"] == "bfloat16")

    kernels = {"kernels": [
        kernel_entry("expand_planes", "deepgo_tpu/ops/pallas_expand.py:84",
                     path["launches"], kernel_rows, top_row(kernel_rows, 1)),
        kernel_entry("expand_planes_sym",
                     "deepgo_tpu/ops/pallas_expand.py:90", var["launches"],
                     sym_rows, top_row(sym_rows, 8)),
    ]}
    print("summary: " + json.dumps({
        "card_vs_cpu_f32_max_abs": f32_err,
        "card_vs_cpu_fused_sym_f32_max_abs": sym_err,
        "f32_path": {"cross_rung_max_abs": path["cross_rung"],
                     "forward_wall_ms": path["forward_wall_ms"],
                     "profile": path["profile"], "engine": path["stats"]},
        "int8_sym_path": {k: var[k] for k in (
            "gate", "gate_s", "cross_rung", "identities", "forward_wall_ms",
            "profile", "expand_launches")} | {"engine": var["stats"]},
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
