#!/usr/bin/env python3
"""Drive the PyTorch port's policy serving path on one CUDA card and check it.

Run from the repository root, on a machine with one NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deepgo_tpu_torch/ops/csrc`` and
then, each phase failing the run on the first disagreement:

1. device: requires CUDA; reads the card's name and power limit.
2. build: compiles every kernel source (one nvcc each, in parallel).
3. kernel vs plain: the expansion kernel against its plain PyTorch version
   on the card, exactly, in bf16 and float32 at B = 1, 8, 37, 512, over
   random uint8 records, out-of-range players and ranks 0..10; times both
   with CUDA events beside the kernel's bound.
4. main path: ``policy_engine`` over the ``full`` config (12 layers x 128
   channels, bf16, random weights from a seed) answers bursts of concurrent
   single-board requests from 8 threads that land on every ladder rung.
   Every row is finite and normalised, bitwise equal to the direct forward
   at its rung, and within ``CROSS_RUNG_TOL`` of the same board's row at
   the top rung; the kernel's launch count equals the engine's forwards.
   Then, for the record, the direct forward's wall time per rung and a
   torch.profiler breakdown of one top-rung forward by kernel group.
5. card vs CPU: the float32 forward on the card (TF32 off) against the
   CPU forward, which the CPU tests tie to the JAX package: max-abs <= 1e-4.

The last lines are a ``summary:`` JSON line of the path's checks and
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

from deepgo_tpu_torch.models import policy_cnn
from deepgo_tpu_torch.models.serving import make_log_prob_fn
from deepgo_tpu_torch.ops import _build, cuda_expand
from deepgo_tpu_torch.ops import expand as plain_expand
from deepgo_tpu_torch.serving import EngineConfig, policy_engine

SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM non-tensor rate, for the compares
KERNEL_BATCHES = (1, 8, 37, 512)
# Burst sizes of the main path: each lands on one rung of the default
# ladder (1, 8, 32, 128, 512) when it coalesces into one dispatch.
BURSTS = (1, 5, 20, 100, 400, 3, 60, 250, 7, 30)
THREADS = 8
# A board's log-probs at one rung against the top rung: cuDNN may choose a
# different convolution algorithm per batch size, which rounds differently
# in bf16 through 12 layers. Held over points with p >= 1e-3.
CROSS_RUNG_TOL = 0.05
F32_CARD_VS_CPU_TOL = 1e-4


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


def expand_bound(b: int, out_bytes: int) -> tuple[float, str]:
    """Least time for the expansion of b boards: bytes (each input read
    once, each output written once) over the memory rate, or its compares
    (about 40 per point) over the non-tensor rate, whichever is larger."""
    moved = b * (9 * 361 + 8) + b * 361 * 37 * out_bytes
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = b * 361 * 40 / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def phase_kernel(rng) -> list[dict]:
    rows = []
    for b in KERNEL_BATCHES:
        packed, player, rank = random_records(rng, b, players=(1, 2),
                                              ranks=(0, 10))
        player[: min(b, 4)] = np.array([0, 3, -1, 255], np.int32)[: min(b, 4)]
        args = [torch.from_numpy(a).cuda() for a in (packed, player, rank)]
        for dtype, out_bytes in ((torch.bfloat16, 2), (torch.float32, 4)):
            got = cuda_expand.expand_planes_cuda(*args, dtype=dtype)
            want = plain_expand.expand_planes(*args, dtype=dtype)
            torch.cuda.synchronize()
            check(got.shape == want.shape == (b, 19, 19, 37)
                  and got.is_contiguous(), f"kernel output shape at B={b}")
            err = (got.float() - want.float()).abs().max().item()
            check(torch.equal(got, want),
                  f"kernel != plain at B={b} {dtype} (max-abs {err})")
            kernel = time_ms(lambda: cuda_expand.expand_planes_cuda(
                *args, dtype=dtype))
            plain = time_ms(lambda: plain_expand.expand_planes(
                *args, dtype=dtype), runs=50)
            bound, bound_by = expand_bound(b, out_bytes)
            rows.append({"batch": b, "dtype": str(dtype).split(".")[-1],
                         "exact": True, "max_abs_err": err,
                         "ms": kernel["ms"], "wall_ms": kernel["wall_ms"],
                         "plain_ms": plain["ms"],
                         "plain_wall_ms": plain["wall_ms"],
                         "bound_ms": bound, "bound_by": bound_by})
            print(f"kernel B={b:4d} {rows[-1]['dtype']:>8}: exact, "
                  f"{kernel['ms'] * 1e3:.2f} us device "
                  f"({kernel['wall_ms'] * 1e3:.1f} us wall), plain "
                  f"{plain['ms'] * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
                  f"({bound_by})", flush=True)
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


def phase_main_path(rng) -> dict:
    cfg = policy_cnn.CONFIGS["full"]
    check(cfg.num_layers == 12 and cfg.channels == 128
          and cfg.compute_dtype == "bfloat16", "full config")
    model = policy_cnn.init(torch.Generator().manual_seed(SEED), cfg,
                            device="cuda")
    n = sum(BURSTS)
    packed = rng.integers(0, 3, size=(n, 9, 19, 19), dtype=np.uint8)
    player = rng.integers(1, 3, size=n).astype(np.int32)
    rank = rng.integers(1, 10, size=n).astype(np.int32)

    cuda_expand.reset_launches()
    t0 = time.perf_counter()
    engine = policy_engine(model, cfg, config=EngineConfig(max_wait_ms=50.0),
                           device="cuda")
    try:
        warm = engine.warmup()
        t_warm = time.perf_counter() - t0
        t1 = time.perf_counter()
        futures = run_bursts(engine, packed, player, rank)
        t_serve = time.perf_counter() - t1
    finally:
        engine.close()
    launches = cuda_expand.launches
    stats = engine.stats()
    print(f"engine: {warm} rungs warmed in {t_warm:.2f} s; {n} requests "
          f"in {len(BURSTS)} bursts served in {t_serve:.2f} s", flush=True)
    print("engine stats: " + json.dumps(stats), flush=True)
    ladder = engine.ladder
    check(launches == stats["forwards"] >= 1,
          f"expand kernel launches {launches} != engine forwards "
          f"{stats['forwards']}")
    check(stats["boards"] == n and stats["dispatch_failures"] == 0
          and stats["timeouts"] == 0, "every request served once")
    hit = {int(k) for k in stats["bucket_hits"]}
    check(hit == set(ladder.buckets), f"rungs hit {sorted(hit)} != ladder "
          f"{ladder.buckets}")

    rows = np.stack([f.result() for f in futures])
    buckets = np.array([f.bucket for f in futures])
    check(rows.shape == (n, 361) and rows.dtype == np.float32, "row shape")
    check(bool(np.isfinite(rows).all()), "finite rows")
    lse = np.log(np.exp(rows.astype(np.float64)).sum(axis=1))
    check(float(np.abs(lse).max()) <= 1e-3, f"rows normalised (max "
          f"|logsumexp| {np.abs(lse).max()})")

    forward = make_log_prob_fn(cfg, device="cuda")

    def direct(idx, bucket):
        out = []
        for s in range(0, len(idx), bucket):
            part = idx[s:s + bucket]
            out.append(forward(model, *ladder.pad(
                packed[part], player[part], rank[part], bucket))[:len(part)])
        return np.concatenate(out)

    for bucket in ladder.buckets:
        idx = np.flatnonzero(buckets == bucket)
        check(np.array_equal(rows[idx], direct(idx, bucket)),
              f"engine rows at rung {bucket} != direct forward bitwise")
    top = direct(np.arange(n), ladder.max_bucket)
    mask = np.exp(top) >= 1e-3
    cross = float(np.abs(rows - top)[mask].max())
    print(f"engine rows bitwise equal to the direct forward at their rung; "
          f"max-abs vs the top rung over p >= 1e-3: {cross:.3g} "
          f"(tolerance {CROSS_RUNG_TOL})", flush=True)
    check(cross <= CROSS_RUNG_TOL, "rows across rungs")

    per_rung = {}
    for bucket in ladder.buckets:
        idx = np.arange(bucket) % n
        t = time_ms(lambda: forward(model, packed[idx], player[idx],
                                    rank[idx]), runs=20, warmup=3)
        per_rung[str(bucket)] = t["wall_ms"]
    print("direct forward wall ms per rung (numpy in, numpy out): "
          + json.dumps(per_rung), flush=True)
    idx = np.arange(ladder.max_bucket) % n
    profile = profile_forward(forward, model, packed[idx], player[idx],
                              rank[idx])
    return {"launches": launches, "stats": stats, "cross_rung": cross,
            "forward_wall_ms": per_rung, "profile": profile, "model": model,
            "boards": (packed[:64], player[:64], rank[:64])}


def _kernel_group(name: str) -> str:
    lower = name.lower()
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
    return "elementwise (casts, bias add, relu)"


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
        kernels[evt.key] = ms
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


def phase_card_vs_cpu(model, boards) -> float:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card vs CPU in float32 with cudnn.allow_tf32 = False and "
          "cuda.matmul.allow_tf32 = False", flush=True)
    cfg = dataclasses.replace(model.cfg, compute_dtype="float32")
    state = model.state_dict()
    on_card = policy_cnn.PolicyCNN(cfg)
    on_card.load_state_dict(state)
    on_cpu = policy_cnn.PolicyCNN(cfg)
    on_cpu.load_state_dict(state)
    card = make_log_prob_fn(cfg, device="cuda")(on_card.cuda(), *boards)
    cpu = make_log_prob_fn(cfg, device="cpu")(on_cpu.cpu(), *boards)
    err = float(np.abs(card - cpu).max())
    print(f"card vs CPU float32 log-probs over {len(boards[0])} boards: "
          f"max-abs {err:.3g} (tolerance {F32_CARD_VS_CPU_TOL})", flush=True)
    check(np.isfinite(card).all() and err <= F32_CARD_VS_CPU_TOL,
          "card vs CPU float32")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one CUDA card",
              file=sys.stderr)
        return 1
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
    path = phase_main_path(rng)
    f32_err = phase_card_vs_cpu(path["model"], path["boards"])

    top = next(r for r in kernel_rows
               if r["batch"] == 512 and r["dtype"] == "bfloat16")
    kernels = {"kernels": [{
        "name": "expand_planes",
        "route": "cuda",
        "source": "deepgo_tpu_torch/ops/csrc/expand.cu",
        "replaces": "deepgo_tpu/ops/pallas_expand.py:84",
        "launches": path["launches"],
        "exact": all(r["exact"] for r in kernel_rows),
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": top["ms"], "kernel_ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None,
        "shape": "B=512 bfloat16",
        "by_shape": kernel_rows,
    }]}
    print("summary: " + json.dumps({
        "card_vs_cpu_f32_max_abs": f32_err,
        "cross_rung_max_abs": path["cross_rung"],
        "forward_wall_ms": path["forward_wall_ms"],
        "profile": path["profile"], "engine": path["stats"]}), flush=True)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
