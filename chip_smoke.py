#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and check them.

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
   ranks 0..10; also at the train steps' batches (B = 256, 1024, the
   expansion kernel), at the other rungs of the ladder (B = 32, 128; the
   sym kernel at S = 8), at shapes whose S * B * 361 is not a multiple of 8
   (B = 7 at S = 1, 5; B = 1 at S = 2: the output's last 16-byte vector is
   ragged) and on a sliced input (``packed[1:]`` of 513 boards, at an odd
   address); at S = 1 the sym kernel also equals the expansion kernel.
   Both are timed with CUDA events beside their bounds: one call, and per
   launch over 20 back-to-back launches.
4. f32 path: ``policy_engine`` over the ``full`` config (12 layers x 128
   channels, bf16, random weights from a seed) answers bursts of concurrent
   single-board requests from 8 threads that land on every ladder rung.
   Every row is finite and normalised, bitwise equal to the direct forward
   at its rung, and within ``CROSS_RUNG_TOL`` of the same board's row at
   the top rung; so are 16 more draws of 64 boards, each through the direct
   forward at every rung. The expansion kernel's launches equal the
   engine's forwards. Then, for the record, the direct forward's wall time
   per rung and a torch.profiler breakdown of one top-rung forward by
   kernel group.
5. variant path: ``policy_engine(variant="int8+sym")`` on ``full`` over a
   "grid net" (random weights snapped onto the int8 grid, sharp last-layer
   bias). Its tolerance gate passes at every rung; the same bursts as in 4;
   the same row checks against the direct fused forward, within
   ``GRID_NET_CROSS_RUNG_TOL`` across rungs (the bias makes the logits, and
   so bf16's rounding of them, larger); the sym kernel's launches equal
   the engine's forwards and the expansion kernel's stay 0.
   On the grid net int8+sym rows equal sym rows and int8 rows equal f32
   rows bitwise. Then wall time per rung and a profile of one top-rung
   fused forward (512 boards x 8 views).
6. card vs CPU: the float32 plain forward and the float32 fused sym forward
   on the card (TF32 off) against the CPU, which the CPU tests tie to the
   JAX package: max-abs <= 1e-4.
7. training path: a seeded synthetic split (100 games x 100 positions for
   train, 10 x 100 for validation, targets from a Zipf law over 40 points)
   written with the port's DatasetWriter into a temporary directory, then
   ``Experiment(..., device="cuda").run(60)`` on ``full`` (bf16, SGD at
   rate 0.005, B = 256, K = 10 steps per call, loader threads with device
   prefetch, nibble wire by "auto", validation of 512 positions at steps
   30 and 60, keep_checkpoints=1). Every loss is finite, the final EWMA is
   below the first window's mean, the expansion kernel launched once per
   train step and per eval batch (sym kernel 0), retention kept the newest
   and the best checkpoint, and the newest reloads bitwise and continues.
   One K = 10 call on a fixed batch drives its loss down. A float32 step
   at B = 64 on the card (TF32 off) matches the CPU's within 1e-5 (loss
   and every updated parameter). A child process in deterministic mode
   (``torch.use_deterministic_algorithms``, cuDNN deterministic,
   ``CUBLAS_WORKSPACE_CONFIG``, set before CUDA starts) holds a 40-step
   run equal to 20 + save + load + 20 bitwise, and the loader's
   side-stream prefetch (device_prefetch=2) to the inline copy's losses
   bitwise. For the record: ms per step and samples/s at B = 256 and 1024,
   one step and K = 10 per call, beside the FLOP bound; the same at
   B = 256 in deterministic mode; a torch.profiler breakdown of one
   B = 256 step by kernel group.

The last lines are a ``summary:`` JSON line of the paths' checks and
timings, the card line from nvidia-smi, one ``kernels`` JSON object (the
expansion kernel's launches by path), and ``{"ok": true, "device":
{...}}``. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from deepgo_tpu_torch.data.dataset import DatasetWriter, GoDataset
from deepgo_tpu_torch.data.loader import (AsyncLoader, make_step_batch,
                                          to_device)
from deepgo_tpu_torch.experiments import checkpoint as ckpt
from deepgo_tpu_torch.experiments.experiment import (Experiment,
                                                     ExperimentConfig)
from deepgo_tpu_torch.models import policy_cnn, quant
from deepgo_tpu_torch.models.serving import make_log_prob_fn
from deepgo_tpu_torch.ops import _build, cuda_expand
from deepgo_tpu_torch.ops import expand as plain_expand
from deepgo_tpu_torch.serving import (EngineConfig, policy_engine,
                                      variant_spec, verify_variant)
from deepgo_tpu_torch.training import (make_train_step, make_train_step_many,
                                       sgd)
from deepgo_tpu_torch.utils.metrics import read_jsonl

SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM non-tensor rate, for the compares
KERNEL_BATCHES = (1, 8, 37, 512)
SYMMETRIES = (1, 3, 8)
# (batch, symmetries) the engines also launch with: the other ladder rungs
RUNGS = ((32, 8), (128, 8))
# (batch, symmetries) with S * B * 361 not a multiple of 8
RAGGED = ((7, 1), (7, 5), (1, 2))
TRAIN_BATCHES = (256, 1024)  # the expansion kernel at the train steps' B
SLICED = 512        # boards of packed[1:] of SLICED + 1: an odd address
BACK_TO_BACK = 20   # launches between one pair of events, for per-launch ms
# Burst sizes of the engine paths: each lands on one rung of the default
# ladder (1, 8, 32, 128, 512) when it coalesces into one dispatch.
BURSTS = (1, 5, 20, 100, 400, 3, 60, 250, 7, 30)
THREADS = 8
# A board's log-probs at one rung against the top rung, over points with
# p >= 1e-3: cuDNN may choose a different convolution algorithm per batch
# size (on an H100 it does for 8 or fewer boards through the convolutions:
# rungs 1 and 8 of the plain forward, rung 1 of the 8-view one), and the
# two round the bf16
# logits differently, by up to about one bf16 spacing at the logits'
# magnitude. Random He-normal weights give a nearly flat policy with logits
# under 2 (spacing <= 2^-7). The same tolerance holds two variants' rows
# against each other where cuDNN breaks the bitwise grid-net identities.
CROSS_RUNG_TOL = 0.05
# The grid net's N(0, 4) last-layer bias (largest |bias| 15.09 at SEED)
# puts its larger logits in [8, 16), where bf16's spacing is 2^-4: two
# spacings.
GRID_NET_CROSS_RUNG_TOL = 2 * 2.0 ** -4
# The cross-rung spread beyond the engine's rows: SPREAD_DRAWS draws of
# SPREAD_BOARDS boards, each through the direct forward at every rung.
SPREAD_DRAWS = 16
SPREAD_BOARDS = 64
F32_CARD_VS_CPU_TOL = 1e-4
CARD_VS_CPU_BOARDS = 16
# Phase 7, the training path. The synthetic split: games x positions of
# random records whose targets follow a Zipf law over TARGET_POINTS fixed
# points (entropy about 2.9 nats, against ln 361 = 5.89 for a flat policy).
SPLIT_GAMES = {"train": 100, "validation": 10}
GAME_POSITIONS = 100
TARGET_POINTS = 40
# Plain SGD (no momentum), the reference's optimizer. At 0.05 and 0.01 the
# full net's loss on a fixed batch jumps back up within ten steps; at 0.005
# it falls at every step.
TRAIN_RATE = 0.005
TRAIN_STEPS = 60
TRAIN_RUN = dict(      # the full config through Experiment.run
    name="chip-smoke", num_layers=12, channels=128, compute_dtype="bfloat16",
    batch_size=256, rate=TRAIN_RATE, steps_per_call=10, print_interval=10,
    validation_interval=30, validation_size=512, keep_checkpoints=1,
    seed=SEED, train_split="train", validation_split="validation",
    test_split="validation")
TIMED = ((256, 1), (256, 10), (1024, 1), (1024, 10))  # (batch, K) per call
STEP_CARD_VS_CPU_TOL = 1e-5
STEP_CARD_VS_CPU_BATCH = 64
RESUME_STEPS = 40      # deterministic resume: 40 == 20, save, load, 20
H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak (NVIDIA data sheet)
DEVICE = "cuda"            # phase 7's device


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


def sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per ms on this card."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def device_ms(fn, launches: int, reps: int) -> float:
    """Median device ms per launch of ``launches`` back-to-back calls of
    ``fn`` between one pair of events, the stream held by a 2 ms sleep so
    the host has queued them all before the first runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = int(sleep_cycles_per_ms() * 2.0)
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


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
    cycles = int(sleep_cycles_per_ms() * (2 * wall_ms + 0.05))
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
               out_bytes: int, err: float, sliced: bool) -> dict:
    kernel = time_ms(kernel_fn)
    launch_ms = device_ms(kernel_fn, BACK_TO_BACK, 10)
    plain = time_ms(plain_fn, runs=30)
    bound, bound_by = expand_bound(b, out_bytes, s)
    row = {"batch": b, "symmetries": s, "dtype": str(dtype).split(".")[-1],
           "sliced": sliced, "exact": True, "max_abs_err": err,
           "ms": kernel["ms"], "launch_ms": launch_ms,
           "wall_ms": kernel["wall_ms"], "plain_ms": plain["ms"],
           "plain_wall_ms": plain["wall_ms"], "bound_ms": bound,
           "bound_by": bound_by, "share_of_bound": bound / kernel["ms"]}
    print(f"{what} B={b:4d} S={s} {row['dtype']:>8}"
          f"{' sliced' if sliced else ''}: exact, "
          f"{kernel['ms'] * 1e3:.2f} us device, {launch_ms * 1e3:.2f} us "
          f"per launch of {BACK_TO_BACK} ({kernel['wall_ms'] * 1e3:.1f} us "
          f"wall), plain {plain['ms'] * 1e3:.1f} us, bound "
          f"{bound * 1e3:.2f} us ({bound_by}, "
          f"{row['share_of_bound']:.0%})", flush=True)
    return row


def kernel_inputs(rng, b, sliced=False):
    """Random records for b boards on the card; ``sliced``: the last b of
    b + 1, so that ``packed`` starts at an odd address."""
    n = b + sliced
    packed, player, rank = random_records(rng, n, players=(1, 2),
                                          ranks=(0, 10))
    odd = np.array([0, 3, -1, 255, 1, 2], np.int32)
    player[: min(n, 6)] = odd[: min(n, 6)]
    args = [torch.from_numpy(a).cuda()[n - b:] for a in (packed, player,
                                                         rank)]
    check(args[0].is_contiguous()
          and args[0].data_ptr() % 2 == int(sliced),
          f"input at B={b} (sliced {sliced}) contiguous, odd iff sliced")
    return args


def phase_kernel(rng, extra) -> list[dict]:
    """``extra`` draws the inputs of the shapes beyond KERNEL_BATCHES, so
    that ``rng`` reaches the engine phases in the same state as without
    them."""
    rows = []
    cases = [(b, False, rng) for b in KERNEL_BATCHES]
    cases += [(b, False, extra) for b, _ in RUNGS]
    cases += [(b, False, extra) for b, s in RAGGED if s == 1]
    cases += [(SLICED, True, extra)]
    cases += [(b, False, extra) for b in TRAIN_BATCHES]
    for b, sliced, gen in cases:
        args = kernel_inputs(gen, b, sliced)
        for dtype, out_bytes in ((torch.bfloat16, 2), (torch.float32, 4)):
            got = cuda_expand.expand_planes_cuda(*args, dtype=dtype)
            want = plain_expand.expand_planes(*args, dtype=dtype)
            torch.cuda.synchronize()
            check(got.shape == want.shape == (b, 19, 19, 37)
                  and got.is_contiguous(), f"kernel output shape at B={b}")
            err = (got.float() - want.float()).abs().max().item()
            check(torch.equal(got, want), f"kernel != plain at B={b} "
                  f"{dtype} sliced {sliced} (max-abs {err})")
            rows.append(kernel_row(
                "kernel", lambda: cuda_expand.expand_planes_cuda(
                    *args, dtype=dtype),
                lambda: plain_expand.expand_planes(*args, dtype=dtype),
                b, 1, dtype, out_bytes, err, sliced))
    return rows


def phase_sym_kernel(rng, extra) -> list[dict]:
    """``extra`` as for ``phase_kernel``."""
    rows = []
    cases = [(b, SYMMETRIES, False, rng) for b in KERNEL_BATCHES]
    cases += [(b, (s,), False, extra) for b, s in RUNGS + RAGGED]
    cases += [(SLICED, (1, 8), True, extra)]
    for b, views, sliced, gen in cases:
        args = kernel_inputs(gen, b, sliced)
        for s in views:
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
                      f"B={b} S={s} {dtype} sliced {sliced} (max-abs {err})")
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
                    b, s, dtype, out_bytes, err, sliced))
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


def serving_boards(rng, n=sum(BURSTS)):
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


def cross_rung_spread(forward, params, ladder, tol, label) -> dict:
    """The cross-rung difference over SPREAD_DRAWS draws of SPREAD_BOARDS
    boards each (generators of their own, seeded SEED + 100 + draw): per
    rung below the top, the largest over the draws, and per draw the
    largest over the rungs; every one within ``tol``."""
    by_rung = {str(b): 0.0 for b in ladder.buckets[:-1]}
    per_draw = []
    for d in range(SPREAD_DRAWS):
        boards = serving_boards(np.random.default_rng(SEED + 100 + d),
                                SPREAD_BOARDS)
        idx = np.arange(SPREAD_BOARDS)
        top = direct(forward, params, ladder, boards, idx, ladder.max_bucket)
        kept = np.exp(top) >= 1e-3
        worst = 0.0
        for bucket in ladder.buckets[:-1]:
            at = direct(forward, params, ladder, boards, idx, bucket)
            err = float(np.abs(at - top)[kept].max())
            by_rung[str(bucket)] = max(by_rung[str(bucket)], err)
            worst = max(worst, err)
        per_draw.append(worst)
    print(f"{label}: cross-rung max-abs over p >= 1e-3, {SPREAD_DRAWS} draws "
          f"of {SPREAD_BOARDS} boards: per rung " + json.dumps(by_rung)
          + f"; per draw min {min(per_draw):.3g} median "
          f"{statistics.median(per_draw):.3g} max {max(per_draw):.3g} "
          f"(tolerance {tol})", flush=True)
    check(max(per_draw) <= tol, f"{label}: cross-rung spread")
    return {"by_rung": by_rung, "per_draw": per_draw, "tolerance": tol}


def check_rows(forward, params, ladder, boards, futures, tol) -> float:
    """Engine rows finite, normalised, bitwise equal to ``forward`` at
    their rung and within ``tol`` of the top rung; returns the cross-rung
    max-abs."""
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
          f"(tolerance {tol})", flush=True)
    check(cross <= tol, "rows across rungs")
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
    cross = check_rows(forward, model, ladder, boards, served["futures"],
                       CROSS_RUNG_TOL)
    spread = cross_rung_spread(forward, model, ladder, CROSS_RUNG_TOL,
                               "direct forward")
    per_rung = rung_walls(forward, model, ladder, boards, "direct forward")
    idx = np.arange(ladder.max_bucket) % len(boards[0])
    profile = profile_forward(forward, model, *(a[idx] for a in boards))
    return {"launches": served["launches"], "stats": stats,
            "cross_rung": cross, "cross_rung_spread": spread,
            "forward_wall_ms": per_rung,
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
    check(np.abs(bias).max() < 16, "grid net bias under 16, as "
          "GRID_NET_CROSS_RUNG_TOL assumes")
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
    cross = check_rows(forward, qmodel, ladder, boards, served["futures"],
                       GRID_NET_CROSS_RUNG_TOL)
    spread = cross_rung_spread(forward, qmodel, ladder,
                               GRID_NET_CROSS_RUNG_TOL,
                               "fused int8+sym forward")
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
            "cross_rung": cross, "cross_rung_spread": spread,
            "identities": identities,
            "forward_wall_ms": per_rung, "profile": profile, "model": model,
            "boards": tuple(a[:64] for a in boards)}


def _kernel_group(name: str) -> str:
    lower = name.lower()
    if "expand_planes" in lower:  # one kernel body: plain, or gather + views
        return "expansion kernel"
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
    busy_ms = sum(groups.values())
    if busy_ms == 0.0:
        print("profile: torch.profiler recorded no device time", flush=True)
        return None
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    out = {"batch": len(packed), "wall_ms": wall_ms, "device_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms, "groups_ms": groups,
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


def write_split(root: str) -> int:
    """The seeded synthetic splits of phase 7, written with the port's
    DatasetWriter; returns their bytes on disk."""
    rng = np.random.default_rng(SEED + 7)
    points = rng.permutation(361)[:TARGET_POINTS]
    weights = 1.0 / np.arange(1, TARGET_POINTS + 1)
    weights /= weights.sum()
    size = 0
    for split, games in SPLIT_GAMES.items():
        writer = DatasetWriter(os.path.join(root, split))
        for g in range(games):
            packed, player, rank = random_records(rng, GAME_POSITIONS)
            target = points[rng.choice(TARGET_POINTS, GAME_POSITIONS,
                                       p=weights)]
            meta = np.stack([player, target // 19, target % 19, rank, rank,
                             np.zeros_like(player)], axis=1)
            writer.add_game(f"{split}-{g:03d}", packed, meta)
        check(writer.finalize() == games * GAME_POSITIONS, f"{split} split")
        size += os.path.getsize(os.path.join(root, split, "planes.bin"))
    return size


def train_config(root: str, **overrides) -> ExperimentConfig:
    return ExperimentConfig(**{**TRAIN_RUN, "data_root": root,
                               "run_dir": os.path.join(root, "runs"),
                               **overrides})


def record_losses(exp: Experiment) -> list:
    """Wrap the experiment's step functions so that every call's losses
    (device tensors, never read back here) land in the returned list."""
    losses = []

    def recording(step):
        def wrapped(model, opt_state, batch):
            model, opt_state, loss = step(model, opt_state, batch)
            losses.append(loss)
            return model, opt_state, loss
        return wrapped

    exp.train_step = recording(exp.train_step)
    exp.train_step_many = recording(exp.train_step_many)
    return losses


def same_state(a: Experiment, b: Experiment) -> bool:
    """Every parameter and optimizer leaf of two experiments bitwise."""
    return all(torch.equal(x, y) for x, y in zip(
        a.model.state_dict().values(), b.model.state_dict().values())) and \
        torch.equal(a.opt_state["rate"], b.opt_state["rate"])


def phase_train_run(root: str) -> dict:
    """``Experiment.run`` on ``full`` through the loader threads, the
    nibble wire and the expansion kernel; then a reload that continues."""
    exp = Experiment(train_config(root), run_id="train", device=DEVICE)
    exp.init()
    check(exp.wire == "nibble" and exp._steps_per_call() == 10,
          "auto wire is nibble and K is print_interval on cuda")
    losses = record_losses(exp)
    cuda_expand.reset_launches()
    t0 = time.perf_counter()
    summary = exp.run(TRAIN_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, sym_launches = cuda_expand.launches, cuda_expand.sym_launches
    values = torch.cat([loss.reshape(-1) for loss in losses]).cpu().numpy()
    check(len(values) == TRAIN_STEPS and bool(np.isfinite(values).all()),
          f"{TRAIN_STEPS} finite losses")
    first = float(values[:TRAIN_RUN["print_interval"]].mean())
    print(f"train run: {TRAIN_STEPS} steps of B={TRAIN_RUN['batch_size']} in "
          f"{run_s:.2f} s (validation and checkpoints included); first "
          f"window mean {first:.4f}, final EWMA {exp.ewma:.4f}; losses "
          + json.dumps([round(float(v), 4) for v in values]), flush=True)
    check(exp.ewma < first, "the EWMA falls below the first window's mean")
    records = read_jsonl(os.path.join(exp.run_path, "metrics.jsonl"))
    vals = [r for r in records if r["kind"] == "validation"]
    check([r["step"] for r in vals] == [30, 60]
          and all(r["n"] == TRAIN_RUN["validation_size"] for r in vals),
          "validation at steps 30 and 60 over 512 positions")
    eval_batches = len(vals) * math.ceil(TRAIN_RUN["validation_size"]
                                         / TRAIN_RUN["batch_size"])
    print(f"train run: expansion kernel launched {launches} times for "
          f"{TRAIN_STEPS} train steps and {eval_batches} eval batches; sym "
          f"kernel {sym_launches}", flush=True)
    check(launches == TRAIN_STEPS + eval_batches and sym_launches == 0,
          f"expansion launches {launches} != {TRAIN_STEPS} steps + "
          f"{eval_batches} eval batches, or sym launches {sym_launches}")
    best = min(exp.validation_history, key=lambda r: r["cost"])["step"]
    kept = {s for s, _ in ckpt.list_checkpoints(exp.run_path)}
    check(kept == {TRAIN_STEPS, best}, f"retention kept {sorted(kept)}, "
          f"want the newest ({TRAIN_STEPS}) and the best ({best})")
    again = Experiment.load(ckpt.find_latest_valid(exp.run_path),
                            device=DEVICE)
    check(again.step == TRAIN_STEPS and again.ewma == exp.ewma
          and same_state(again, exp), "the checkpoint reloads bitwise")
    again.run(10)
    check(again.step == TRAIN_STEPS + 10 and math.isfinite(again.ewma),
          "the reloaded run continues")
    return {"launches": launches, "sym_launches": sym_launches,
            "eval_batches": eval_batches, "run_s": run_s,
            "first_window_mean": first, "final_ewma": exp.ewma,
            "validation": vals, "continued_ewma": again.ewma,
            "samples_per_sec": summary["samples_per_sec"]}


def fixed_superbatch(root: str, b: int, k: int, device) -> dict:
    """One step-indexed batch of b positions (nibble wire), repeated k
    times on a leading axis (k = 0: the batch itself), on ``device``."""
    one = make_step_batch(GoDataset(root, "train"), SEED, 0, b,
                          wire="nibble")
    if k:
        one = {n: np.stack([v] * k) for n, v in one.items()}
    return to_device(one, device)


def fresh_model(cfg=None, device=None) -> policy_cnn.PolicyCNN:
    return policy_cnn.init(torch.Generator().manual_seed(SEED),
                           cfg or policy_cnn.CONFIGS["full"],
                           device=device or DEVICE)


def phase_fixed_batch(root: str) -> list:
    """One K = 10 call on a fixed batch drives its loss down."""
    cfg = policy_cnn.CONFIGS["full"]
    opt = sgd(TRAIN_RATE)
    model = fresh_model()
    step = make_train_step_many(cfg, opt, wire="nibble")
    _, _, losses = step(model, opt.init(model),
                        fixed_superbatch(root, TRAIN_RUN["batch_size"], 10,
                                         DEVICE))
    values = losses.cpu().numpy().tolist()
    print("fixed batch, one K=10 call: losses " + json.dumps(
        [round(v, 4) for v in values]), flush=True)
    check(all(math.isfinite(v) for v in values) and values[-1] < values[0],
          "losses fall on a fixed batch")
    return values


def step_flops(cfg, b: int) -> float:
    """A train step's convolution FLOPs: forward, data gradient and weight
    gradient, each 2 * k * k * c_in * c_out per output point and board."""
    fwd = sum(2 * k * k * c_in * c_out * 361
              for k, c_in, c_out in cfg.layer_shapes())
    return 3.0 * fwd * b


def time_train_steps(root: str, timed=TIMED) -> list:
    """Device and wall ms per step of the full bf16 step on a resident
    batch, for each (batch, K) of ``timed``, beside the FLOP bound. The
    device time is the events' elapsed time around one call: where the host
    cannot queue a call's kernels ahead of the card (the launch queue holds
    about a thousand), it includes the card's idle gaps."""
    cfg = policy_cnn.CONFIGS["full"]
    opt = sgd(TRAIN_RATE)
    rows = []
    for b, k in timed:
        model = fresh_model()
        state = [opt.init(model)]
        if k == 1:
            step = make_train_step(cfg, opt, wire="nibble")
            batch = fixed_superbatch(root, b, 0, DEVICE)
        else:
            step = make_train_step_many(cfg, opt, wire="nibble")
            batch = fixed_superbatch(root, b, k, DEVICE)

        def call():
            _, state[0], _ = step(model, state[0], batch)

        t = time_ms(call, runs=20, warmup=3)
        ms, wall = t["ms"] / k, t["wall_ms"] / k
        bound = step_flops(cfg, b) / H100_BF16_FLOPS * 1e3
        rows.append({"batch": b, "k": k, "device_elapsed_ms_per_step": ms,
                     "wall_ms_per_step": wall,
                     "samples_per_sec": b / (wall / 1e3),
                     "device_samples_per_sec": b / (ms / 1e3),
                     "flop_bound_ms": bound, "share_of_bound": bound / ms})
        print(f"train step B={b:4d} K={k:2d}: {ms:.3f} ms device elapsed, "
              f"{wall:.3f} "
              f"ms wall per step, {b / (wall / 1e3):,.0f} samples/s; FLOP "
              f"bound {bound:.3f} ms ({bound / ms:.0%})", flush=True)
    return rows


# Kernel groups of a train step: the step's own labels (training/steps.py),
# then the backward's autograd nodes, then the kernel's name.
_TRAIN_LABELS = {"train.unwire": "nibble_unpack",
                 "train.augment": "augmentation",
                 "train.expand": "expansion kernel",
                 "train.loss": "log-softmax and NLL",
                 "train.optimizer": "optimizer"}
_CONV_NAMES = ("conv", "xmma", "cudnn", "gemm", "sm90", "implicit")


def train_group(kernel: str, scopes: list) -> str:
    lower = kernel.lower()
    if "memcpy htod" in lower:
        return "H2D copy"
    for scope in scopes:
        if scope in _TRAIN_LABELS:
            return _TRAIN_LABELS[scope]
        if scope == "train.forward":
            return ("conv forward" if any(c in lower for c in _CONV_NAMES)
                    else "elementwise forward (casts, bias add, relu)")
        node = scope.partition("evaluate_function: ")[2]
        if node.startswith("ConvolutionBackward"):
            if "dgrad" in lower:
                return "conv data gradient"
            if "wgrad" in lower:
                return "conv weight gradient"
            return "conv backward, other kernels"
        if node.startswith(("LogSoftmaxBackward", "NllLossBackward")):
            return "log-softmax and NLL"
        if node.startswith("AddBackward") and "reduce" in lower:
            return "bias-gradient reduction"
        if node:
            return "elementwise backward"
    return "other"


def profile_train_step(root: str, runs: int = 5):
    """Device time of one B = 256 train step by kernel group, from
    torch.profiler over ``runs`` steps fed by the sync loader (so the H2D
    copy is in the window), beside the host wall time of one step."""
    from torch.profiler import ProfilerActivity, profile

    cfg = policy_cnn.CONFIGS["full"]
    opt = sgd(TRAIN_RATE)
    model = fresh_model()
    state = opt.init(model)
    step = make_train_step(cfg, opt, wire="nibble")
    b = TRAIN_RUN["batch_size"]
    with AsyncLoader(GoDataset(root, "train"), b, seed=SEED, num_threads=0,
                     device=DEVICE, wire="nibble") as loader:
        for _ in range(2):
            model, state, _ = step(model, state, loader.get())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                model, state, _ = step(model, state, loader.get())
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    groups, kernels, launched = {}, {}, 0
    for evt in prof.events():
        if not evt.kernels:
            continue
        scopes, e = [], evt
        while e is not None:
            scopes.append(e.name)
            e = e.cpu_parent
        for k in evt.kernels:
            ms = k.duration / 1e3 / runs
            group = train_group(k.name, scopes)
            groups[group] = groups.get(group, 0.0) + ms
            kernels[k.name[:100]] = kernels.get(k.name[:100], 0.0) + ms
            launched += 1
    busy_ms = sum(groups.values())
    if busy_ms == 0.0:
        print("train profile: torch.profiler recorded no device time",
              flush=True)
        return None
    # the host's side: CPU time of the ops themselves, summed over threads
    # (the autograd engine runs the backward on a thread of its own)
    host = {e.key: e.self_cpu_time_total / 1e3 / runs
            for e in prof.key_averages()}

    def top(d, n):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])

    out = {"batch": b, "wall_ms": wall_ms, "device_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "kernels_per_step": launched / runs,
           "groups_ms": top(groups, len(groups)),
           "top_kernels_ms": top(kernels, 10),
           "host_cpu_ms": sum(host.values()),
           "top_host_ops_cpu_ms": top(host, 12)}
    print("profile of one train step: " + json.dumps(out), flush=True)
    return out


def phase_step_card_vs_cpu(root: str) -> dict:
    """One float32 train step on ``full`` at B = 64 on the card (TF32 off)
    against the same step on the CPU, which the CPU tests tie to the JAX
    package."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(policy_cnn.CONFIGS["full"],
                              compute_dtype="float32")
    out = {}
    for device in (DEVICE, "cpu"):
        opt = sgd(TRAIN_RATE)
        model = fresh_model(cfg, device)
        step = make_train_step(cfg, opt, wire="nibble")
        model, _, loss = step(model, opt.init(model), fixed_superbatch(
            root, STEP_CARD_VS_CPU_BATCH, 0, device))
        out[device] = (float(loss), [p.detach().cpu() for p in
                                     model.parameters()])
    loss_err = abs(out[DEVICE][0] - out["cpu"][0])
    param_err = max(float((a - b).abs().max())
                    for a, b in zip(out[DEVICE][1], out["cpu"][1]))
    print(f"train step card vs CPU, float32 full B={STEP_CARD_VS_CPU_BATCH} "
          f"with TF32 off: loss {out[DEVICE][0]:.6f} vs {out['cpu'][0]:.6f} "
          f"(|diff| {loss_err:.3g}), updated params max-abs {param_err:.3g} "
          f"(tolerance {STEP_CARD_VS_CPU_TOL})", flush=True)
    check(loss_err <= STEP_CARD_VS_CPU_TOL
          and param_err <= STEP_CARD_VS_CPU_TOL,
          "float32 train step card vs CPU")
    return {"loss_abs_err": loss_err, "param_max_abs": param_err}


def prefetch_losses(root: str, device_prefetch: int, calls: int = 3):
    """Per-step losses of ``calls`` K = 10 calls fed by one loader worker
    (a stream that is a pure function of the seed) with the given device
    prefetch, from the seed's model."""
    cfg = policy_cnn.CONFIGS["full"]
    opt = sgd(TRAIN_RATE)
    model = fresh_model()
    state = opt.init(model)
    step = make_train_step_many(cfg, opt, wire="nibble")
    losses = []
    with AsyncLoader(GoDataset(root, "train"), TRAIN_RUN["batch_size"],
                     seed=SEED, num_threads=1, prefetch=2, device=DEVICE,
                     stack=10, wire="nibble",
                     device_prefetch=device_prefetch) as loader:
        for _ in range(calls):
            model, state, loss = step(model, state, loader.get())
            losses.append(loss)
    return torch.cat(losses).cpu()


def deterministic_main(root: str) -> int:
    """The child process of phase 7: deterministic mode, set before CUDA
    starts. A resumed run equals an uninterrupted one bitwise; the loader's
    side-stream prefetch gives the losses of the inline copy; and the step
    times under determinism. Prints one ``deterministic:`` JSON line."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = train_config(root, loader_threads=0, validation_interval=10_000,
                       validation_size=256)
    whole = Experiment(cfg, run_id="whole", device=DEVICE)
    whole.run(RESUME_STEPS)
    part = Experiment(cfg, run_id="part", device=DEVICE)
    part.run(RESUME_STEPS // 2)
    resumed = Experiment.load(part.save(), device=DEVICE)
    resumed.run(RESUME_STEPS // 2)
    check(resumed.step == whole.step == RESUME_STEPS, "resume step count")
    resume_ok = same_state(resumed, whole) and resumed.ewma == whole.ewma
    print(f"deterministic resume: {RESUME_STEPS} steps vs "
          f"{RESUME_STEPS // 2} + save + load + {RESUME_STEPS // 2}: "
          + ("bitwise equal" if resume_ok else "DIFFERENT"), flush=True)
    check(resume_ok, "a resumed run equals an uninterrupted one bitwise")
    inline, prefetched = prefetch_losses(root, 0), prefetch_losses(root, 2)
    print(f"loader device_prefetch=2 vs 0 over {len(inline)} steps: "
          + ("bitwise equal" if torch.equal(inline, prefetched) else
             f"max-abs {float((inline - prefetched).abs().max()):.3g}"),
          flush=True)
    check(torch.equal(inline, prefetched),
          "side-stream prefetch gives the inline copy's losses")
    rows = time_train_steps(root, [t for t in TIMED if t[0] == 256])
    print("deterministic: " + json.dumps({"resume_bitwise": resume_ok,
                                          "prefetch_bitwise": True,
                                          "steps": len(inline),
                                          "timing": rows}), flush=True)
    return 0


def phase_deterministic(root: str) -> dict:
    """Run ``deterministic_main`` in a child process (the switches must be
    set before CUDA starts) and read its result."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--deterministic", root],
        capture_output=True, text=True, timeout=600)
    print(proc.stdout.rstrip(), flush=True)
    check(proc.returncode == 0, f"deterministic child exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("deterministic: ")]
    check(len(line) == 1, "deterministic child printed its result")
    out = json.loads(line[0].partition(": ")[2])
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_train_path() -> dict:
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as root:
        t0 = time.perf_counter()
        size = write_split(root)
        print(f"synthetic split: {size / 1e6:.1f} MB written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        run = phase_train_run(root)
        fixed = phase_fixed_batch(root)
        timing = time_train_steps(root)
        profile = profile_train_step(root)
        card_vs_cpu = phase_step_card_vs_cpu(root)
        det = phase_deterministic(root)
    key = "device_elapsed_ms_per_step"
    cost = {f"B={r['batch']} K={r['k']}": {
        "deterministic_ms": r[key], "default_ms": d[key],
        "cost": r[key] / d[key] - 1.0}
        for r in det["timing"] for d in timing
        if (d["batch"], d["k"]) == (r["batch"], r["k"])}
    print("cost of deterministic mode per step: " + json.dumps(cost),
          flush=True)
    return {"run": run, "fixed_batch_losses": fixed, "timing": timing,
            "profile": profile, "card_vs_cpu": card_vs_cpu,
            "deterministic": det, "deterministic_cost": cost}


def kernel_entry(name, replaces, launches_by_path, rows, top) -> dict:
    return {"name": name, "route": "cuda",
            "source": "deepgo_tpu_torch/ops/csrc/expand.cu",
            "replaces": replaces,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "exact": all(r["exact"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "kernel_ms": top["ms"],
            "launch_ms": top["launch_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "share_of_bound": top["share_of_bound"], "library_ms": None,
            "shape": f"B={top['batch']} S={top['symmetries']} {top['dtype']}",
            "by_shape": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one CUDA card",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--deterministic"] and len(sys.argv) == 3:
        return deterministic_main(sys.argv[2])
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
    extra = np.random.default_rng(SEED + 1)
    kernel_rows = phase_kernel(rng, extra)
    sym_rows = phase_sym_kernel(rng, extra)
    path = phase_main_path(rng)
    var = phase_variant_path(rng)
    f32_err = phase_card_vs_cpu("plain forward", make_log_prob_fn,
                                path["model"], path["boards"])
    sym_err = phase_card_vs_cpu(
        "fused sym forward", quant.make_fused_sym_policy_fn, var["model"],
        tuple(a[:CARD_VS_CPU_BOARDS] for a in var["boards"]))
    train = phase_train_path()

    def top_row(rows, s):
        return next(r for r in rows if r["batch"] == 512
                    and r["symmetries"] == s and r["dtype"] == "bfloat16"
                    and not r["sliced"])

    kernels = {"kernels": [
        kernel_entry("expand_planes", "deepgo_tpu/ops/pallas_expand.py:84",
                     {"serving_f32": path["launches"],
                      "training": train["run"]["launches"]},
                     kernel_rows, top_row(kernel_rows, 1)),
        kernel_entry("expand_planes_sym",
                     "deepgo_tpu/ops/pallas_expand.py:90",
                     {"serving_int8_sym": var["launches"],
                      "training": train["run"]["sym_launches"]},
                     sym_rows, top_row(sym_rows, 8)),
    ]}
    print("summary: " + json.dumps({
        "card_vs_cpu_f32_max_abs": f32_err,
        "card_vs_cpu_fused_sym_f32_max_abs": sym_err,
        "f32_path": {"cross_rung_max_abs": path["cross_rung"],
                     "cross_rung_spread": path["cross_rung_spread"],
                     "forward_wall_ms": path["forward_wall_ms"],
                     "profile": path["profile"], "engine": path["stats"]},
        "int8_sym_path": {k: var[k] for k in (
            "gate", "gate_s", "cross_rung", "cross_rung_spread", "identities",
            "forward_wall_ms", "profile", "expand_launches")}
        | {"engine": var["stats"]},
        "train_path": train | {"run": {
            k: v for k, v in train["run"].items() if k != "validation"}},
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
