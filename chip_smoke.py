#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, game, loop, parallel, tool and bench paths on CUDA cards and check them.

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
   launch over 20 back-to-back launches. Then the convolution epilogue
   (``ops.bias_relu``: per-position bias + ReLU, forward and backward
   kernels) at the main paths' shapes (``large`` B = 1024, C = 256;
   ``full`` B = 8192 and 64, C = 128; bf16): forward and dX bitwise the
   plain version, the bias gradient within one bf16 spacing and bitwise
   the same on a second run; each kernel timed beside its bytes bound and
   the plain version's time (the PyTorch ops the network ran before,
   also printed as ``library_ms``); and the launch counts of a ``large``
   train step (13 forwards, 13 backwards) and of a ``full`` serving
   forward (12 forwards, no backward). Then the residual network's BN
   epilogue (``ops.bn_relu``: batch normalisation in train mode, the skip
   added where there is one, ReLU; three kernels each way) at ``agz40``'s
   B = 512, C = 256, bf16, without the skip and with it: the output within
   one bf16 spacing of the plain version at BN's value, dX within one
   spacing, BN's scale and shift gradients and the running statistics
   within 1e-5, the ReLU masks apart at a millionth of the points at most,
   the backward bitwise the same on a second run; each way timed beside
   its bytes bound (the least: read x and the skip, write y; read dY, x
   and y, write dX and the skip's gradient) and the plain version's time;
   and the launch counts of an ``agz40`` train step (81 each way).
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
8. serving stack: ``fleet_policy_engine`` and ``fleet_value_engine`` on the
   card, each sub-path with the launch counts zeroed just before it and
   read just after. (a) Two supervised ``full`` replicas behind the router
   with the position cache (exact keys) serve phase 4's bursts, the
   requests rotating through the interactive, selfplay and batch tiers
   and a quarter of them repeating an earlier board or showing one of its
   dihedral views: rows finite, normalised, bitwise the direct forward at
   the rung they dispatched on, within ``CROSS_RUNG_TOL`` of the top rung;
   cache-served rows bitwise their leader's; expansion launches = the
   replicas' forwards, sym 0; per-tier p50/p99, the cache hit rate and
   dispatches per rung printed. (b) The same with replica 0's dispatcher
   killed once mid-burst by a fault plan: every request answered, a
   restart, the rows as in (a), the time from the death's flight dump to
   replica 0's first answer. (c) Under traffic, ``reload`` to seed-1
   weights as a module, back to seed 0, then to seed 1 from a checkpoint
   the port wrote: after each, rows bitwise the new weights' direct
   forward. (d) ``variants=("f32", "int8+sym")`` over phase 5's grid net:
   the gate passes, the f32 replica's forwards = expansion launches, the
   int8+sym replica's = sym launches, rows bitwise their variant's forward.
   (e) ``platforms=("cuda", "cpu")`` on the ladder (1, 8): batch-tier
   boards land on the CPU replica and add no launch, interactive boards
   on the card replica; after the card replica is ejected (and kept down)
   interactive boards fail over to the CPU replica, whose rows are bitwise
   its own forward at the rung and within ``CROSS_RUNG_TOL`` of the
   card's. (f) The value net (``ValueConfig`` defaults, 3 x 64, bf16,
   seed 0) behind two replicas: rows bitwise the direct value forward,
   launches = forwards; its float32 forward card vs CPU (TF32 off) within
   1e-4. Flight dumps, quarantine files and the checkpoint go to a
   temporary directory.
9. games: whole games on ``full`` (bf16, phase 4's weights; phase 5's grid
   net where said), each sub-path with the launch counts zeroed just before
   it and read just after. (a) ``self_play`` of 64 games (120 moves at most,
   temperature 0.5) through its private engine: the native rules engine
   built, every game replays through the port's Python rules to the same
   board, every game's SGF goes through the port's ``transcribe_game``
   (native) to records that list its moves and, for the first 4 games,
   equal the packed positions of the Python ``go.replay``; expansion
   launches = the engine's forwards. (b) ``play_match`` of two
   ``PolicyAgent``s (phase 4's net and the grid net) with no engine, at
   temperature 0, 4 games after 4 shared random opening plies, played
   twice: identical SGFs; launches = the direct forwards. (c) ``self_play``
   of 32 games over a two-replica fleet: no request lost, launches = the
   replicas' forwards. (d) A ``SearchAgent`` (64 simulations, waves of 16)
   against a ``PolicyAgent``, both through one two-replica fleet with the
   position cache, 2 games of at most 40 moves: every move legal, every
   search completes its budget with no lost simulation; the cache's hit
   rate, waves and wall per move printed. (e) The variant A/B arena: an
   f32 agent against an int8+sym agent of the grid net on their shared
   engines, 4 games of 60 moves: the f32 engine's forwards = expansion
   launches, the int8+sym engine's = sym launches. (f) The synthetic
   opening-heavy trace of ``data/sgf`` (512 requests) replayed open loop
   into a two-replica fleet with the cache: every request answered, span
   error, scheduling lag and hit rate printed.
10. loop, value training and sessions, each sub-path with the launch
   counts zeroed just before it and read just after. (a)
   ``ExpertIterationLoop`` on ``full`` (bf16) seeded from phase 4's
   weights: 2 actors playing rounds of 8 games of at most 60 moves
   through a two-replica fleet, the learner's 2 windows of 20 steps at
   B = 256 (SGD 0.005) over a frozen extent of at least 512 positions,
   and an 8-game gate that passes every challenger (threshold 0): no
   component fatal, durable games = acked games, every buffered game
   replays through the Python rules to its records, each gate's outcome
   recorded, the fleet's rows bitwise the champion's direct forward
   before each gate (after the learner's steps) and after each pass;
   expansion launches = fleet forwards + learner steps + the gate's
   direct forwards, each counted on its own. (b) A learner on ``full``
   SIGKILLed mid-window (``kill:step@6``) in a deterministic child, and a
   second child that resumes it and runs the same schedule uninterrupted:
   equal window digests, and ``replay_window`` recomputes every window's
   digest bitwise. (c) ``training.value.main`` on the card (``ValueCNN``
   3 x 64 bf16, B = 256, 60 steps, SGD 0.005 with momentum 0.9) over a
   synthetic split with a ``winner.npy`` sidecar: the validation loss is
   finite and falls, expansion launches = steps + evaluations, a float32
   value step card vs CPU (TF32 off) within 1e-5. (d) ``GameService``
   over a one-replica card fleet on ``full``: 4 sessions in 4 threads, 12
   client moves each answered on the interactive tier (launches = the
   fleet's forwards, the reopened store holds the same games); the port's
   ``sessions.child`` SIGKILLed after its 7th ack and rerun: every acked
   move recovered, and the finished games' digests equal an uninterrupted
   run's.
11. parallel, each sub-path in a child process with the launch counts
   zeroed just before it and read just after. (a) A float32 ``full``
   ``Experiment`` (B = 64, SGD with momentum, 3 steps, step-indexed) in
   deterministic mode, once outside any process group and once inside an
   NCCL group of one rank (``parallel.distributed.initialize``): bitwise
   equal, expansion launches = steps. (b) Two elastic hosts
   (``parallel.elastic.run_elastic``) over one run directory on the one
   card, ``full`` bf16 B = 256 with a checkpoint every 5-step window, host
   1 SIGKILLed at step 7: the survivor detects the loss through the
   heartbeat ledger, converges on the newest checkpoint and finishes; its
   final checkpoint equals an uninterrupted host's bitwise (deterministic
   mode); the ``ELASTIC_RECOVERY`` record (recovery latency, steps lost)
   is printed.

12. observability and chaos, each sub-path with the launch counts zeroed
   just before it and read just after. (a) Phase 7's ``full`` run (B = 256,
   60 steps) through ``Experiment.run`` twice, each on a registry of its
   own: with ``profile=False``, then with ``profile=True``, whose
   torch.profiler Chrome trace holds the span ranges by name and one
   ``expand_planes_kernel`` event per launch (the window's margins and
   any runtime launch without a device record are printed, and named if
   the counts differ); ``attribute_run`` covers at
   least 0.95 of the profiled run's wall with steps = 60 and the loader,
   first-call, dispatch, validation and checkpoint buckets; the run's cost
   ledger prices its train step; the forward's FLOP count is within 5 %
   of ``analytic_flops`` on the card's "table" peak, and the unprofiled
   run's MFU (analytic train FLOPs / step wall / peak) lies in (0, 1].
   (b) The chaos acceptance campaign (brownout, kill and corrupt) over
   phase 9f's trace on a defended two-replica fleet with the lock-order
   sanitizer armed: no future lost, no wrong answer, the corrupt replica
   canary-detected, no lock-order cycle, launches = the fleet's forwards;
   the brownout campaign undefended and defended; a cached fleet through
   a mid-trace reload and a kill (no stale hit). The SLO verdicts and
   interactive p50 / p99 are recorded, not gated. (c) A ``full`` engine under the runtime
   sanitizer (``DEEPGO_XLACHECK``): mixed-size bursts after warm-up find
   no new signature and no guard hit; an unstaged input planted inside a
   guard is caught twice (the sync check and the input check). (d) Phase
   10a's loop with ``telemetry=True``: its checks, and the dash's ``--json``
   frame over its store with the watchlist's series non-empty.

13. the command line on the card: ``deepgo_tpu_torch.cli.main`` called in
   this process, each sub-path with the launch counts zeroed just before
   it and read just after. (a) ``train --iters 30`` on phase 7's split
   (``full`` bf16, B = 256, SGD 0.005) with ``--obs-port`` while a thread
   scrapes ``/metrics`` (``deepgo_train_steps_total`` rising) and
   ``/healthz`` (200): launches = steps + eval batches; ``eval`` of its
   checkpoint; ``train --auto-resume --iters 40``, which resumes at 30.
   (b) ``serve --fleet 2 --variant f32,int8+sym`` of phase 5's grid net
   with ``--obs-port`` scraped and ``--watch``: the grid net's checkpoint
   published atomically at the watched path mid-run is hot-reloaded once
   (``deepgo_fleet_reloads_total`` + 1), ``/healthz`` 200, the expansion
   launches = the f32 replica's forwards and the sym launches = the
   tolerance gate's forwards + the int8+sym replica's; the signal
   handlers come back. (c) ``selfplay --model full --fleet 2 --games 8
   --max-moves 60``: launches = engine forwards. (d) ``cost --model full
   --json``: the ladder's FLOP count = ``analytic_flops`` of the rows it
   convolves (at least 64 a rung on the card), the 989 TFLOP/s table
   peak, one launch per priced entry. (e) ``lint`` over the
   checkout: no finding. (f) ``loop --windows 1 --actors 1`` from phase
   4's weights: acked = durable, launches = fleet + learner + gate
   forwards. (g) ``graft_entry.entry()``: its planes bitwise the plain
   expansion's, its bf16 log-probs within the bar of the card's float32
   forward. (h) ``python3 -m deepgo_tpu_torch.cli localtest --device
   cuda`` in a process of its own on the transcribed ``data/sgf``: exit
   0 and its ``localtest done`` line.

14. the tools on the card (``deepgo_tpu_torch/tools``), each through its
   ``main(argv)`` as a user types it, at ``full`` (12 x 128, bf16), each
   sub-path with the launch counts zeroed just before it and read just
   after; only depth is cut (positions, steps, games). (a) ``make_corpus``
   with the scripted pool (20k positions asked, chunk 256, 200 moves, 8
   opening plies), transcribed: three non-empty splits, games = SGF files,
   positions/s of generation and of transcription. (b) ``accuracy_curve``
   at budgets 4,000 and the whole train split, 300 steps at B = 256:
   launches = steps + evaluation batches (+ one per train step the cost
   ledger prices for the first time), the final EWMA at most 0.7 of the
   first window's, and the trained net's test top-1 at least the untrained
   net's (the same seed at step 0) + 0.05. (c) ``symmetry_eval`` of (b)'s
   largest-budget checkpoint at B = 512 on the test split and on 16,384
   train positions: sym launches = batches + 1 (the warm-up), expansion
   launches likewise for the plain mode; the same checkpoint in float32
   on the CPU agrees on plain test top-1 within 0.01; ``top1_delta`` and
   ``cost_ratio`` recorded. (d) ``make_selfplay_corpus`` of that net
   against ``oneply`` and itself (128 games, chunk 64, 4 opening plies,
   200 moves), transcribed: launches = policy forwards. (e) ``debug_twoply`` of that
   net, 4 games: launches = forwards, its stats line. (f) ``feed_bench``
   at the JAX base config (B = 512, K = 20, 4 loader threads, prefetch 8)
   with 100 steps a run and a window of 20: each streamed run's launches
   = its steps (+ pricing). (g) the port's walkthrough notebook cells
   (``make_notebook.cells("cuda")``) executed in order in one namespace.

15. the port's bench (``deepgo_tpu_torch/bench.py``) at the card sizes,
   cut in depth only (128 requests a submitter in the serving modes, of
   512). First ``python -m deepgo_tpu_torch.bench --mode
   inference`` in a process of its own (probe and watchdog armed): one
   line, exit 0, the card run recorded in a temporary last-good table.
   Then every mode through ``bench.main`` in this process, each on a
   registry and sanitizers of its own with the launch counts zeroed just
   before it and read just after: ``inference --gate`` (passes at the
   child's record; launches = 8 batches x (warm-up + 3 repeats + the
   priced call)), the same at 10x the record (exits 1), ``latency``
   (launches = forwards), ``train`` and ``large`` (launches = steps + the
   steps the cost ledger prices), ``serving`` (launches = the priced rungs
   + every engine's forwards), ``serving --faults`` (a restart),
   ``--fleet 2 --faults`` (a respawn, the reload through, both replicas
   serving), ``--variant int8+sym`` on the grid net (its tolerance gate
   passes; the sym kernel launches there and only there), ``--trace``
   over a capture recorded first with ``cli workload record`` (512
   requests over data/sgf's openings on ``full``: every request answered,
   the replay's timeline within its bar, the cache A/B), and
   ``distributed --faults`` (two ``cli train --elastic`` hosts of
   ``full`` bf16 at B = 256 on the card: one recovery, steps lost <= the
   checkpoint interval, the survivor's launches >= its steps). Each line:
   value > 0, no error, ``device`` the card's nvidia-smi line, every
   roofline MFU finite and <= 1.05; every request of a serving mode
   resolved. Then the campaign modes on ``small`` (the ladder 1-128):
   ``search`` (4 concurrent searches of 96 simulations, then a replica
   killed mid-search: the move lands), ``chaos`` (five campaigns: no
   answer lost, no stale cache hit), ``mixed`` (sessions beside a bulk
   scan on a (cuda, cpu) fleet, then a session child on the card
   SIGKILLed after 9 acks: no acked move lost, the resumed games
   bit-identical), each with launches > 0 and at most the forwards of
   the card's engines; and last ``loop`` and ``loop --faults`` (``full``
   bf16 at B = 256, 3 windows of 20 steps, deterministic kernels: no
   game lost, every window replayed bitwise, the champion advanced; with
   faults one kill per component class, no lock-order cycle, no transfer
   finding; launches = learner steps + replayed steps + the gate's direct
   forwards + the fleet's forwards, a killed window's rerun and a killed
   engine's forwards allowed under faults). Errors are accepted only in
   their exact shapes and printed (``bench_error``): the fleet plan's one
   typed ``FailoverExhausted`` and the clean-run silence contract's step
   or drift detections on the dispatch p99 (ROADMAP C7); the surge
   campaign's answers that the CPU surge replica rounded otherwise than
   the card (C10: each such board recomputed on both, outside rtol 1e-4
   and within ``CROSS_RUNG_TOL``); the mixed leg's interactive SLO miss
   and a scan the fleet absorbed without shedding, with every other
   coexistence and crash-resume check through (C9), and one move whose
   reply failed with a typed retriable error, printed with the fleet's
   counters at that moment (C14); and a search kill
   that missed the fleet while the move still landed in time (C13).

``--phases LIST`` (e.g. ``--phases 11``) runs only the listed phases of
4-15 (and the phases their nets come from); 1-3 always run.
``--phases 11 --cards 4`` is phase 11 on four cards instead, one NCCL rank
per card (it exits 1 without four cards): the layouts 4 x 1, 2 x 2 and
both with ZeRO on the float32 config of (a) at a global B = 64, each held
to one card's run (loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6) and
ZeRO bitwise equal to replicated; ``full`` bf16 data-parallel training at
B = 1024 (256 a card, K = 10, 60 steps) beside one card at B = 256, with
samples/s, wall per step, the all-reduce's device ms and the expansion
launches of every rank; a 2 x 2 + ZeRO checkpoint restored under 4 x 1
and 1 x 1 bitwise; ``nvidia-smi topo -m`` and every card's line.

The last lines are a ``summary:`` JSON line of the paths' checks and
timings, the card line from nvidia-smi (every card's with ``--cards 4``),
one ``kernels`` JSON object (each kernel's launches by path), and ``{"ok":
true, "device": {...}}``. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import cProfile
import dataclasses
import io
import json
import math
import os
import pstats
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from deepgo_tpu_torch import agents, match, selfplay, sgf
from deepgo_tpu_torch.data.dataset import DatasetWriter, GoDataset
from deepgo_tpu_torch.data.loader import (AsyncLoader, make_step_batch,
                                          to_device)
from deepgo_tpu_torch.data.transcribe import transcribe_game
from deepgo_tpu_torch.experiments import checkpoint as ckpt
from deepgo_tpu_torch.experiments.experiment import (Experiment,
                                                     ExperimentConfig)
from deepgo_tpu_torch.go import native, new_board, play, replay_positions
from deepgo_tpu_torch.loop import (ContinuousLearner, ExpertIterationLoop,
                                   LoopConfig, ReplayBuffer, read_windows,
                                   replay_window)
from deepgo_tpu_torch.loop import gatekeeper as loop_gatekeeper
from deepgo_tpu_torch.models import (convert, policy_cnn, quant, resnet,
                                     value_cnn)
from deepgo_tpu_torch.models.serving import (conv_rows, load_policy,
                                             load_value, make_log_prob_fn,
                                             make_value_fn)
from deepgo_tpu_torch.obs import configure_flight
from deepgo_tpu_torch.ops import (_build, cuda_bn_epilogue, cuda_epilogue,
                                  cuda_expand, expand_planes)
from deepgo_tpu_torch.ops import bn_epilogue as plain_bn_epilogue
from deepgo_tpu_torch.ops import epilogue as plain_epilogue
from deepgo_tpu_torch.ops import expand as plain_expand
from deepgo_tpu_torch.parallel import distributed, reshard
from deepgo_tpu_torch.search import SearchConfig
from deepgo_tpu_torch.serving import (BucketLadder, CacheConfig,
                                      EngineConfig, FleetConfig,
                                      SupervisorConfig, WorkloadReplayer,
                                      build_synthetic_requests,
                                      close_shared_engines,
                                      fleet_policy_engine,
                                      fleet_value_engine, ladder_for,
                                      policy_engine, variant_spec,
                                      verify_variant)
from deepgo_tpu_torch.sessions import GameService, SessionStore
from deepgo_tpu_torch.sessions import child as session_child
from deepgo_tpu_torch.training import value as value_training
from deepgo_tpu_torch.training import (make_train_step, make_train_step_many,
                                       sgd)
from deepgo_tpu_torch.utils import digest, faults
from deepgo_tpu_torch.utils.atomicio import atomic_write
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
# (config, B, C) of the epilogue on the main paths: the large train cell,
# the full bulk-inference cell and a 64-row serving forward
EPILOGUE_SHAPES = (("large", 1024, 256), ("full", 8192, 128),
                   ("full", 64, 128))
# (config, B, C) of the residual trunk's BN epilogue: the agz40 train cell
BN_EPILOGUE_SHAPE = ("agz40", 512, 256)
BN_LAUNCH_ROWS = 8  # the agz40 train step whose BN epilogues are counted
SLICED = 512        # boards of packed[1:] of SLICED + 1: an odd address
BACK_TO_BACK = 20   # launches between one pair of events, for per-launch ms
# Burst sizes of the engine paths: each lands on one rung of the default
# ladder (1, 8, 32, 128, 512) when it coalesces into one dispatch.
BURSTS = (1, 5, 20, 100, 400, 3, 60, 250, 7, 30)
THREADS = 8
# A board's log-probs at one rung against the top rung, over points with
# p >= 1e-3: cuDNN may choose a different convolution algorithm per batch
# size (on an H100 it does below 64 rows; the plain forward convolves at
# least 64, models/serving.CARD_MIN_ROWS, but the 8-view one not at rung
# 1), and the two round the bf16 logits differently, by up to about one
# bf16 spacing at the logits' magnitude. Random He-normal weights give a
# nearly flat policy with logits under 2 (spacing <= 2^-7). The same
# tolerance holds two variants' rows against each other where cuDNN breaks
# the bitwise grid-net identities.
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
    test_split="validation",
    # pricing runs one extra step; phase 12 (a) runs the ledger, and the
    # launch checks of phases 7 and 11 count the run's steps alone
    cost_ledger=False)
TIMED = ((256, 1), (256, 10), (1024, 1), (1024, 10))  # (batch, K) per call
STEP_CARD_VS_CPU_TOL = 1e-5
STEP_CARD_VS_CPU_BATCH = 64
RESUME_STEPS = 40      # deterministic resume: 40 == 20, save, load, 20
H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak (NVIDIA data sheet)
DEVICE = "cuda"            # phases 7 and 8's device
# Phase 8, the serving stack behind the engine. Requests rotate through
# the three tiers; a quarter repeat an earlier board or one of its views.
FLEET_TIERS = ("interactive", "selfplay", "batch")
RESTART_AT = 5        # replica 0's dispatcher dies at its 5th window
RELOAD_BOARDS = 64    # boards checked after each reload
SURGE_LADDER = (1, 8)  # keeps the CPU surge replica's forwards cheap
SURGE_BOARDS = {"batch": 32, "interactive": 16, "failover": 8}
# Phase 9, games on the card.
SELFPLAY_GAMES, SELFPLAY_MOVES, SELFPLAY_TEMPERATURE = 64, 120, 0.5
# games whose records are also held against the Python go.replay (the
# Python summarize is far slower than the native one, which transcribes
# all of them)
PYTHON_REPLAY_GAMES = 4
MATCH_GAMES, MATCH_MOVES, MATCH_OPENING = 4, 120, 4
FLEET_SELFPLAY_GAMES, FLEET_SELFPLAY_MOVES = 32, 60
SEARCH_SIMS, SEARCH_WAVE, SEARCH_GAMES, SEARCH_MOVES = 64, 16, 2, 40
ARENA_GAMES, ARENA_MOVES = 4, 60
REPLAY_REQUESTS = 512
# host profiles (cProfile): selfplay runs of this many moves, and cold
# searches at moves 0, 10, 20 and 30 of a search-match game
PROFILE_MOVES = 20
PROFILE_TOP = 8
SGF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "sgf")
# Phase 10, the expert-iteration loop, value training and sessions. The
# loop's learner is the full config at phase 7's batch and rate; the gate
# passes every challenger (threshold 0), so both windows drive a reload
# (the CPU tests hold the rejection path).
LOOP = dict(actors=2, fleet=2, games_per_round=8, max_moves=60,
            steps_per_window=20, min_window_positions=512, gate_games=8,
            gate_threshold=0.0, windows=2, stall_timeout_s=300.0)
LOOP_LEARNER = dict(name="chip-smoke-loop", num_layers=12, channels=128,
                    compute_dtype="bfloat16", batch_size=256,
                    rate=TRAIN_RATE, seed=SEED)
LOOP_PROBE_BOARDS = 32   # boards asked of the fleet around each gate
# the deterministic learner schedule: windows of steps, games of moves
# added before each window, and the step a SIGKILL lands on (window 2)
DET_WINDOWS, DET_STEPS, DET_GAMES, DET_MOVES, DET_KILL_STEP = 3, 4, 8, 60, 6
DET_MIN_POSITIONS = 256
# value training on a synthetic split whose winner is the stronger side
# (ranks 7-9 against 1-3): the rank planes carry the outcome, so the loss
# can fall within VALUE_STEPS. At the trainer's default rate of 0.02 (with
# momentum 0.9) the loss on this split did not fall in a CPU rehearsal at
# B = 64 (it stayed at ln 2, or rose); at 0.005 it fell to 0.01.
VALUE_GAMES = {"train": 40, "validation": 10}
VALUE_STEPS, VALUE_BATCH, VALUE_VAL_SIZE, VALUE_RATE = 60, 256, 1000, 0.005
VALUE_TIMED_STEPS = 20
VALUE_CARD_VS_CPU_BATCH = 64
# sessions: games x client moves, each answered by an engine reply; the
# crash-resume child's games, moves and the ack it dies after
SESSION_GAMES, SESSION_MOVES = 4, 12
SESSION_CHILD = ("--games", "2", "--moves", "6", "--checkpoint-every", "8")
SESSION_KILL_AFTER = 7
# Phase 11, the parallel layer. The float32 full config of (a) and of the
# four-card layouts: PAR_STEPS steps at a global B = 64, step-indexed, SGD
# with momentum (a state for ZeRO to shard), no validation.
PAR_STEPS = 3
PAR_F32 = dict(compute_dtype="float32", batch_size=64, momentum=0.9,
               steps_per_call=1, print_interval=PAR_STEPS,
               validation_interval=10_000, loader_threads=0)
# the four-card layouts: name -> (data, model, ZeRO), each held to one
# card's run within tests/test_parallel.py's tolerances at full width and
# PAR_GATE_LAYERS of full's 12 layers. Depth is cut for the gate because
# float32 itself drifts with depth: on an H100 one card's float32 gradients
# differ from float64 by up to 7e-6 of a leaf's largest value at 3 layers,
# 8e-4 at 6 and 8e-2 at 12 (a per-position bias), and a layout that splits
# the batch and the channels rounds otherwise; the 12-layer layouts are run
# and recorded beside the gate, and f32_drift measures the drift each call
PAR_LAYOUTS = {"4x1": (4, 1, False), "2x2": (2, 2, False),
               "4x1+zero": (4, 1, True), "2x2+zero": (2, 2, True)}
PAR_GATE_LAYERS = 3
PAR_LOSS_RTOL, PAR_PARAM_RTOL, PAR_PARAM_ATOL = 1e-5, 1e-4, 1e-6
PAR_CARDS = 4
PAR_BATCH_PER_CARD = 256   # phase 7's B per card; DP = 4 trains B = 1024
PAR_REPS = 20              # all-reduces between one pair of events
# (b) the elastic two-host run: phase 7's config, step-indexed, a
# checkpoint every 5-step window; host 1 dies at step 7, after the step-5
# checkpoint; the survivor's miss budget is 0.5 s x 10.
ELASTIC_RUN = dict(loader_threads=0, steps_per_call=1, print_interval=5,
                   validation_interval=5, validation_size=256,
                   keep_checkpoints=2)
ELASTIC_ITERS, ELASTIC_KILL_STEP = 400, 7
ELASTIC_BEAT_S, ELASTIC_MISSES = 0.5, 10

# Phase 12, observability and chaos. 12b's campaign mirrors the JAX
# package's chaos bench: no supervisor restarts (a killed dispatcher
# crosses into the fleet's failover and respawn), its SLO and backoffs.
# Its fleets serve one rung, which dates from when the port's bf16 rows
# differed across rungs (another batch size, another cuDNN algorithm;
# repaired by the card forward's 64-row minimum, ROADMAP C11); the
# campaign holds every answer to its ground truth at rtol 1e-4, which
# XLA's rung-invariant rows meet on the JAX package's.
OBS_TRAIN_STEPS = TRAIN_STEPS
ATTRIBUTION_BAR = 0.95     # tests/test_attribution.py's bar
FLOP_BAND = 0.05           # tests/test_costmodel.py's band
CHAOS_SLO = dict(slo_threshold_s=0.15, slo_target=0.95)
CHAOS_SUPERVISOR = dict(max_restarts=0, backoff_base_s=0.01,
                        backoff_cap_s=0.05)
CHAOS_FLEET = dict(respawn_base_s=0.01, respawn_cap_s=0.05)
CHAOS_ENGINE = dict(buckets=(32,), max_wait_ms=2.0)
SANITIZER_BURSTS = (1, 5, 20, 100, 7, 300, 2)
TELEMETRY_INTERVAL_S = 0.25


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


def all_cards() -> str:
    """Every card's name and power limit, one line each."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


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


def epilogue_inputs(gen: torch.Generator, b: int, c: int):
    """bf16 x (with zeros, negative zeros and sums that tie at 0) and a
    gradient dy, channels-last (b, c, 19, 19), and a float32 bias."""
    x = torch.randn(b, 19, 19, c, generator=gen, device="cuda").bfloat16()
    x.view(-1)[::7] = 0.0
    x.view(-1)[3::11] = -0.0
    bias = 0.5 * torch.randn(c, 19, 19, generator=gen, device="cuda")
    bias.view(-1)[::5] = -0.0
    x[::3] = -bias.bfloat16().permute(1, 2, 0)  # x + bias == 0 exactly
    dy = torch.randn(b, 19, 19, c, generator=gen, device="cuda").bfloat16()
    return x.permute(0, 3, 1, 2), bias, dy.permute(0, 3, 1, 2)


def bias_grad_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """One bf16 spacing at the larger value, or at 1e-5 of the largest
    gradient nearer 0 (tests/test_torch_epilogue.py's _same_sum)."""
    floor = 1e-5 * want.abs().max()
    at = torch.maximum(torch.maximum(got.abs(), want.abs()), floor)
    spacing = torch.ldexp(torch.ones_like(at), torch.frexp(at)[1] - 8)
    return bool(((got - want).abs() <= torch.maximum(spacing, floor)).all())


def epilogue_row(what, kernel_fn, plain_fn, moved: int, shape: str) -> dict:
    kernel = time_ms(kernel_fn)
    launch_ms = device_ms(kernel_fn, BACK_TO_BACK, 10)
    plain = time_ms(plain_fn, runs=30)
    bound = moved / HBM_BYTES_PER_S * 1e3
    row = {"shape": shape, "exact": True, "max_abs_err": 0.0,
           "ms": kernel["ms"], "launch_ms": launch_ms,
           "wall_ms": kernel["wall_ms"], "plain_ms": plain["ms"],
           "library_ms": plain["ms"], "bound_ms": bound, "bound_by": "bytes",
           "share_of_bound": bound / kernel["ms"]}
    print(f"{what} {shape}: {kernel['ms'] * 1e3:.1f} us device, "
          f"{launch_ms * 1e3:.1f} us per launch of {BACK_TO_BACK} "
          f"({kernel['wall_ms'] * 1e3:.1f} us wall), plain (the PyTorch "
          f"ops) {plain['ms'] * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
          f"(bytes, {row['share_of_bound']:.0%})", flush=True)
    return row


def epilogue_launches() -> dict:
    """The epilogue kernels' launches in one ``large`` train step at
    B = 1024 and one ``full`` serving forward of 64 boards."""
    gen = np.random.default_rng(SEED + 2)
    cfg = policy_cnn.CONFIGS["large"]
    model = policy_cnn.init(torch.Generator().manual_seed(SEED), cfg)
    optimizer = sgd(TRAIN_RATE)
    step = make_train_step(cfg, optimizer)
    packed, player, rank = random_records(gen, 1024)
    batch = {"packed": packed, "player": player, "rank": rank,
             "target": gen.integers(0, 361, 1024).astype(np.int32)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    state = optimizer.init(model)
    step(model, state, batch)
    torch.cuda.synchronize()
    cuda_epilogue.reset_launches()
    step(model, state, batch)
    torch.cuda.synchronize()
    train = [cuda_epilogue.launches, cuda_epilogue.bwd_launches]
    check(train == [13, 13], f"large train step: 13 + 13 epilogue "
          f"launches, got {train}")
    del model, state
    fcfg = policy_cnn.CONFIGS["full"]
    net = policy_cnn.init(torch.Generator().manual_seed(SEED), fcfg)
    forward = make_log_prob_fn(fcfg)
    boards = random_records(gen, 64)
    forward(net, *boards)
    cuda_epilogue.reset_launches()
    forward(net, *boards)
    serve = [cuda_epilogue.launches, cuda_epilogue.bwd_launches]
    check(serve == [12, 0], f"full serving forward: 12 + 0 epilogue "
          f"launches, got {serve}")
    out = {"train_large_step": {"forward": train[0], "backward": train[1]},
           "serve_full_forward": {"forward": serve[0],
                                  "backward": serve[1]}}
    print("epilogue launches: " + json.dumps(out), flush=True)
    return out


def phase_epilogue() -> dict:
    """The epilogue kernels against the plain version at EPILOGUE_SHAPES,
    timed, and their launches on the train and serving paths."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fwd, bwd = [], []
    for name, b, c in EPILOGUE_SHAPES:
        x, bias, dy = epilogue_inputs(gen, b, c)
        shape = f"{name} B={b} C={c} bfloat16"
        y = cuda_epilogue.bias_relu_cuda(x, bias, True)
        dx, db = cuda_epilogue.bias_relu_backward_cuda(dy, y)
        _, db_again = cuda_epilogue.bias_relu_backward_cuda(dy, y)
        xg, bg = x.detach().requires_grad_(), bias.detach().requires_grad_()
        want = plain_epilogue.bias_relu(xg, bg, True)
        dx_want, db_want = torch.autograd.grad(want, (xg, bg), dy,
                                               retain_graph=True)
        torch.cuda.synchronize()
        check(torch.equal(y, want.detach()), f"epilogue forward != plain "
              f"at {shape}")
        check(torch.equal(dx, dx_want), f"epilogue dX != plain at {shape}")
        check(bias_grad_close(db, db_want), f"epilogue bias gradient not "
              f"within a bf16 spacing of plain at {shape}")
        check(torch.equal(db, db_again), f"epilogue bias gradient differs "
              f"run to run at {shape}")
        act = b * 361 * c * 2
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        slabs = cuda_epilogue.plan(b, c, 2, sms)[2]
        fwd.append(epilogue_row(
            "epilogue forward", lambda: cuda_epilogue.bias_relu_cuda(
                x, bias, True),
            lambda: plain_epilogue.bias_relu(x, bias, True), 2 * act, shape))
        bwd.append(epilogue_row(
            "epilogue backward",
            lambda: cuda_epilogue.bias_relu_backward_cuda(dy, y),
            lambda: torch.autograd.grad(want, (xg, bg), dy,
                                        retain_graph=True),
            3 * act + 2 * slabs * 361 * c * 4, shape) | {"slabs": slabs})
        del x, bias, dy, y, dx, db, db_again, xg, bg, want, dx_want, db_want
    return {"forward": fwd, "backward": bwd, "launches": epilogue_launches()}


def bn_epilogue_inputs(gen: torch.Generator, b: int, c: int):
    """bf16 x (channels with means and scales of their own, exact zeros
    and negative zeros), a skip and a gradient dy, channels-last (b, c, 19,
    19); a train-mode BatchNorm with its state drawn away from 1, 0, 0, 1."""
    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = draw(b, 19, 19, c) * (0.5 + draw(c).abs()) + draw(c)
    x.view(-1)[::7] = 0.0
    x.view(-1)[3::11] = -0.0
    bn = resnet.BatchNorm(c, 1e-5, 0.1).cuda()
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.1 * draw(c))
        bn.bias.copy_(0.1 * draw(c))
        bn.running_mean.copy_(0.1 * draw(c))
        bn.running_var.copy_(1.0 + 0.1 * draw(c).abs())
    return (*(t.bfloat16().permute(0, 3, 1, 2)
              for t in (x, draw(b, 19, 19, c), draw(b, 19, 19, c))), bn)


def bf16_spacing(v: torch.Tensor) -> torch.Tensor:
    return torch.ldexp(torch.ones_like(v), torch.frexp(v.abs())[1] - 8)


def bf16_close(got: torch.Tensor, want: torch.Tensor,
               pre: torch.Tensor | None = None,
               scale: torch.Tensor | None = None) -> bool:
    """Within one bf16 spacing at the larger of |got|, |want| and 1e-5 of
    the largest |want|; for BN's output, plus one at BN's value ``pre`` and
    2^-19 of its terms' size ``scale`` (tests/test_torch_bn_epilogue.py's
    _y_tolerance)."""
    got, want = got.float(), want.float()
    big = torch.maximum(torch.maximum(got.abs(), want.abs()),
                        1e-5 * want.abs().max())
    tol = bf16_spacing(big)
    if pre is not None:
        tol = tol + bf16_spacing(pre.float()) + scale * 2.0 ** -19
    return bool(((got - want).abs() <= tol).all())


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def bn_epilogue_launches() -> dict:
    """The BN epilogue's calls in one ``agz40`` train step at
    BN_LAUNCH_ROWS rows: 2 * blocks + 1 each way."""
    gen = np.random.default_rng(SEED + 3)
    cfg = resnet.CONFIGS["agz40"]
    model = resnet.init(torch.Generator().manual_seed(SEED), cfg)
    optimizer = sgd(0.01, momentum=0.9)
    step = make_train_step(cfg, optimizer)
    b = BN_LAUNCH_ROWS
    packed, player, rank = random_records(gen, b)
    batch = {"packed": packed, "player": player, "rank": rank,
             "target": gen.integers(0, 361, b).astype(np.int32),
             "z": gen.choice([-1.0, 1.0], b).astype(np.float32)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    state = optimizer.init(model)
    step(model, state, batch)
    torch.cuda.synchronize()
    cuda_bn_epilogue.reset_launches()
    step(model, state, batch)
    torch.cuda.synchronize()
    train = [cuda_bn_epilogue.launches, cuda_bn_epilogue.bwd_launches]
    want = 2 * cfg.blocks + 1
    check(train == [want, want], f"agz40 train step: {want} + {want} BN "
          f"epilogue launches, got {train}")
    out = {"train_agz40_step": {"forward": train[0], "backward": train[1]}}
    print("BN epilogue launches: " + json.dumps(out), flush=True)
    return out


def phase_bn_epilogue() -> dict:
    """The BN epilogue kernels against the plain version at
    BN_EPILOGUE_SHAPE, without the skip and with it, timed each way beside
    their bytes bound and the plain version's time, and their launches on
    the agz40 train path."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    name, b, c = BN_EPILOGUE_SHAPE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    act = b * 361 * c * 2
    fwd, bwd = [], []
    for with_skip in (False, True):
        x, skip, dy, bn = bn_epilogue_inputs(gen, b, c)
        skip = skip if with_skip else None
        shape = (f"{name} B={b} C={c} bfloat16 "
                 f"{'with' if with_skip else 'without'} skip")
        bn_plain = copy.deepcopy(bn)
        y, saved = cuda_bn_epilogue.bn_relu_cuda(x, bn, skip)
        kept = None if skip is None else y
        got = cuda_bn_epilogue.bn_relu_backward_cuda(dy, x, saved, bn.weight,
                                                     bn.bias, kept)
        again = cuda_bn_epilogue.bn_relu_backward_cuda(
            dy, x, saved, bn.weight, bn.bias, kept)
        xg = x.detach().requires_grad_()
        sg = None if skip is None else skip.detach().requires_grad_()
        pre, mean, invstd = (t.detach() for t in
                             torch.ops.aten.native_batch_norm(
                                 x, bn.weight, bn.bias,
                                 bn_plain.running_mean.clone(),
                                 bn_plain.running_var.clone(), True,
                                 bn.momentum, bn.eps))
        m = mean.view(1, -1, 1, 1)
        scale = (((x.float() - m).abs() + m.abs())
                 * (bn.weight * invstd).detach().abs().view(1, -1, 1, 1)
                 + bn.bias.detach().abs().view(1, -1, 1, 1))
        want = plain_bn_epilogue.bn_relu(xg, bn_plain, sg)
        leaves = [xg, bn_plain.weight, bn_plain.bias]
        leaves += [] if sg is None else [sg]
        grads_want = torch.autograd.grad(want, leaves, dy, retain_graph=True)
        torch.cuda.synchronize()
        flip = (y > 0) != (want > 0)
        keep = ~flip.any(dim=(0, 2, 3))
        check(int(flip.sum()) <= flip.numel() // 10**6 + 1,
              f"BN epilogue ReLU masks differ at {int(flip.sum())} points "
              f"at {shape}")
        check(bf16_close(y, want.detach(), pre, scale), f"BN epilogue "
              f"forward not within a bf16 spacing of plain at {shape}")
        check(bf16_close(got[0][~flip], grads_want[0][~flip]),
              f"BN epilogue dX not within a bf16 spacing of plain at {shape}")
        for i, what in ((1, "scale"), (2, "shift")):
            check(rel_gap(got[i][keep], grads_want[i][keep]) <= 1e-5,
                  f"BN epilogue {what} gradient off plain at {shape}")
        if skip is not None:
            check(bool((got[3] == grads_want[3])[~flip].all()),
                  f"BN epilogue skip gradient != plain at {shape}")
        for a, w in ((bn.running_mean, bn_plain.running_mean),
                     (bn.running_var, bn_plain.running_var)):
            check(rel_gap(a, w) <= 1e-5, f"BN epilogue running statistics "
                  f"off plain at {shape}")
        check(all(torch.equal(a, a2) for a, a2 in zip(got[:3], again[:3])),
              f"BN epilogue backward differs run to run at {shape}")
        y_err = float((y.float() - want.float()).abs().max())
        dx_err = float((got[0].float() - grads_want[0].float())[~flip]
                       .abs().max())
        points, slabs = cuda_bn_epilogue.plan(b, c, 2, sms)[1::2]
        parts = math.ceil(361 / points) * slabs
        reads = 1 if skip is None else 2
        with torch.no_grad():
            fwd.append(epilogue_row(
                "BN epilogue forward",
                lambda: cuda_bn_epilogue.bn_relu_cuda(x, bn, skip),
                lambda: plain_bn_epilogue.bn_relu(x, bn_plain, skip),
                (reads + 1) * act, shape) | {
                    "exact": False, "max_abs_err": y_err,
                    "passes": reads + 2, "least_passes": reads + 1,
                    "partial_bytes": 2 * parts * c * 4})
        bwd.append(epilogue_row(
            "BN epilogue backward",
            lambda: cuda_bn_epilogue.bn_relu_backward_cuda(
                dy, x, saved, bn.weight, bn.bias, kept),
            lambda: torch.autograd.grad(want, leaves, dy, retain_graph=True),
            (3 if skip is None else 5) * act, shape) | {
                "exact": False, "max_abs_err": dx_err,
                "passes": 5 if skip is None else 7,
                "least_passes": 3 if skip is None else 5,
                "partial_bytes": 2 * parts * c * 4})
        del x, skip, dy, bn, bn_plain, y, saved, got, again, xg, sg, want
        del grads_want, pre, mean, invstd, m, scale, flip, keep
    return {"forward": fwd, "backward": bwd,
            "launches": bn_epilogue_launches()}


def run_bursts(engine, packed, player, rank, tiers=None, on_submit=None):
    """Each burst's requests submitted together from THREADS threads; the
    next burst starts when every future of this one resolved. ``tiers``
    gives each request its fleet tier; ``on_submit(i, future, t_call)``
    runs right after request i is submitted, ``t_call`` the perf_counter
    time the submit call began."""
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
                    kw = {} if tiers is None else {"tier": tiers[i]}
                    t_call = time.perf_counter()
                    futures[i] = engine.submit(packed[i], player[i], rank[i],
                                               **kw)
                    if on_submit is not None:
                        on_submit(i, futures[i], t_call)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=submit,
                                    args=(idx[k::THREADS],),
                                    name=f"chip-smoke-submit-{k}")
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
    if "bias_relu" in lower or "bias_grad" in lower:
        return "epilogue kernels"
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


def set_deterministic() -> None:
    """Deterministic algorithms, set before CUDA starts: cuDNN's weight
    gradients otherwise accumulate with atomics in varying order."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    deterministic(True)
    torch.backends.cudnn.benchmark = False


def deterministic(on: bool) -> None:
    """Deterministic algorithms on or off (after ``set_deterministic``)."""
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on


def deterministic_main(root: str) -> int:
    """The child process of phase 7: deterministic mode, set before CUDA
    starts. A resumed run equals an uninterrupted one bitwise; the loader's
    side-stream prefetch gives the losses of the inline copy; and the step
    times under determinism. Prints one ``deterministic:`` JSON line."""
    set_deterministic()
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


def fleet_boards(gen, n=sum(BURSTS)):
    """``n`` serving boards in which every fourth request from the fourth
    on repeats an earlier board or shows one of its other dihedral views
    (same player and rank), and the tiers rotate interactive, selfplay,
    batch."""
    packed, player, rank = serving_boards(gen, n)
    for i in range(4, n, 4):
        j = int(gen.integers(0, i))
        packed[i] = digest.dihedral_views(packed[j])[int(gen.integers(0, 8))]
        player[i], rank[i] = player[j], rank[j]
    return (packed, player, rank), [FLEET_TIERS[i % 3] for i in range(n)]


def check_fleet_rows(forward, model, ladder, boards, futures, tol,
                     position_cache=None) -> dict:
    """Fleet rows finite and normalised; every row a replica dispatched
    bitwise equal to ``forward`` at its rung; every row within ``tol`` of
    the top rung; with ``position_cache`` (exact keying: a leader
    dispatches its own board, and the map back from the stored row is the
    identity), every cache-served row (hit or follower) bitwise equal to
    its leader's row."""
    n = len(boards[0])
    rows = np.stack([f.result() for f in futures])
    check(rows.shape == (n, 361) and rows.dtype == np.float32, "row shape")
    check(bool(np.isfinite(rows).all()), "finite rows")
    lse = np.log(np.exp(rows.astype(np.float64)).sum(axis=1))
    check(float(np.abs(lse).max()) <= 1e-3, "rows normalised")
    buckets = np.array([-1 if f.bucket is None else f.bucket
                        for f in futures])
    for bucket in ladder.buckets:
        idx = np.flatnonzero(buckets == bucket)
        if len(idx):
            check(np.array_equal(rows[idx], direct(forward, model, ladder,
                                                   boards, idx, bucket)),
                  f"fleet rows at rung {bucket} != direct forward bitwise")
    roles = {}
    if position_cache is not None:
        check(position_cache.config.keying == "exact", "exact keying")
        keys = [position_cache.prepare(*(a[i] for a in boards))[0]
                for i in range(n)]
        leaders = {}
        for i, f in enumerate(futures):
            role = getattr(f, "cache", "bypass")
            roles[role] = roles.get(role, 0) + 1
            if role == "leader":
                leaders[keys[i]] = rows[i]
        for i, f in enumerate(futures):
            if getattr(f, "cache", None) in ("hit", "follower"):
                check(np.array_equal(rows[i], leaders[keys[i]]),
                      f"cache-served row {i} != its leader's row")
        check(roles.get("hit", 0) + roles.get("follower", 0) >= 1,
              "the cache served at least one repeat")
    top = direct(forward, model, ladder, boards, np.arange(n),
                 ladder.max_bucket)
    mask = np.exp(top) >= 1e-3
    cross = float(np.abs(rows - top)[mask].max())
    check(cross <= tol, f"fleet rows across rungs: {cross} > {tol}")
    return {"cross_rung": cross, "roles": roles,
            "dispatched": int((buckets >= 0).sum())}


class Stamps:
    """Per request: its tier, the host time of its submit call, the time
    from the call to its resolution (perf_counter), and the wall time it
    resolved at."""

    def __init__(self, tiers):
        self.tiers = tiers
        self.t0, self.t1, self.wall, self.call = {}, {}, {}, {}

    def on_submit(self, i, future, t_call):
        self.t0[i] = t_call
        self.call[i] = time.perf_counter() - t_call

        def done(f, i=i):
            self.t1[i] = time.perf_counter()
            self.wall[i] = time.time()

        future.add_done_callback(done)

    def per_tier(self) -> dict:
        out = {}
        for tier in FLEET_TIERS:
            ms = [(self.t1[i] - self.t0[i]) * 1e3 for i in self.t1
                  if self.tiers[i] == tier]
            out[tier] = {"requests": len(ms),
                         "p50_ms": float(np.percentile(ms, 50)),
                         "p99_ms": float(np.percentile(ms, 99))}
        calls = np.array(list(self.call.values())) * 1e3
        out["submit_call"] = {"p50_ms": float(np.percentile(calls, 50)),
                              "p99_ms": float(np.percentile(calls, 99))}
        return out


def fleet_dispatches(stats) -> dict:
    """Dispatches per rung summed over a fleet's replicas."""
    out = {}
    for rep in stats["replicas"]:
        for bucket, hits in rep.get("bucket_hits", {}).items():
            out[bucket] = out.get(bucket, 0) + hits
    return dict(sorted(out.items(), key=lambda kv: int(kv[0])))


def replica_forwards(stats) -> list:
    return [rep["forwards"] for rep in stats["replicas"]]


def serve_fleet(fleet, boards, tiers, stamps=None):
    """Warm every replica, serve the bursts, close the fleet; returns the
    futures, the launch counts (reset just before the warm-up) and the
    fleet's stats."""
    try:
        cuda_expand.reset_launches()
        fleet.warmup()
        futures = run_bursts(fleet, *boards, tiers=tiers,
                             on_submit=stamps.on_submit if stamps else None)
    finally:
        fleet.close()
    return futures, (cuda_expand.launches, cuda_expand.sym_launches), \
        fleet.stats()


def phase_fleet_cache(model, cfg, boards, tiers, tmp) -> dict:
    """8a: two replicas behind the router with the position cache."""
    fleet = fleet_policy_engine(
        model, cfg, replicas=2, config=EngineConfig(max_wait_ms=50.0),
        supervisor=SupervisorConfig(quarantine_dir=tmp),
        cache=CacheConfig(), device=DEVICE)
    stamps = Stamps(tiers)
    t0 = time.perf_counter()
    futures, (launches, sym), stats = serve_fleet(fleet, boards, tiers,
                                                  stamps)
    t_serve = time.perf_counter() - t0
    forwards = replica_forwards(stats)
    print(f"fleet with cache: {len(futures)} requests in {t_serve:.2f} s "
          f"(warm-up included); expansion kernel {launches} launches for "
          f"replica forwards {forwards}, sym kernel {sym}", flush=True)
    check(launches == sum(forwards) and min(forwards) > 0 and sym == 0,
          f"fleet: expansion launches {launches} != replica forwards "
          f"{forwards}, or sym launches {sym}")
    rows = check_fleet_rows(make_log_prob_fn(cfg, device=DEVICE), model,
                            fleet.ladder, boards, futures, CROSS_RUNG_TOL,
                            fleet.cache)
    cstats = stats["fleet"]["cache"]
    lookups = cstats["hits"] + cstats["misses"] + cstats["coalesced"]
    out = {"launches": launches, "replica_forwards": forwards,
           "serve_s": t_serve, "tiers": stamps.per_tier(),
           "fleet_tiers": stats["fleet"]["tiers"],
           "cache": cstats, "cache_hit_rate": (cstats["hits"]
                                               + cstats["coalesced"])
           / lookups, "dispatches_per_rung": fleet_dispatches(stats),
           "replica_engines": [{k: r[k] for k in ("dispatches", "p50_ms",
                                                  "p99_ms", "occupancy")}
                               for r in stats["replicas"]], **rows}
    print("fleet with cache: " + json.dumps(
        {k: out[k] for k in ("tiers", "cache_hit_rate", "roles",
                             "dispatches_per_rung", "replica_engines",
                             "cross_rung")}), flush=True)
    return out


def phase_fleet_restart(model, cfg, boards, tiers, tmp) -> dict:
    """8b: replica 0's dispatcher killed once mid-burst."""
    rec = configure_flight(os.path.join(tmp, "flight"))
    faults.install(f"serving_dispatch.restart-0:fail@{RESTART_AT}")
    fleet = fleet_policy_engine(
        model, cfg, replicas=2, config=EngineConfig(max_wait_ms=50.0),
        supervisor=SupervisorConfig(quarantine_dir=tmp),
        cache=CacheConfig(), device=DEVICE, name="restart")
    stamps = Stamps(tiers)
    try:
        futures, (launches, _), stats = serve_fleet(fleet, boards, tiers,
                                                    stamps)
    finally:
        faults.reset()
        rec.close()
    check(all(f.done() and f.exception() is None for f in futures),
          "every request answered after the dispatcher died")
    restarts = [r["supervisor"]["restarts"] for r in stats["replicas"]]
    replayed = [r["supervisor"]["replayed"] for r in stats["replicas"]]
    check(restarts[0] >= 1, f"replica 0 restarted (restarts {restarts})")
    dumps = []
    for p in rec.dumps:
        with open(p) as f:
            dumps.append(json.load(f))
    deaths = [d["time"] for d in dumps if d["reason"] == "serving_restart"]
    check(len(deaths) == restarts[0], "one flight dump per restart")
    t_death = deaths[0]
    after = [stamps.wall[i] for i, fut in enumerate(futures)
             if getattr(fut, "replica", None) == 0
             and stamps.wall[i] >= t_death]
    check(bool(after), "replica 0 answered after its restart")
    first_ms = (min(after) - t_death) * 1e3
    rows = check_fleet_rows(make_log_prob_fn(cfg, device=DEVICE), model,
                            fleet.ladder, boards, futures, CROSS_RUNG_TOL,
                            fleet.cache)
    check(launches >= sum(replica_forwards(stats)) > 0,
          "expansion launches cover the live replicas' forwards")
    out = {"launches": launches, "restarts": restarts, "replayed": replayed,
           "restart_to_first_answer_ms": first_ms,
           "tiers": stamps.per_tier(), **rows}
    print("fleet restart: " + json.dumps(
        {k: out[k] for k in ("restarts", "replayed",
                             "restart_to_first_answer_ms", "launches",
                             "cross_rung")}), flush=True)
    return out


def phase_fleet_reload(model, cfg, tmp) -> dict:
    """8c: reload under traffic, to seed-1 weights as a module, back to
    seed 0, then to seed 1 from a checkpoint the port wrote."""
    model1 = policy_cnn.init(torch.Generator().manual_seed(SEED + 1), cfg,
                             device=DEVICE)
    path = os.path.join(tmp, "seed1.npz")
    ckpt.save_checkpoint(path, convert.params_to_jax(model1), {},
                         {"config": {"num_layers": cfg.num_layers,
                                     "channels": cfg.channels}})
    boards = serving_boards(np.random.default_rng(SEED + 81), RELOAD_BOARDS)
    forward = make_log_prob_fn(cfg, device=DEVICE)
    fleet = fleet_policy_engine(model, cfg, replicas=2,
                                config=EngineConfig(max_wait_ms=5.0),
                                device=DEVICE, name="reload")
    stop, traffic, errors = threading.Event(), [], []

    def background():
        try:
            k = 0
            while not stop.is_set():
                i = k % RELOAD_BOARDS
                traffic.append(fleet.submit(*(a[i] for a in boards))
                               .result(timeout=60))
                k += 1
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    def served() -> tuple:
        futures = [fleet.submit(*(a[i] for a in boards))
                   for i in range(RELOAD_BOARDS)]
        return (np.stack([f.result(timeout=60) for f in futures]),
                np.array([f.bucket for f in futures]))

    seconds, after = [], []
    try:
        cuda_expand.reset_launches()
        fleet.warmup()
        worker = threading.Thread(target=background,
                                  name="chip-smoke-reload-traffic")
        worker.start()
        for weights, source in ((model1, model1), (model, model),
                                (model1, path)):
            seconds.append(fleet.reload(source)["seconds"])
            after.append((weights, *served()))
        stop.set()
        worker.join(timeout=120)
        check(not worker.is_alive() and not errors,
              f"traffic during the reloads: {errors}")
    finally:
        stop.set()
        fleet.close()
    launches = cuda_expand.launches
    stats = fleet.stats()
    check(launches == sum(replica_forwards(stats)) > 0,
          "reload: expansion launches == replica forwards")
    # the direct forwards compared with run after the count was read
    for weights, rows, buckets in after:
        for bucket in fleet.ladder.buckets:
            idx = np.flatnonzero(buckets == bucket)
            if len(idx):
                check(np.array_equal(rows[idx], direct(
                    forward, weights, fleet.ladder, boards, idx, bucket)),
                    f"rows after reload at rung {bucket} != the new "
                    "weights' direct forward")
    got = np.stack(traffic)
    check(len(traffic) > 0 and bool(np.isfinite(got).all()),
          "traffic rows during the reloads finite")
    out = {"launches": launches, "reload_s": seconds,
           "traffic_requests": len(traffic)}
    print("fleet reload: " + json.dumps(out), flush=True)
    return out


def phase_fleet_variants(grid, cfg, boards) -> dict:
    """8d: an f32 replica and an int8+sym replica behind one router."""
    t0 = time.perf_counter()
    fleet = fleet_policy_engine(grid, cfg, replicas=2,
                                config=EngineConfig(max_wait_ms=50.0),
                                device=DEVICE, name="mixed",
                                variants=("f32", "int8+sym"))
    t_gate = time.perf_counter() - t0
    check([r.engine.variant for r in fleet._replicas]
          == ["f32", "int8+sym"], "replica variants")
    futures, (launches, sym), stats = serve_fleet(
        fleet, boards, [FLEET_TIERS[0]] * len(boards[0]))
    forwards = replica_forwards(stats)
    print(f"mixed fleet (gate and build {t_gate:.2f} s): replica forwards "
          f"{forwards}, expansion launches {launches}, sym launches {sym}",
          flush=True)
    check(launches == forwards[0] and sym == forwards[1]
          and min(forwards) > len(fleet.ladder.buckets),
          "mixed fleet: the f32 replica's forwards == expansion launches, "
          "the int8+sym replica's == sym launches, both served traffic")
    spec = variant_spec(cfg, "int8+sym", device=DEVICE)
    qgrid = spec.prepare(grid)
    per = {0: (make_log_prob_fn(cfg, device=DEVICE), grid),
           1: (spec.forward, qgrid)}
    cross = {}
    for rep, (fwd, params) in per.items():
        idx = [i for i, f in enumerate(futures) if f.replica == rep]
        sub = tuple(a[idx] for a in boards)
        cross[rep] = check_fleet_rows(fwd, params, fleet.ladder, sub,
                                      [futures[i] for i in idx],
                                      GRID_NET_CROSS_RUNG_TOL)["cross_rung"]
    return {"expand_launches": launches, "sym_launches": sym,
            "replica_forwards": forwards, "gate_and_build_s": t_gate,
            "cross_rung": cross}


def phase_fleet_surge(model, cfg) -> dict:
    """8e: a card replica and a CPU surge replica behind one router. The
    ejected card replica is not respawned (max_respawns=0), so the
    failover is observed without racing its rebuild."""
    fleet = fleet_policy_engine(
        model, cfg, replicas=2, platforms=("cuda", "cpu"),
        config=EngineConfig(buckets=SURGE_LADDER, max_wait_ms=5.0),
        fleet=FleetConfig(max_respawns=0), name="surge")
    gen = np.random.default_rng(SEED + 85)
    groups = {k: serving_boards(gen, n) for k, n in SURGE_BOARDS.items()}

    def serve(name, tier):
        futures = [fleet.submit(*(a[i] for a in groups[name]), tier=tier)
                   for i in range(SURGE_BOARDS[name])]
        return np.stack([f.result(timeout=120) for f in futures]), \
            [f.replica for f in futures], [f.bucket for f in futures]

    try:
        check([r.engine.platform for r in fleet._replicas]
              == ["cuda", "cpu"], "surge fleet platforms")
        cuda_expand.reset_launches()
        fleet.warmup()
        batch, batch_on, batch_at = serve("batch", "batch")
        after_batch = cuda_expand.launches
        warm = replica_forwards(fleet.stats())
        inter, inter_on, _ = serve("interactive", "interactive")
        after_inter = cuda_expand.launches
        forwards = replica_forwards(fleet.stats())
        check(fleet.eject_replica(0, reason="chip_smoke"),
              "the card replica ejected")
        fail, fail_on, _ = serve("failover", "interactive")
        deadline = time.monotonic() + 30
        while (fleet.health()["replicas"][0]["state"] != "failed"
               and time.monotonic() < deadline):
            time.sleep(0.01)
        health = fleet.health()
        cpu_engine = {k: fleet.stats()["replicas"][1][k]
                      for k in ("dispatches", "bucket_hits", "p50_ms",
                                "p99_ms")}
    finally:
        fleet.close()
    print(f"surge fleet: batch tier on replicas {sorted(set(batch_on))}, "
          f"interactive on {sorted(set(inter_on))}, after ejecting the card "
          f"replica on {sorted(set(fail_on))}; expansion launches "
          f"{after_batch} after the batch tier (card replica forwards "
          f"{warm[0]}), {after_inter} after the interactive tier (card "
          f"replica forwards {forwards[0]})", flush=True)
    check(set(batch_on) == {1} and after_batch == warm[0],
          "batch-tier boards land on the CPU replica and add no launch")
    check(set(inter_on) == {0} and after_inter == forwards[0] > warm[0]
          and bool(np.isfinite(inter).all()),
          "interactive boards land on the card replica, one launch each "
          "forward")
    check(set(fail_on) == {1} and bool(np.isfinite(fail).all())
          and health["replicas"][0]["state"] == "failed"
          and health["state"] == "degraded",
          "interactive traffic fails over to the CPU replica")
    # the CPU replica's rows: bitwise its own forward at the rung, and
    # within CROSS_RUNG_TOL of the card's
    cpu_fwd = make_log_prob_fn(cfg, device="cpu")
    cpu_model = cpu_copy(model)
    ladder = BucketLadder(SURGE_LADDER)
    b = groups["batch"]
    for bucket in ladder.buckets:
        idx = np.flatnonzero(np.array(batch_at) == bucket)
        if len(idx):
            check(np.array_equal(batch[idx], direct(cpu_fwd, cpu_model,
                                                    ladder, b, idx, bucket)),
                  f"CPU replica rows at rung {bucket} != CPU forward")
    card = direct(make_log_prob_fn(cfg, device=DEVICE), model, ladder, b,
                  np.arange(len(b[0])), ladder.max_bucket)
    err = float(np.abs(batch - card)[np.exp(card) >= 1e-3].max())
    print(f"surge fleet: CPU replica rows vs the card's, max-abs over p >= "
          f"1e-3: {err:.3g} (tolerance {CROSS_RUNG_TOL})", flush=True)
    check(err <= CROSS_RUNG_TOL, "CPU rows vs the card's")
    print("surge fleet: CPU replica engine " + json.dumps(cpu_engine),
          flush=True)
    return {"launches": after_inter, "card_forwards": forwards[0],
            "cpu_vs_card_max_abs": err, "cpu_engine": cpu_engine,
            "replicas": {"batch": sorted(set(batch_on)),
                         "interactive": sorted(set(inter_on)),
                         "failover": sorted(set(fail_on))}}


def phase_value_fleet() -> dict:
    """8f: the value net (ValueConfig defaults, 3 x 64 bf16) behind two
    replicas; then its float32 forward on the card against the CPU."""
    vcfg = value_cnn.ValueConfig()
    check((vcfg.num_layers, vcfg.channels, vcfg.compute_dtype)
          == (3, 64, "bfloat16"), "value config defaults")
    vmodel = value_cnn.init(torch.Generator().manual_seed(SEED), vcfg,
                            device=DEVICE)
    boards = serving_boards(np.random.default_rng(SEED + 86))
    fleet = fleet_value_engine(vmodel, vcfg, replicas=2,
                               config=EngineConfig(max_wait_ms=50.0),
                               device=DEVICE)
    futures, (launches, sym), stats = serve_fleet(
        fleet, boards, [FLEET_TIERS[0]] * len(boards[0]))
    forwards = replica_forwards(stats)
    check(launches == sum(forwards) and min(forwards) > 0 and sym == 0,
          f"value fleet: expansion launches {launches} != replica forwards "
          f"{forwards}, or sym {sym}")
    rows = np.array([f.result() for f in futures])
    check(rows.shape == (len(futures),) and rows.dtype == np.float32
          and bool(((rows > 0) & (rows < 1)).all()), "win-probs in (0, 1)")
    forward = make_value_fn(vcfg, device=DEVICE)
    ladder = fleet.ladder
    buckets = np.array([f.bucket for f in futures])
    for bucket in ladder.buckets:
        idx = np.flatnonzero(buckets == bucket)
        if len(idx):
            check(np.array_equal(rows[idx], direct(forward, vmodel, ladder,
                                                   boards, idx, bucket)),
                  f"value rows at rung {bucket} != direct forward bitwise")
    top = direct(forward, vmodel, ladder, boards, np.arange(len(rows)),
                 ladder.max_bucket)
    cross = float(np.abs(rows - top).max())
    err = phase_card_vs_cpu("value forward", make_value_fn, vmodel,
                            tuple(a[:CARD_VS_CPU_BOARDS] for a in boards))
    print(f"value fleet: expansion kernel {launches} launches for replica "
          f"forwards {forwards}; win-prob max-abs vs the top rung "
          f"{cross:.3g}", flush=True)
    return {"launches": launches, "replica_forwards": forwards,
            "cross_rung_max_abs": cross, "card_vs_cpu_f32_max_abs": err,
            "dispatches_per_rung": fleet_dispatches(stats)}


def phase_fleet_path(model, grid) -> dict:
    """Phase 8: the serving stack behind the engine, on the card."""
    cfg = policy_cnn.CONFIGS["full"]
    t0 = time.perf_counter()
    boards, tiers = fleet_boards(np.random.default_rng(SEED + 8))
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fleet-") as tmp:
        out = {"cache": phase_fleet_cache(model, cfg, boards, tiers, tmp),
               "restart": phase_fleet_restart(model, cfg, boards, tiers,
                                              tmp),
               "reload": phase_fleet_reload(model, cfg, tmp)}
    out["variants"] = phase_fleet_variants(grid, cfg, boards)
    out["surge"] = phase_fleet_surge(model, cfg)
    out["value"] = phase_value_fleet()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 8: {out['seconds']:.2f} s", flush=True)
    return out


def replay_rules(game) -> np.ndarray:
    """A game's moves through the port's Python rules (``go.play`` raises
    on an occupied point); returns the final stones."""
    stones, age = new_board()
    for m in game.moves:
        play(stones, age, m.x, m.y, m.player)
    return stones


def check_games_legal(games, label) -> None:
    for i, g in enumerate(games):
        check(np.array_equal(replay_rules(g), g.stones),
              f"{label}: game {i} replays through the Python rules to "
              "another board")


def checked_moves(agent, illegal: list):
    """Record every move ``agent`` picks outside the legal mask it got."""
    select = agent.select_moves

    def select_moves(packed, players, legal, rng):
        moves = select(packed, players, legal, rng)
        illegal.extend((agent.name, int(m)) for i, m in enumerate(moves)
                       if m >= 0 and not legal[i][m])
        return moves

    agent.select_moves = select_moves
    return agent


def fleet_hit_rate(fstats) -> float:
    c = fstats["fleet"]["cache"]
    lookups = c["hits"] + c["misses"] + c["coalesced"]
    return (c["hits"] + c["coalesced"]) / lookups if lookups else 0.0


def no_request_lost(fstats) -> bool:
    """No shed and no failed or timed-out dispatch on any replica."""
    return (sum(fstats["fleet"]["shed"].values()) == 0
            and all(r["dispatch_failures"] == 0 and r["timeouts"] == 0
                    for r in fstats["replicas"]))


def host_profile(fn) -> dict:
    """cProfile of one call of ``fn``: wall seconds and the PROFILE_TOP
    functions by own time. On Python 3.12 cProfile rides
    ``sys.monitoring`` and sees every thread, so the engines' dispatcher
    threads count beside the game loop (a lock's ``acquire`` is time a
    thread waited)."""
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    try:
        fn()
    finally:
        prof.disable()
    wall = time.perf_counter() - t0
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: kv[1][2], reverse=True)[:PROFILE_TOP]
    return {"wall_s": wall, "top": [
        {"function": f"{os.path.basename(path)}:{line}({name})",
         "calls": calls, "own_s": own, "cum_s": cum}
        for (path, line, name), (_, calls, own, cum, _) in rows]}


def phase_selfplay(model, cfg, tmp) -> dict:
    """9a: selfplay through a private engine on the ladder trimmed to the
    game count; every game legal and transcribed by the port."""
    check(native.batch_available(), "the native rules engine built")
    cuda_expand.reset_launches()
    games, stats = selfplay.self_play(
        model, cfg, n_games=SELFPLAY_GAMES, max_moves=SELFPLAY_MOVES,
        temperature=SELFPLAY_TEMPERATURE, seed=SEED, device=DEVICE)
    launches, sym = cuda_expand.launches, cuda_expand.sym_launches
    eng = stats["engine"]
    check(launches == eng["forwards"] > 0 and sym == 0,
          f"selfplay: expansion launches {launches} != engine forwards "
          f"{eng['forwards']}, or sym launches {sym}")
    check(eng["dispatch_failures"] == 0 and eng["timeouts"] == 0,
          "selfplay: every request answered")
    check_games_legal(games, "selfplay")
    positions = 0
    for i, g in enumerate(games):
        path = os.path.join(tmp, f"game_{i:04d}.sgf")
        # lint: allow[atomic-write] scratch SGF in the phase's temporary directory, read back at once
        with open(path, "w") as f:
            f.write(selfplay.to_sgf(g))
        got = transcribe_game(path)
        if not g.moves:
            check(got is None, f"selfplay: game {i} has no moves")
            continue
        packed, meta = got
        check(len(packed) == len(g.moves) and [tuple(r[:3]) for r in meta]
              == [(m.player, m.x, m.y) for m in g.moves],
              f"selfplay: game {i}'s transcription lists its moves")
        if i < PYTHON_REPLAY_GAMES:
            want = np.stack([p for p, _ in
                             replay_positions(sgf.parse_file(path))])
            check(np.array_equal(packed, want), f"selfplay: game {i}'s "
                  "records != the packed positions of go.replay")
        positions += len(packed)
    profile = host_profile(lambda: selfplay.self_play(
        model, cfg, n_games=SELFPLAY_GAMES, max_moves=PROFILE_MOVES,
        temperature=SELFPLAY_TEMPERATURE, seed=SEED + 2, device=DEVICE))
    print("selfplay host profile: " + json.dumps(profile), flush=True)
    out = {"launches": launches, "forwards": eng["forwards"],
           "positions": stats["positions"],
           "positions_per_sec": stats["positions_per_sec"],
           "seconds": stats["seconds"], "mean_moves": stats["mean_moves"],
           "transcribed_records": positions,
           "dispatches_per_rung": eng["bucket_hits"],
           "engine_p50_ms": eng["p50_ms"], "engine_p99_ms": eng["p99_ms"]}
    print("selfplay: " + json.dumps(out), flush=True)
    out["host_profile"] = profile
    return out


def phase_direct_match(model, grid, cfg) -> dict:
    """9b: two policy agents with no engine, at temperature 0, twice: the
    same SGFs, since every ply's batch pads onto the same rung."""
    forwards = [0]

    def counted(agent):
        predict = agent._predict

        def forward(*args):
            forwards[0] += 1
            return predict(*args)

        agent._predict = forward
        return agent

    def run():
        a = counted(agents.PolicyAgent(model, cfg, name="full",
                                       device=DEVICE))
        b = counted(agents.PolicyAgent(grid, cfg, name="grid",
                                       device=DEVICE))
        games, _, stats = match.play_match(
            a, b, n_games=MATCH_GAMES, max_moves=MATCH_MOVES, seed=SEED,
            opening_plies=MATCH_OPENING)
        return [selfplay.to_sgf(g) for g in games], stats

    cuda_expand.reset_launches()
    first, stats = run()
    second, _ = run()
    launches = cuda_expand.launches
    check(first == second, "the direct-path match repeats bitwise")
    check(launches == forwards[0] > 0, f"direct match: expansion launches "
          f"{launches} != forwards {forwards[0]}")
    out = {"launches": launches, "forwards": forwards[0],
           "plies_per_run": stats["plies"],
           "positions_per_sec": stats["positions_per_sec"],
           "full_win_rate": stats["full_win_rate"]}
    print("direct match: " + json.dumps(out), flush=True)
    return out


def phase_fleet_selfplay(model, cfg) -> dict:
    """9c: selfplay over two supervised replicas behind the router."""
    cuda_expand.reset_launches()
    games, stats = selfplay.self_play(
        model, cfg, n_games=FLEET_SELFPLAY_GAMES,
        max_moves=FLEET_SELFPLAY_MOVES, temperature=SELFPLAY_TEMPERATURE,
        seed=SEED + 1, fleet=2, device=DEVICE)
    launches = cuda_expand.launches
    fstats = stats["engine"]
    forwards = replica_forwards(fstats)
    check(launches == sum(forwards) and min(forwards) > 0,
          f"fleet selfplay: expansion launches {launches} != replica "
          f"forwards {forwards}")
    check(no_request_lost(fstats), "fleet selfplay: no request lost")
    check_games_legal(games, "fleet selfplay")
    out = {"launches": launches, "replica_forwards": forwards,
           "positions": stats["positions"],
           "positions_per_sec": stats["positions_per_sec"],
           "mean_moves": stats["mean_moves"],
           "dispatches_per_rung": fleet_dispatches(fstats)}
    print("fleet selfplay: " + json.dumps(out), flush=True)
    out["host_profile"] = host_profile(lambda: selfplay.self_play(
        model, cfg, n_games=FLEET_SELFPLAY_GAMES, max_moves=PROFILE_MOVES,
        temperature=SELFPLAY_TEMPERATURE, seed=SEED + 3, fleet=2,
        device=DEVICE))
    print("fleet selfplay host profile: " + json.dumps(out["host_profile"]),
          flush=True)
    return out


def phase_search(model, cfg) -> dict:
    """9d: a PUCT search agent against a policy agent, both through one
    two-replica fleet with the position cache."""
    fleet = fleet_policy_engine(model, cfg, replicas=2,
                                config=EngineConfig(max_wait_ms=2.0),
                                cache=CacheConfig(), device=DEVICE,
                                name="search")
    results, illegal = [], []
    try:
        cuda_expand.reset_launches()
        fleet.warmup()
        searcher = checked_moves(agents.SearchAgent(
            model, cfg, simulations=SEARCH_SIMS, engine=fleet,
            device=DEVICE, search_config=SearchConfig(
                simulations=SEARCH_SIMS, wave_size=SEARCH_WAVE,
                tier="interactive")), illegal)
        search_one = searcher._search.search

        def recorded(*args, **kw):
            results.append(search_one(*args, **kw))
            return results[-1]

        searcher._search.search = recorded
        policy = checked_moves(agents.PolicyAgent(
            model, cfg, engine=fleet, device=DEVICE), illegal)
        t0 = time.perf_counter()
        games, _, stats = match.play_match(
            searcher, policy, n_games=SEARCH_GAMES, max_moves=SEARCH_MOVES,
            seed=SEED)
        wall = time.perf_counter() - t0
        cache = fleet.stats()  # before the cold searches below
        # cold searches (a fresh table) of positions along game 0
        cold = agents.SearchAgent(
            model, cfg, simulations=SEARCH_SIMS, engine=fleet, device=DEVICE,
            search_config=searcher.search_config)
        probes, g = [], selfplay.GameState()
        for i, m in enumerate(games[0].moves[:31]):
            if i % 10 == 0:
                probes.append(copy.deepcopy(g))
            g.player = m.player
            selfplay.apply_move(g, m.x, m.y)
            g.player = 3 - m.player
        profile = host_profile(lambda: [cold._search.search(p)
                                        for p in probes])
        profile["searches"] = len(probes)
    finally:
        fleet.close()
    launches = cuda_expand.launches
    fstats = fleet.stats()
    check(not illegal, f"search match: illegal moves {illegal}")
    check_games_legal(games, "search match")
    check(bool(results) and all(
        r.simulations + r.lost == SEARCH_SIMS and r.lost == 0
        and not r.fallback for r in results),
          "every search accounts for its full budget with nothing lost")
    forwards = replica_forwards(fstats)
    check(launches == sum(forwards), f"search fleet: expansion launches "
          f"{launches} != replica forwards {forwards}")
    check(no_request_lost(fstats), "search fleet: no request lost")
    out = {"launches": launches, "replica_forwards": forwards,
           "searches": len(results), "match_wall_s": wall,
           "waves_per_move": statistics.mean(r.waves for r in results),
           "wave_occupancy": statistics.mean(r.wave_occupancy
                                             for r in results),
           "search_wall_ms_per_move": 1e3 * statistics.mean(
               r.duration_s for r in results),
           "cache_hit_rate": fleet_hit_rate(cache),
           "cache": cache["fleet"]["cache"],
           "table": results[-1].tt,
           "dispatches_per_rung": fleet_dispatches(fstats)}
    print("search match: " + json.dumps(out), flush=True)
    print("search host profile: " + json.dumps(profile), flush=True)
    out["host_profile"] = profile
    return out


def phase_arena(grid, cfg) -> dict:
    """9e: the variant A/B arena: an f32 agent against an int8+sym agent
    of the grid net, each on its shared engine."""
    f32 = agents._policy_engine_for(grid, cfg, True, variant="f32",
                                    device=DEVICE)
    q = agents._policy_engine_for(grid, cfg, True, variant="int8+sym",
                                  device=DEVICE)
    try:
        a = agents.PolicyAgent(grid, cfg, name="grid", engine=f32,
                               device=DEVICE)
        b = agents.PolicyAgent(grid, cfg, name="grid+int8+sym", engine=q,
                               device=DEVICE)
        cuda_expand.reset_launches()
        _, _, stats = match.play_match(a, b, n_games=ARENA_GAMES,
                                       max_moves=ARENA_MOVES, seed=SEED)
        launches, sym = cuda_expand.launches, cuda_expand.sym_launches
        forwards = {"f32": f32.stats()["forwards"],
                    "int8+sym": q.stats()["forwards"]}
    finally:
        close_shared_engines()
    check(launches == forwards["f32"] > 0 and sym == forwards["int8+sym"] > 0,
          f"arena: expansion launches {launches} and sym launches {sym} != "
          f"the engines' forwards {forwards}")
    out = {"launches": launches, "sym_launches": sym, "forwards": forwards,
           "grid_win_rate": stats["grid_win_rate"],
           "truncated": stats["truncated"]}
    print("arena: " + json.dumps(out), flush=True)
    return out


def phase_replay(model, cfg) -> dict:
    """9f: the synthetic opening-heavy trace of data/sgf replayed open loop
    into a two-replica fleet with the cache."""
    items = build_synthetic_requests(SGF_DIR, requests=REPLAY_REQUESTS,
                                     seed=SEED)
    fleet = fleet_policy_engine(model, cfg, replicas=2,
                                config=EngineConfig(max_wait_ms=2.0),
                                cache=CacheConfig(), device=DEVICE,
                                name="replay")
    try:
        cuda_expand.reset_launches()
        fleet.warmup()
        report = WorkloadReplayer(fleet, items).run()
    finally:
        fleet.close()
    launches = cuda_expand.launches
    fstats = fleet.stats()
    forwards = replica_forwards(fstats)
    check(report["outcomes"] == {"ok": len(items)},
          f"replay: outcomes {report['outcomes']}")
    check(launches == sum(forwards), f"replay fleet: expansion launches "
          f"{launches} != replica forwards {forwards}")
    out = {"launches": launches, "replica_forwards": forwards,
           "cache_hit_rate": fleet_hit_rate(fstats),
           "cache": fstats["fleet"]["cache"],
           **{k: report[k] for k in ("requests", "target_span_s",
                                     "actual_span_s", "span_error_frac",
                                     "mean_lag_ms", "p99_lag_ms",
                                     "fidelity_ok", "boards_per_sec",
                                     "tiers")}}
    print("workload replay: " + json.dumps(out), flush=True)
    return out


def phase_games_path(model, grid) -> dict:
    """Phase 9: whole games on the card."""
    cfg = policy_cnn.CONFIGS["full"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-games-") as tmp:
        out = {"selfplay": phase_selfplay(model, cfg, tmp)}
    out["direct_match"] = phase_direct_match(model, grid, cfg)
    out["fleet_selfplay"] = phase_fleet_selfplay(model, cfg)
    out["search"] = phase_search(model, cfg)
    out["arena"] = phase_arena(grid, cfg)
    out["replay"] = phase_replay(model, cfg)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 9: {out['seconds']:.2f} s", flush=True)
    return out


def loop_learner_config(**overrides) -> ExperimentConfig:
    return ExperimentConfig(**{**LOOP_LEARNER, **overrides})


def save_seed_checkpoint(model, path: str) -> None:
    """``model``'s weights as a step-0 checkpoint of the loop's learner
    config, in the JAX package's format."""
    ckpt.save_checkpoint(path, convert.params_to_jax(model),
                         convert.opt_state_to_jax(sgd(TRAIN_RATE).init(model)),
                         {"id": "chip-smoke-seed", "step": 0,
                          "validation_history": [],
                          "config": loop_learner_config().to_dict()})


class GateDirectAgent(agents.PolicyAgent):
    """The gate's ``PolicyAgent``, counting the forwards it runs on the
    direct path (the challenger's; the incumbent's go through the fleet)."""

    forwards = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        predict = self._predict

        def counted(*a):
            GateDirectAgent.forwards += 1
            return predict(*a)

        # the direct path stages its inputs on the forward's device
        counted.device = getattr(predict, "device", None)
        self._predict = counted


def probe_fleet(fleet, boards):
    """The fleet's rows for ``boards`` on the interactive tier, and the rung
    each dispatched on."""
    packed, player, rank = boards
    futures = [fleet.submit(packed[i], int(player[i]), int(rank[i]),
                            tier="interactive") for i in range(len(packed))]
    return (np.stack([f.result() for f in futures]),
            np.array([-1 if f.bucket is None else f.bucket
                      for f in futures]))


def watch_gates(loop, boards, tmp) -> list:
    """Around every gate (in the gatekeeper's thread, the only one that
    publishes a champion and reloads the fleet): a copy of the champion
    file and the fleet's rows, before the gate and after a pass."""
    probes = []
    evaluate = loop.gatekeeper.evaluate

    def probe(when):
        snap = os.path.join(tmp, f"champion-{len(probes)}.npz")
        shutil.copyfile(loop.champion_path, snap)
        probes.append((when, snap, *probe_fleet(loop.fleet, boards)))

    def watched(path):
        probe("before")
        record = evaluate(path)  # GateRejected leaves the fleet untouched
        probe("after")
        return record

    loop.gatekeeper.evaluate = watched
    return probes


def check_probes(probes, cfg, boards) -> None:
    """Each probe's rows bitwise the direct forward of the champion it was
    taken under, at the rung each row dispatched on: before a gate, after
    the learner trained its own module, the fleet still serves the old
    champion; after a pass, the new one."""
    ladder = ladder_for(LOOP["games_per_round"] * LOOP["actors"])
    forward = make_log_prob_fn(cfg, device=DEVICE)
    for when, snap, rows, buckets in probes:
        _, champion, _ = load_policy(snap, device=DEVICE)
        check(bool((buckets >= 0).all()), "every probe row dispatched")
        for bucket in np.unique(buckets):
            idx = np.flatnonzero(buckets == bucket)
            check(np.array_equal(rows[idx], direct(
                forward, champion, ladder, boards, idx, int(bucket))),
                f"loop fleet rows {when} a gate at rung {bucket} != the "
                "champion's direct forward bitwise")


def check_buffer_games(buffer_dir: str) -> dict:
    """Every game in the buffer replays through the port's Python rules
    (``play`` raises on an occupied point) with each record's stones
    channel the board before its move."""
    buffer = ReplayBuffer(buffer_dir)
    buffer.seal()
    lo, hi, _ = buffer.extent()
    view = buffer.view(lo, hi)
    for start, count in view.game_ranges:
        packed, player, _, target = view.batch_at(np.arange(start,
                                                            start + count))
        stones, age = new_board()
        for i in range(count):
            check(np.array_equal(packed[i, 0], stones),
                  f"loop game at {start}: record {i} is not the board "
                  "before its move")
            play(stones, age, int(target[i]) // 19, int(target[i]) % 19,
                 int(player[i]))
    return {"games": view.num_games, "positions": hi - lo}


def phase_loop(model, tmp, telemetry: bool = False) -> dict:
    """10a: ``ExpertIterationLoop`` on ``full`` from phase 4's weights:
    actors through a two-replica fleet, the learner's windows, the gate
    (12d: with the telemetry plane on)."""
    cfg = policy_cnn.CONFIGS["full"]
    seed = os.path.join(tmp, "seed.npz")
    save_seed_checkpoint(model, seed)
    run_dir = os.path.join(tmp, "loop")
    loop = ExpertIterationLoop(
        run_dir, LoopConfig(**LOOP, seed=SEED, telemetry=telemetry,
                            telemetry_interval_s=TELEMETRY_INTERVAL_S),
        loop_learner_config(), seed_checkpoint=seed, device=DEVICE)
    boards = serving_boards(np.random.default_rng(SEED + 10),
                            LOOP_PROBE_BOARDS)
    probes = watch_gates(loop, boards, tmp)
    step0 = loop.learner.step
    GateDirectAgent.forwards = 0
    loop_gatekeeper.PolicyAgent = GateDirectAgent
    try:
        cuda_expand.reset_launches()
        t0 = time.perf_counter()
        summary = loop.run()
        seconds = time.perf_counter() - t0
        launches, sym = cuda_expand.launches, cuda_expand.sym_launches
    finally:
        loop_gatekeeper.PolicyAgent = agents.PolicyAgent
    fstats = loop.fleet.stats()
    by_path = {"loop_fleet": sum(replica_forwards(fstats)),
               "loop_learner": summary["learner_step"] - step0,
               "loop_gate_direct": GateDirectAgent.forwards}
    check(summary["fatal"] == {} and not summary["component_restarts"],
          f"loop: fatal {summary['fatal']}, restarts "
          f"{summary['component_restarts']}")
    check(summary["windows_trained"] == LOOP["windows"],
          f"loop: {summary['windows_trained']} windows")
    check(summary["games_acked"] == summary["games_durable"] > 0,
          f"loop: acked {summary['games_acked']} != durable "
          f"{summary['games_durable']}")
    check(by_path["loop_learner"]
          == LOOP["windows"] * LOOP["steps_per_window"], "learner steps")
    check(launches == sum(by_path.values()) and sym == 0
          and min(by_path.values()) > 0,
          f"loop: expansion launches {launches} != {by_path}, or sym "
          f"launches {sym}")
    events = read_jsonl(os.path.join(run_dir, "loop.jsonl"))
    gates = [e for e in events if e["kind"] == "loop_gate"]
    check(len(gates) == summary["gates_passed"] + summary["gates_rejected"]
          == LOOP["windows"], f"loop: gate outcomes {gates}")
    check(len(probes) == 2 * summary["gates_passed"]
          + summary["gates_rejected"], "a probe around every gate")
    check_probes(probes, cfg, boards)
    games = check_buffer_games(loop.buffer.dir)
    windows = read_windows(os.path.join(run_dir, "learner"))
    rounds = [e for e in events if e["kind"] == "loop_actor_round"]
    out = {"launches": launches, "launches_by_path": by_path,
           "seconds": seconds, "games_acked": summary["games_acked"],
           "buffer": games, "gates": [
               {k: g[k] for k in ("outcome", "win_rate", "seconds")}
               for g in gates],
           "windows": [{k: w[k] for k in ("window", "extent", "loss",
                                          "ewma", "seconds")}
                       for w in windows],
           "learner_ms_per_step": [1e3 * w["seconds"]
                                   / LOOP["steps_per_window"]
                                   for w in windows],
           "actor_positions_per_sec": [r["positions_per_sec"]
                                       for r in rounds],
           "fleet_dispatches_per_rung": fleet_dispatches(fstats),
           "champion_step": summary["champion_step"]}
    print("loop: " + json.dumps(out), flush=True)
    return out


def det_game(gid: int):
    """Random records of game ``gid`` of the deterministic schedule: a pure
    function of the gid, so a rerun ingests the same games."""
    rng = np.random.default_rng((SEED, 10_000 + gid))
    packed, player, rank = random_records(rng, DET_MOVES)
    target = rng.integers(0, 361, DET_MOVES)
    meta = np.stack([player, target // 19, target % 19, rank, rank,
                     np.zeros_like(player)], axis=1).astype(np.int32)
    return packed, meta


def det_learner_run(root: str):
    """The deterministic learner schedule in ``root`` (resuming whatever a
    killed run left): before window w the buffer grows to DET_GAMES * w
    games, a function of durable state only, then the window trains."""
    buffer = ReplayBuffer(os.path.join(root, "buf"), segment_games=4)
    learner = ContinuousLearner(
        buffer, os.path.join(root, "run"), loop_learner_config(),
        steps_per_window=DET_STEPS, min_window_positions=DET_MIN_POSITIONS,
        device=DEVICE)
    while learner.window < DET_WINDOWS:
        target = DET_GAMES * (learner.window + 1)
        while buffer.total_games < target:
            buffer.ingest_game(*det_game(buffer.total_games),
                               winner=1 + buffer.total_games % 2)
        learner.train_window()
    return buffer, read_windows(os.path.join(root, "run"))


def loop_witness_main(killed: str, clean: str) -> int:
    """The child of phase 10b that reruns a killed learner and a clean one
    in deterministic mode and recomputes every window offline. Prints one
    ``loop-deterministic:`` JSON line."""
    set_deterministic()
    t0 = time.perf_counter()
    out = {}
    for name, root in (("killed", killed), ("clean", clean)):
        buffer, records = det_learner_run(root)
        witness = [replay_window(os.path.join(root, "run"), buffer, r,
                                 device=DEVICE) == r["digest"]
                   for r in records]
        out[name] = {"digests": [r["digest"] for r in records],
                     "steps": [[r["step0"], r["step1"]] for r in records],
                     "witness": witness}
    out["resume_bitwise"] = out["killed"]["digests"] == \
        out["clean"]["digests"]
    out["seconds"] = time.perf_counter() - t0
    print("loop-deterministic: " + json.dumps(out), flush=True)
    return 0


def phase_loop_deterministic(tmp) -> dict:
    """10b: a learner SIGKILLed mid-window (``kill:step@K``) in a
    deterministic child, then one more child that resumes it and runs an
    uninterrupted schedule: the digests agree, and ``replay_window``
    recomputes each live window's digest bitwise."""
    t0 = time.perf_counter()
    killed, clean = os.path.join(tmp, "killed"), os.path.join(tmp, "clean")
    me = os.path.abspath(__file__)
    env = {**os.environ, "DEEPGO_FAULTS": f"kill:step@{DET_KILL_STEP}"}
    proc = subprocess.run([sys.executable, me, "--loop-learner", killed],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == -signal.SIGKILL, f"the learner child was not "
          f"killed (exit {proc.returncode}): {proc.stderr[-3000:]}")
    env.pop("DEEPGO_FAULTS")
    proc = subprocess.run([sys.executable, me, "--loop-witness", killed,
                           clean], env=env, capture_output=True, text=True,
                          timeout=300)
    print(proc.stdout.rstrip(), flush=True)
    check(proc.returncode == 0, f"loop witness child exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("loop-deterministic: ")]
    check(len(line) == 1, "the loop witness child printed its result")
    out = json.loads(line[0].partition(": ")[2])
    check(out["resume_bitwise"] and len(out["clean"]["digests"])
          == DET_WINDOWS, "a SIGKILLed learner resumes to the "
          "uninterrupted run's window digests")
    check(all(out["killed"]["witness"]) and all(out["clean"]["witness"]),
          "replay_window recomputes every window's digest bitwise")
    out["seconds"] = time.perf_counter() - t0
    return out


def write_value_split(root: str) -> None:
    """Synthetic splits with a ``winner.npy`` sidecar: random records as
    phase 7 writes them, each game won by its stronger side."""
    rng = np.random.default_rng(SEED + 11)
    for split, games in VALUE_GAMES.items():
        writer = DatasetWriter(os.path.join(root, split))
        winners = []
        for g in range(games):
            packed, player, _ = random_records(rng, GAME_POSITIONS)
            strong, weak = int(rng.integers(7, 10)), int(rng.integers(1, 4))
            winner = int(rng.integers(1, 3))
            black, white = (strong, weak) if winner == 1 else (weak, strong)
            target = rng.integers(0, 361, GAME_POSITIONS)
            meta = np.stack([player, target // 19, target % 19,
                             np.full_like(player, black),
                             np.full_like(player, white),
                             np.zeros_like(player)], axis=1)
            writer.add_game(f"{split}-{g:03d}", packed, meta)
            winners.append(np.full(GAME_POSITIONS, winner, np.int8))
        check(writer.finalize() == games * GAME_POSITIONS, f"{split} split")
        with atomic_write(os.path.join(root, split, "winner.npy")) as f:
            np.save(f, np.concatenate(winners))


def value_step_card_vs_cpu(root: str) -> dict:
    """One float32 value step (TF32 off) on the card against the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = value_cnn.ValueConfig(compute_dtype="float32")
    ds = GoDataset(root, "train")
    ix = value_training.decided_indices(ds)
    host = value_training.gather(ds, np.random.default_rng(SEED).choice(
        ix, size=VALUE_CARD_VS_CPU_BATCH))
    out = {}
    for device in (DEVICE, "cpu"):
        opt = sgd(VALUE_RATE, 0.0, 0.9)
        model = value_cnn.init(torch.Generator().manual_seed(SEED), cfg,
                               device=device)
        step, _ = value_training.make_step(cfg, opt)
        model, _, loss = step(model, opt.init(model),
                              *value_training.to_tensors(host, device))
        out[device] = (float(loss), [p.detach().cpu()
                                     for p in model.parameters()])
    loss_err = abs(out[DEVICE][0] - out["cpu"][0])
    param_err = max(float((a - b).abs().max())
                    for a, b in zip(out[DEVICE][1], out["cpu"][1]))
    print(f"value step card vs CPU, float32 B={VALUE_CARD_VS_CPU_BATCH} "
          f"with TF32 off: loss |diff| {loss_err:.3g}, updated params "
          f"max-abs {param_err:.3g} (tolerance {STEP_CARD_VS_CPU_TOL})",
          flush=True)
    check(loss_err <= STEP_CARD_VS_CPU_TOL
          and param_err <= STEP_CARD_VS_CPU_TOL,
          "float32 value step card vs CPU")
    return {"loss_abs_err": loss_err, "param_max_abs": param_err}


def time_value_steps(root: str) -> float:
    """Wall ms per bf16 value step at VALUE_BATCH, over VALUE_TIMED_STEPS
    steps after a warm-up, ending in a synchronize."""
    cfg = value_cnn.ValueConfig()
    ds = GoDataset(root, "train")
    ix = value_training.decided_indices(ds)
    rng = np.random.default_rng(SEED + 1)
    batches = [value_training.to_tensors(value_training.gather(
        ds, rng.choice(ix, size=VALUE_BATCH)), DEVICE)
        for _ in range(VALUE_TIMED_STEPS + 1)]
    opt = sgd(VALUE_RATE, 0.0, 0.9)
    model = value_cnn.init(torch.Generator().manual_seed(SEED), cfg,
                           device=DEVICE)
    state = opt.init(model)
    step, _ = value_training.make_step(cfg, opt)
    model, state, _ = step(model, state, *batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:]:
        model, state, _ = step(model, state, *b)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / VALUE_TIMED_STEPS


def phase_value(tmp) -> dict:
    """10c: the port's value trainer (``training.value.main``) on the card:
    ``ValueCNN`` 3 x 64 bf16, B = 256, VALUE_STEPS steps."""
    root = os.path.join(tmp, "value-data")
    write_value_split(root)
    cuda_expand.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        result = value_training.main([
            "--data-root", root, "--iters", str(VALUE_STEPS),
            "--batch-size", str(VALUE_BATCH), "--rate", str(VALUE_RATE),
            "--val-interval", "20",
            "--val-size", str(VALUE_VAL_SIZE), "--print-interval", "10",
            "--out", os.path.join(tmp, "value-run"), "--device", DEVICE])
    seconds = time.perf_counter() - t0
    launches, sym = cuda_expand.launches, cuda_expand.sym_launches
    history = result["history"]
    print("value training: " + " | ".join(log.getvalue().splitlines()),
          flush=True)
    check(launches == VALUE_STEPS + len(history) and sym == 0,
          f"value training: expansion launches {launches} != "
          f"{VALUE_STEPS} steps + {len(history)} evaluations")
    losses = [h["val_loss"] for h in history]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"value validation loss finite and falling: {losses}")
    _, vmodel, _ = load_value(result["path"], device=DEVICE)
    out = {"launches": launches, "history": history, "seconds": seconds,
           "checkpoint_params": sum(p.numel() for p in vmodel.parameters()),
           "card_vs_cpu": value_step_card_vs_cpu(root),
           "ms_per_step": time_value_steps(root)}
    print("value: " + json.dumps(out), flush=True)
    return out


def session_protocol(stdout: str, key: str) -> list:
    return [line.split()[1:] for line in stdout.splitlines()
            if line.startswith(key + " ")]


def play_sessions(service) -> list:
    """SESSION_GAMES sessions, one thread each, of SESSION_MOVES client
    moves (a seeded preference order over the board) each answered by an
    engine reply; returns the replies' wall ms."""
    reply_ms, errors = [], []

    def session(s):
        try:
            sid = service.new_game(f"chip-{s}")
            order = np.random.default_rng((SEED, s)).permutation(361)
            for _ in range(SESSION_MOVES):
                game = service.store.get(sid)
                point = next(int(p) for p in order if game.check_move(
                    int(p) // 19, int(p) % 19, game.to_play) is None)
                service.play(sid, point // 19, point % 19, reply=False)
                t0 = time.perf_counter()
                service.engine_reply(sid)
                reply_ms.append(1e3 * (time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 - reported by the check
            errors.append(f"session {s}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=session, args=(s,),
                                name=f"chip-smoke-session-{s}")
               for s in range(SESSION_GAMES)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not errors and not any(t.is_alive() for t in threads),
          f"sessions: {errors}")
    return reply_ms


def phase_sessions(model, tmp) -> dict:
    """10d: ``GameService`` over a one-replica card fleet on ``full``, then
    the port's crash-resume child SIGKILLed after an ack and rerun."""
    cfg = policy_cnn.CONFIGS["full"]
    fleet = fleet_policy_engine(model, cfg, replicas=1,
                                config=EngineConfig(buckets=(1, 8),
                                                    max_wait_ms=1.0),
                                device=DEVICE, name="sessions")
    store_dir = os.path.join(tmp, "store")
    service = GameService(fleet, SessionStore(store_dir,
                                              checkpoint_every=16))
    try:
        cuda_expand.reset_launches()
        fleet.warmup()
        reply_ms = play_sessions(service)
    finally:
        fleet.close()
    launches = cuda_expand.launches
    forwards = sum(replica_forwards(fleet.stats()))
    check(launches == forwards > 0 and cuda_expand.sym_launches == 0,
          f"sessions: expansion launches {launches} != fleet forwards "
          f"{forwards}")
    check(len(reply_ms) == SESSION_GAMES * SESSION_MOVES
          and service.replies == len(reply_ms), "sessions: every reply")
    digests = {sid: g.digest() for sid, g in service.store.games.items()}
    service.close()
    reopened = SessionStore(store_dir)
    check({sid: g.digest() for sid, g in reopened.games.items()}
          == digests, "sessions: the reopened store holds the same games")
    reopened.close(final_checkpoint=False)

    t0 = time.perf_counter()
    killed = os.path.join(tmp, "child-killed")
    cmd = [sys.executable, "-m", "deepgo_tpu_torch.sessions.child",
           "--store", killed, *SESSION_CHILD]
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(cmd + ["--kill-after-acks",
                                 str(SESSION_KILL_AFTER)], cwd=here,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == -signal.SIGKILL, f"the session child was not "
          f"killed (exit {proc.returncode}): {proc.stderr[-3000:]}")
    acked = session_protocol(proc.stdout, "SESSION_ACK")
    store = SessionStore(killed)
    recovered = sum(len(g.moves) for g in store.games.values())
    store.close(final_checkpoint=False)
    check(len(acked) == SESSION_KILL_AFTER == recovered,
          f"sessions child: {len(acked)} acks, {recovered} moves recovered")
    proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"the resumed session child exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    resumed = session_protocol(proc.stdout, "SESSION_DIGEST")
    with contextlib.redirect_stdout(io.StringIO()) as ref:
        session_child.main(["--store", os.path.join(tmp, "child-clean"),
                            *SESSION_CHILD, "--device", DEVICE])
    reference = session_protocol(ref.getvalue(), "SESSION_DIGEST")
    check(len(reference) == 2 and resumed == reference,
          f"sessions child: resumed digests {resumed} != uninterrupted "
          f"{reference}")
    out = {"launches": launches, "forwards": forwards,
           "replies": len(reply_ms),
           "reply_p50_ms": float(np.percentile(reply_ms, 50)),
           "reply_p99_ms": float(np.percentile(reply_ms, 99)),
           "child_acks_before_kill": len(acked),
           "child_seconds": time.perf_counter() - t0}
    print("sessions: " + json.dumps(out), flush=True)
    return out


def phase_loop_path(model) -> dict:
    """Phase 10: the expert-iteration loop, value training and durable
    game sessions on the card."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-loop-") as tmp:
        out = {"loop": phase_loop(model, tmp),
               "deterministic": phase_loop_deterministic(tmp),
               "value": phase_value(tmp),
               "sessions": phase_sessions(model, tmp)}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 10: {out['seconds']:.2f} s", flush=True)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def par_config(root: str, **overrides) -> ExperimentConfig:
    """Phase 11's float32 ``full`` config: step-indexed loading (the
    layouts train on exactly one card's batches), momentum for a state to
    shard, no validation, no checkpoint but the ones asked for."""
    return train_config(root, **{**PAR_F32, **overrides})


def full_leaves(exp: Experiment) -> list:
    """Every parameter and optimizer leaf of ``exp``, gathered to full host
    arrays in the checkpoint's order (a collective on every rank)."""
    params, state = reshard.gather_to_host(exp.model, exp.opt_state,
                                           exp.placement)
    return ckpt.tree_leaves(params) + ckpt.tree_leaves(state)


def n_param_leaves(exp: Experiment) -> int:
    return len(list(exp.model.parameters()))


def bitwise(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


def par_group_main(root: str) -> int:
    """Phase 11(a)'s child: deterministic mode set before CUDA starts; the
    float32 ``full`` Experiment for PAR_STEPS steps outside any process
    group, then the same inside an NCCL group of one rank. Prints one
    ``par-group:`` JSON line."""
    set_deterministic()
    cfg = par_config(root)
    alone = Experiment(cfg, run_id="alone", device=DEVICE)
    alone.run(PAR_STEPS)
    distributed.initialize(f"tcp://localhost:{free_port()}", 1, 0,
                           device=DEVICE)
    try:
        cuda_expand.reset_launches()
        grouped = Experiment(cfg, run_id="grouped", device=DEVICE)
        grouped.run(PAR_STEPS)
        launches = cuda_expand.launches
        backend = "nccl" if DEVICE == "cuda" else "gloo"
        check(grouped.mesh.device_mesh is not None
              and torch.distributed.get_backend() == backend,
              f"the grouped run is in an {backend} group")
        same = (bitwise(full_leaves(alone), full_leaves(grouped))
                and alone.ewma == grouped.ewma)
    finally:
        distributed.shutdown()
    print(f"NCCL group of one rank vs no group, {PAR_STEPS} float32 steps: "
          + ("bitwise equal" if same else "DIFFERENT"), flush=True)
    check(same, "the grouped steps equal the ungrouped ones bitwise")
    check(launches == PAR_STEPS, f"expansion launches {launches} != "
          f"{PAR_STEPS} steps")
    print("par-group: " + json.dumps({"bitwise": same, "launches": launches,
                                      "device": str(grouped.device)}),
          flush=True)
    return 0


def elastic_host_main(run_dir: str, root: str, host: int, hosts: int,
                      iters: int) -> int:
    """Phase 11(b)'s elastic host: deterministic mode set before CUDA
    starts, then ``run_elastic`` over the shared ``run_dir``."""
    from deepgo_tpu_torch.parallel.elastic import ElasticConfig, run_elastic

    set_deterministic()
    cuda_expand.reset_launches()
    run_elastic(run_dir, iters,
                overrides={**TRAIN_RUN, **ELASTIC_RUN, "data_root": root},
                ecfg=ElasticConfig(process_id=host, expected_hosts=hosts,
                                   heartbeat_interval_s=ELASTIC_BEAT_S,
                                   miss_budget=ELASTIC_MISSES,
                                   step_deadline_s=300.0),
                device=DEVICE)
    print(f"elastic-launches: {cuda_expand.launches}", flush=True)
    return 0


def start_host(run_dir: str, root: str, host: int, hosts: int,
               faults_env: str | None = None) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "DEEPGO_FAULTS"}
    if faults_env:
        env["DEEPGO_FAULTS"] = faults_env
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--elastic-host", run_dir,
         root, str(host), str(hosts), str(ELASTIC_ITERS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def tagged(out: str, tag: str) -> list:
    return [json.loads(line.partition(" ")[2]) for line in out.splitlines()
            if line.startswith(tag + " ")]


def phase_elastic(root: str) -> dict:
    """Phase 11(b): two elastic hosts over one run directory on the one
    card; host 1 is SIGKILLed at step ELASTIC_KILL_STEP, after the step-5
    checkpoint. The survivor detects the loss, converges on the newest
    checkpoint and finishes; its final checkpoint equals an uninterrupted
    single host's bitwise."""
    t0 = time.perf_counter()
    shared = os.path.join(root, "elastic-fleet")
    procs = [start_host(shared, root, 0, 2),
             start_host(shared, root, 1, 2,
                        f"kill:step@{ELASTIC_KILL_STEP}")]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600) + (proc.returncode,))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    (out0, err0, rc0), (_, err1, rc1) = outs
    check(rc1 == -signal.SIGKILL, f"host 1 exited {rc1}, not by SIGKILL: "
          f"{err1[-1500:]}")
    check(rc0 == 0, f"the surviving host exited {rc0}: {err0[-3000:]}")
    recs, done = tagged(out0, "ELASTIC_RECOVERY"), tagged(out0,
                                                          "ELASTIC_DONE")
    check(len(recs) == 1 and recs[0]["process_id"] == 1
          and recs[0]["survivors"] == [0], f"one recovery from host 1's "
          f"loss: {recs}")
    check(done and done[-1]["final_step"] == ELASTIC_ITERS,
          "the survivor reached the target step")
    print("ELASTIC_RECOVERY " + json.dumps(recs[0]), flush=True)
    clean_dir = os.path.join(root, "elastic-clean")
    clean = start_host(clean_dir, root, 0, 1)
    out_c, err_c = clean.communicate(timeout=600)
    check(clean.returncode == 0, f"the clean host exited "
          f"{clean.returncode}: {err_c[-3000:]}")
    name = ckpt.checkpoint_name(ELASTIC_ITERS)
    meta_s, p_s, o_s = ckpt.load_checkpoint(os.path.join(shared, name))
    meta_c, p_c, o_c = ckpt.load_checkpoint(os.path.join(clean_dir, name))
    same = bitwise(p_s + o_s, p_c + o_c) and meta_s["ewma"] == meta_c["ewma"]
    print(f"elastic: survivor's step-{ELASTIC_ITERS} checkpoint vs an "
          "uninterrupted host's: " + ("bitwise equal" if same else
                                      "DIFFERENT"), flush=True)
    check(same, "the survivor's final checkpoint is the clean run's")
    launches = [int(line.split()[1]) for line in out0.splitlines()
                if line.startswith("elastic-launches:")][0]
    return {"recovery": recs[0], "survivor": done[-1],
            "recovery_latency_s": recs[0]["recovery_latency_s"],
            "steps_lost": recs[0]["steps_lost"], "bitwise": same,
            "launches": launches, "seconds": time.perf_counter() - t0}


def phase_group(root: str) -> dict:
    """Phase 11(a), in a child for deterministic mode."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--par-group", root],
        capture_output=True, text=True, timeout=600)
    print(proc.stdout.rstrip(), flush=True)
    check(proc.returncode == 0, f"par-group child exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    out = tagged(proc.stdout, "par-group:")[0]
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_parallel() -> dict:
    """Phase 11 on one card: (a) a process group of one rank, (b) the
    elastic two-host run."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-par-") as root:
        write_split(root)
        out = {"group": phase_group(root), "elastic": phase_elastic(root)}
    out["seconds"] = time.perf_counter() - t0
    print("phase 11 layouts run: 1x1 in an NCCL group of one rank, two "
          "elastic hosts on one card; not run (they need --cards 4): "
          + ", ".join(sorted(PAR_LAYOUTS)) + ", dp4-bf16, "
          "reshard-2x2z-to-4x1, reshard-2x2z-to-1x1", flush=True)
    print(f"phase 11: {out['seconds']:.2f} s", flush=True)
    return out


def dp_throughput(root: str, batch: int, mesh_ranks: int) -> dict:
    """``Experiment.run`` on ``full`` bf16 (phase 7's config at a global
    batch of ``batch``, K = 10) over every rank of the group, or alone
    (``mesh_ranks=1``, no group), after one warm-up call; samples/s, wall
    per step and the expansion kernel's launches on this rank."""
    cfg = train_config(root, batch_size=batch, validation_interval=10_000,
                       keep_checkpoints=1, data_parallel=mesh_ranks)
    exp = Experiment(cfg, run_id=f"dp{mesh_ranks}", device=DEVICE)
    # one warm-up call: the first collective sets up NCCL's communicators
    exp.run(TRAIN_RUN["steps_per_call"])
    cuda_expand.reset_launches()
    summary = exp.run(TRAIN_STEPS)
    launches = cuda_expand.launches
    check(launches == TRAIN_STEPS, f"expansion launches {launches} != "
          f"{TRAIN_STEPS} steps")
    return {"ranks": mesh_ranks, "global_batch": batch,
            "samples_per_sec": summary["samples_per_sec"],
            "wall_ms_per_step": summary["runtime"] * 1e3 / TRAIN_STEPS,
            "launches": launches, "exp": exp}


def profile_call(exp: Experiment, root: str) -> dict:
    """Device ms per step of one K = 10 call of ``exp``'s step on its own
    rows, in total and in NCCL kernels (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = exp.config
    with AsyncLoader(GoDataset(root, cfg.train_split), cfg.batch_size,
                     seed=cfg.seed + 1, num_threads=0, device=exp.device,
                     stack=10, wire=exp.wire,
                     shard=exp._data_shard()) as loader:
        batch = loader.get()
        exp.train_step_many(exp.model, exp.opt_state, loader.get())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            exp.model, exp.opt_state, _ = exp.train_step_many(
                exp.model, exp.opt_state, batch)
            torch.cuda.synchronize()
    total = nccl = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            total += ev.self_device_time_total
            if "nccl" in ev.key.lower():
                nccl += ev.self_device_time_total
    return {"device_ms_per_step": total / 1e3 / 10,
            "nccl_ms_per_step": nccl / 1e3 / 10}


def time_all_reduce(numel: int, group) -> float:
    """Device ms of one AVG all-reduce of ``numel`` float32 (CUDA events
    around PAR_REPS back-to-back calls)."""
    flat = torch.ones(numel, dtype=torch.float32, device=DEVICE)
    for _ in range(3):
        torch.distributed.all_reduce(flat, op=torch.distributed.ReduceOp.AVG,
                                     group=group)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(PAR_REPS):
        torch.distributed.all_reduce(flat, op=torch.distributed.ReduceOp.AVG,
                                     group=group)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / PAR_REPS


def layout_run(root: str, d: int, m: int, zero: bool,
               layers: int = TRAIN_RUN["num_layers"]) -> dict:
    exp = Experiment(par_config(root, data_parallel=d, tensor_parallel=m,
                                zero_opt=zero, num_layers=layers),
                     run_id=f"layout-{d}x{m}{'z' if zero else ''}-{layers}",
                     device=DEVICE)
    exp.init()
    losses = record_losses(exp)
    exp.run(PAR_STEPS)
    leaves = full_leaves(exp)
    n = n_param_leaves(exp)
    return {"losses": torch.cat([x.reshape(-1) for x in losses]).tolist(),
            "params": leaves[:n], "state": leaves[n:]}


def f32_drift(root: str, layers: int) -> dict:
    """On one card, the gradients of one forward and backward of ``full``
    cut to ``layers`` layers (width kept) at PAR_F32's batch in float32,
    against the same in float64: done whole, and split as the 2 x 2 layout
    splits it (two halves of the batch, every hidden convolution as two
    half-channel convolutions), its sums done here. The largest difference
    of a leaf over the leaf's largest float64 value, the worst leaf's
    name, and the loss's relative difference."""
    cfg = dataclasses.replace(policy_cnn.CONFIGS["full"],
                              compute_dtype="float32", num_layers=layers)
    model = policy_cnn.init(torch.Generator().manual_seed(SEED), cfg,
                            device=DEVICE)
    batch = to_device(make_step_batch(GoDataset(root, "train"), SEED, 0,
                                      PAR_F32["batch_size"]), DEVICE)
    planes = plain_expand.expand_planes(
        batch["packed"], batch["player"], batch["rank"],
        dtype=torch.float32)
    names = [n for n, _ in model.named_parameters()]

    def step(dtype, split, rows):
        leaves = [p.detach().to(dtype).requires_grad_(True)
                  for p in model.parameters()]
        x = planes[rows].to(dtype).permute(0, 3, 1, 2)
        last = len(leaves) // 2 - 1
        for i in range(last + 1):
            w, b = leaves[2 * i], leaves[2 * i + 1]
            pad = w.shape[-1] // 2
            if split and i < last:
                h = w.shape[0] // 2
                x = torch.cat([F.conv2d(x, part, padding=pad)
                               .permute(0, 2, 3, 1)
                               for part in (w[:h], w[h:])],
                              dim=3).permute(0, 3, 1, 2)
            else:
                x = F.conv2d(x, w, padding=pad)
            x = x + b[None]
            x = F.relu(x) if i < last else x
        loss = F.nll_loss(F.log_softmax(x.reshape(x.shape[0], -1), -1),
                          batch["target"][rows].long())
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach().double(), [g.double() for g in grads]

    def run(dtype, split):
        if not split:
            return step(dtype, False, slice(None))
        n = planes.shape[0] // 2
        (l0, g0), (l1, g1) = (step(dtype, True, slice(0, n)),
                              step(dtype, True, slice(n, 2 * n)))
        return (l0 + l1) / 2, [(a + b) / 2 for a, b in zip(g0, g1)]

    with torch.enable_grad():
        ref_loss, ref = run(torch.float64, False)
        out = {}
        for name, split in (("one_card", False), ("2x2_split", True)):
            loss, grads = run(torch.float32, split)
            errs = [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(grads, ref)]
            worst = max(range(len(errs)), key=errs.__getitem__)
            out[name] = {"grad_rel": errs[worst], "worst_leaf": names[worst],
                         "loss_rel": float((loss - ref_loss).abs()
                                           / ref_loss.abs())}
    return out


def leaf_errors(run: list, ref: list) -> dict:
    """Max-abs difference, the worst leaf's index, and the largest
    |a - b| / (atol + rtol |b|) (<= 1 is within tolerance)."""
    diffs = [np.abs(a.astype(np.float64) - b) for a, b in zip(run, ref)]
    worst = int(np.argmax([float(d.max()) for d in diffs]))
    ratio = max(float((d / (PAR_PARAM_ATOL + PAR_PARAM_RTOL * np.abs(b)))
                      .max()) for d, b in zip(diffs, ref))
    return {"max_abs": float(diffs[worst].max()), "worst_leaf": worst,
            "tolerance_ratio": ratio}


def close_to(run: dict, ref: dict) -> dict:
    """Losses within rtol and parameters within rtol / atol of
    tests/test_parallel.py (what that test holds); the optimizer state's
    differences are recorded beside them."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                       ref["losses"]))
    params = leaf_errors(run["params"], ref["params"])
    return {"ok": loss_err <= PAR_LOSS_RTOL
            and params["tolerance_ratio"] <= 1.0,
            "loss_rel_err": loss_err, "params": params,
            "opt_state": leaf_errors(run["state"], ref["state"])}


def par_rank_main(rank: int, n: int, port: int, root: str) -> int:
    """One NCCL rank of the four-card phase 11. Rank 0 first runs the
    one-card references outside any group. Prints one ``par-rank:`` JSON
    line."""
    set_deterministic()  # before CUDA starts; the timed runs turn it off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank}
    if rank == 0:
        torch.cuda.set_device(0)
        out["f32_vs_f64"] = {layers: f32_drift(root, layers)
                             for layers in (PAR_GATE_LAYERS, 6, 12)}
        ref = layout_run(root, 1, 1, False, PAR_GATE_LAYERS)
        ref_full = layout_run(root, 1, 1, False)
        deterministic(False)
        one = dp_throughput(root, PAR_BATCH_PER_CARD, 1)
        one.pop("exp")
        out["one_card"] = one
        deterministic(True)
    distributed.initialize(f"tcp://localhost:{port}", n, rank, device=DEVICE)
    try:
        runs, full = {}, {}
        for name, (d, m, zero) in PAR_LAYOUTS.items():
            runs[name] = layout_run(root, d, m, zero, PAR_GATE_LAYERS)
            full[name] = layout_run(root, d, m, zero)
        if rank == 0:
            out["layouts"] = {name: close_to(run, ref)
                              for name, run in runs.items()}
            out["layouts_full_depth"] = {name: close_to(run, ref_full)
                                         for name, run in full.items()}
            out["zero_bitwise"] = {
                f"{lay} {depth}": bitwise(
                    group[lay]["params"] + group[lay]["state"],
                    group[lay + "+zero"]["params"]
                    + group[lay + "+zero"]["state"])
                and group[lay]["losses"] == group[lay + "+zero"]["losses"]
                for lay in ("4x1", "2x2")
                for depth, group in (("cut", runs), ("full", full))}
        # the 2 x 2 + ZeRO checkpoint, restored under 4 x 1
        exp = Experiment(par_config(root, data_parallel=2,
                                    tensor_parallel=2),
                         run_id="reshard", device=DEVICE)
        exp.run(PAR_STEPS)
        path = exp.save()
        _, p_leaves, o_leaves = ckpt.load_checkpoint(path)
        back = Experiment.load(path, device=DEVICE,
                               remesh={"data_parallel": 4,
                                       "tensor_parallel": 1})
        out["restore_4x1"] = bitwise(full_leaves(back), p_leaves + o_leaves)
        out["restore_4x1_findings"] = len(back.last_restore_findings)
        deterministic(False)
        numel = sum(p.numel() for p in
                    policy_cnn.PolicyCNN(policy_cnn.CONFIGS["full"])
                    .parameters()) + 1
        out["all_reduce"] = {"numel": numel, "bytes": 4 * numel,
                             "ms": time_all_reduce(
                                 numel, back.mesh.group("data"))}
        dp = dp_throughput(root, PAR_BATCH_PER_CARD * n, n)
        profile = profile_call(dp.pop("exp"), root)
        out["dp"] = dp | profile
    finally:
        distributed.shutdown()
    if rank == 0:
        one = Experiment.load(path, device=DEVICE,
                              remesh={"data_parallel": 1,
                                      "tensor_parallel": 1})
        out["restore_1x1"] = bitwise(full_leaves(one), p_leaves + o_leaves)
    print("par-rank: " + json.dumps(out), flush=True)
    return 0


def wait_ranks(procs: list, logs: list, timeout: float) -> list:
    """(stdout, stderr, exit code) of every rank, from its log files. The
    first rank to fail ends the others at once: they would wait in a
    collective for it until NCCL's own timeout."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.5)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    outs = []
    for proc, files in zip(procs, logs):
        texts = []
        for f in files:
            f.seek(0)
            texts.append(f.read())
            f.close()
        outs.append((*texts, proc.returncode))
    return outs


def phase_four_cards() -> dict:
    """Phase 11 on four cards: four NCCL ranks, one per card."""
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    check(n >= PAR_CARDS, f"--cards {PAR_CARDS} needs {PAR_CARDS} cards, "
          f"found {n}")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    print("nvidia-smi topo -m:\n" + (topo.stdout or topo.stderr).rstrip(),
          flush=True)
    peers = [[int(i == j or torch.cuda.can_device_access_peer(i, j))
              for j in range(PAR_CARDS)] for i in range(PAR_CARDS)]
    print(f"peer access between cards (torch): {peers}", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-par4-") as root:
        write_split(root)
        port = free_port()
        # lint: allow[atomic-write] the ranks' scratch logs in a temporary directory, read back once they exit
        logs = [(open(os.path.join(root, f"rank{r}.out"), "w+"),
                 open(os.path.join(root, f"rank{r}.err"), "w+"))  # lint: allow[atomic-write] the same scratch logs
                for r in range(PAR_CARDS)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--par-rank",
             str(r), str(PAR_CARDS), str(port), root],
            stdout=out, stderr=err, text=True) for r, (out, err) in
            enumerate(logs)]
        outs = wait_ranks(procs, logs, timeout=600)
    for r, (_, err, rc) in enumerate(outs):
        check(rc == 0, f"rank {r} exited {rc}: {err[-3000:]}")
    ranks = [tagged(o, "par-rank:")[0] for o, _, _ in outs]
    for r in ranks:
        print("par-rank: " + json.dumps(r), flush=True)
    lead = ranks[0]
    print("one card, float32 gradients against float64 by depth (width "
          "128): " + json.dumps(lead["f32_vs_f64"]), flush=True)
    for depth, key in ((f"{PAR_GATE_LAYERS} x 128", "layouts"),
                       ("12 x 128, recorded", "layouts_full_depth")):
        for name, res in lead[key].items():
            print(f"layout {name} vs one card, {depth}: loss rel err "
                  f"{res['loss_rel_err']:.3g}; params max-abs "
                  f"{res['params']['max_abs']:.3g} (tolerance ratio "
                  f"{res['params']['tolerance_ratio']:.3g}); optimizer "
                  f"state max-abs {res['opt_state']['max_abs']:.3g} (ratio "
                  f"{res['opt_state']['tolerance_ratio']:.3g}): "
                  + ("within tolerance" if res["ok"]
                     else "OUT OF TOLERANCE"), flush=True)
    check(all(res["ok"] for res in lead["layouts"].values()),
          f"every layout within tolerance of one card at "
          f"{PAR_GATE_LAYERS} x 128")
    check(all(lead["zero_bitwise"].values()),
          f"ZeRO equals replicated bitwise: {lead['zero_bitwise']}")
    check(all(r["restore_4x1"] for r in ranks) and lead["restore_1x1"],
          "the 2x2 + ZeRO checkpoint restores under 4x1 and 1x1 bitwise")
    launches = [r["dp"]["launches"] for r in ranks]
    dp, one = lead["dp"], lead["one_card"]
    print(f"DP=4 bf16 B={dp['global_batch']}: {dp['samples_per_sec']:.0f} "
          f"samples/s, {dp['wall_ms_per_step']:.2f} ms a step (wall); one "
          f"card B={one['global_batch']}: {one['samples_per_sec']:.0f} "
          f"samples/s, {one['wall_ms_per_step']:.2f} ms; all-reduce of "
          f"{lead['all_reduce']['bytes'] / 1e6:.2f} MB "
          f"{lead['all_reduce']['ms']:.3f} ms; launches per rank "
          f"{launches}", flush=True)
    ran = sorted(PAR_LAYOUTS) + ["dp4-bf16", "reshard-2x2z-to-4x1",
                                 "reshard-2x2z-to-1x1"]
    print("phase 11 layouts run: " + ", ".join(ran) + "; not run: "
          "none", flush=True)
    return {"ranks": ranks, "launches": launches,
            "seconds": time.perf_counter() - t0}


def private_registry():
    """A fresh process registry: the attribution of one run reads the
    close-time snapshot of the process registry, so a run measured on its
    own must not find the counts of the runs before it there."""
    from deepgo_tpu_torch.obs import registry as obs_registry

    obs_registry._default = obs_registry.MetricsRegistry()


def trace_kernel_events(trace_path: str, needle: str) -> dict:
    """The device kernel events of a torch.profiler Chrome trace whose name
    holds ``needle``: their count (``kernels``), every event name
    (``names``), the capture window's margins around them in microseconds
    (``start_margin_us``: window start to the first such kernel;
    ``end_margin_us``: the last one's end to the window's end), the least
    launch-to-start gap over every kernel matched to its runtime launch
    (``min_launch_gap_us``: below 0 the device clock runs behind the
    host's) and the runtime launches that have no device event
    (``orphans``, each with its offset into the window and the ranges
    around it)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    hits = [e for e in device if e.get("cat") == "kernel"
            and needle in str(e.get("name", ""))]
    instants = {e.get("name"): e["ts"] for e in events
                if e.get("ph") == "i" and "ts" in e}
    start = instants.get("Iteration Start: PyTorch Profiler")
    end = instants.get("Record Window End")
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if str(e.get("cat", "")).startswith("cuda_")
                 and "Launch" in str(e.get("name"))
                 and "correlation" in e.get("args", {})}
    seen = {e.get("args", {}).get("correlation") for e in device}
    gaps = [e["ts"] - launch_ts[c] for e in device
            if (c := e.get("args", {}).get("correlation")) in launch_ts]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    orphans = [{"us_into_window": ts - (start or 0), "ranges": [
        r["name"] for r in ranges
        if r["ts"] <= ts <= r["ts"] + r.get("dur", 0)]}
        for c, ts in sorted(launch_ts.items(), key=lambda kv: kv[1])
        if c not in seen]
    return {"kernels": len(hits), "names": {e.get("name") for e in events},
            "start_margin_us": (min(e["ts"] for e in hits) - start
                                if hits and start is not None else None),
            "end_margin_us": (end - max(e["ts"] + e.get("dur", 0)
                                        for e in hits)
                              if hits and end is not None else None),
            "min_launch_gap_us": min(gaps, default=None),
            "orphans": orphans}


def obs_train_run(root: str, profile: bool) -> dict:
    """One 60-step ``Experiment.run`` of phase 7's config on a private
    registry; with ``profile`` the launch counts are zeroed just before."""
    from deepgo_tpu_torch.obs import attribute_run

    private_registry()
    exp = Experiment(train_config(root, profile=profile, cost_ledger=True),
                     run_id=f"obs-{'profiled' if profile else 'plain'}",
                     device=DEVICE)
    exp.init()
    cuda_expand.reset_launches()
    summary = exp.run(OBS_TRAIN_STEPS)
    launches, sym = cuda_expand.launches, cuda_expand.sym_launches
    att = attribute_run(exp.run_path)["hosts"]["0"]
    return {"exp": exp, "launches": launches, "sym_launches": sym,
            "samples_per_sec": summary["samples_per_sec"],
            "attribution": att}


def span_cost_us(n: int = 2000) -> dict:
    """Host microseconds of one span with no profiler and no sink, with
    its profiler bridge (``record_function`` and NVTX ranges) and with the
    bridge replaced by a no-op: the bridge's own cost is the difference."""
    from deepgo_tpu_torch.obs import spans
    from deepgo_tpu_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()

    def per_span() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span("span-cost", registry=reg):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    bridge = spans._profiler_range
    out = {"bridge": per_span()}
    spans._profiler_range = lambda name: contextlib.nullcontext()
    try:
        out["no_bridge"] = per_span()
    finally:
        spans._profiler_range = bridge
    out["bridge_again"] = per_span()
    return out


def phase_profiled_training() -> dict:
    """12a: phase 7's training run with ``profile=True``: the trace holds
    the span names and one expansion-kernel event per launch, the
    attribution covers the wall, and the cost ledger prices the step."""
    from deepgo_tpu_torch.obs import CostLedger, costmodel
    from deepgo_tpu_torch.obs.registry import MetricsRegistry
    from deepgo_tpu_torch.utils.profiling import TRACE_FILE

    cfg = policy_cnn.CONFIGS["full"]
    batch = TRAIN_RUN["batch_size"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-obs-") as root:
        write_split(root)
        plain = obs_train_run(root, profile=False)
        prof = obs_train_run(root, profile=True)
        run_path = prof["exp"].run_path
        t0 = time.perf_counter()
        tr = trace_kernel_events(os.path.join(run_path, "trace", TRACE_FILE),
                                 "expand_planes_kernel")
        kernels, names = tr["kernels"], tr.pop("names")
        trace_read_s = time.perf_counter() - t0
        events = read_jsonl(os.path.join(run_path, "metrics.jsonl"))
    eval_batches = 2 * math.ceil(TRAIN_RUN["validation_size"] / batch)
    check(prof["launches"] == OBS_TRAIN_STEPS + eval_batches
          and prof["sym_launches"] == 0,
          f"profiled run: expansion launches {prof['launches']} != "
          f"{OBS_TRAIN_STEPS} steps + {eval_batches} eval batches")
    check(kernels == prof["launches"], f"trace: {kernels} expansion-kernel "
          f"events != {prof['launches']} launches: {json.dumps(tr)}")
    check({"validate", "checkpoint_save", "train.forward"} <= names,
          "trace: the span and step ranges are in it by name")
    att = prof["attribution"]
    check(att["attributed_fraction"] >= ATTRIBUTION_BAR
          and abs(att["residual_fraction"]) <= 1 - ATTRIBUTION_BAR
          and att["steps"] == OBS_TRAIN_STEPS,
          f"attribution: {json.dumps(att)}")
    missing = {"loader_wait", "compile", "dispatch", "validate",
               "checkpoint"} - set(att["buckets"])
    check(not missing, f"attribution: buckets {sorted(missing)} missing")
    ledger_rows = [e for e in events if e["kind"] == "cost_ledger"]
    check([(e["fn"], e["bucket"], e["source"]) for e in ledger_rows]
          == [("train_step", batch, "flop_counter")],
          f"the run's cost ledger rows: {ledger_rows}")
    ledger = CostLedger(registry=MetricsRegistry(), device=DEVICE)
    (fwd,) = costmodel.ladder_entries(ledger, cfg, buckets=(batch,))
    analytic = costmodel.analytic_flops(cfg, batch)
    check(ledger.peak.source == "table" and ledger.peak.flops_per_s,
          f"peak row: {ledger.peak}")
    check(fwd.source == "flop_counter"
          and abs(fwd.flops - analytic) / analytic <= FLOP_BAND,
          f"forward: FLOP counter {fwd.flops} vs analytic {analytic}")
    train_flops = costmodel.analytic_train_flops(cfg, batch)
    mfu = {}
    for label, run in (("plain", plain), ("profiled", prof)):
        step_s = run["attribution"]["wall_s"] / OBS_TRAIN_STEPS
        mfu[label] = train_flops / step_s / ledger.peak.flops_per_s
    check(0 < mfu["plain"] <= 1, f"MFU {mfu['plain']} outside (0, 1]")
    span_us = span_cost_us()
    # two spans (validate, checkpoint_save) per validation interval
    span_share = 2 * span_us["bridge"] / (
        TRAIN_RUN["validation_interval"] * 1e6
        * plain["attribution"]["wall_s"] / OBS_TRAIN_STEPS)
    out = {"span_us": span_us, "span_share_of_steps": span_share,
        "launches": prof["launches"], "trace_kernel_events": kernels,
        "trace_read_s": trace_read_s,
        "trace_window": {k: tr[k] for k in (
            "start_margin_us", "end_margin_us", "min_launch_gap_us")}
        | {"orphan_launches": len(tr["orphans"])},
        "attribution": att, "attribution_unprofiled": plain["attribution"],
        "samples_per_sec": {"profile_off": plain["samples_per_sec"],
                            "profile_on": prof["samples_per_sec"]},
        "step_ms": {k: 1e3 * r["attribution"]["wall_s"] / OBS_TRAIN_STEPS
                    for k, r in (("profile_off", plain),
                                 ("profile_on", prof))},
        "forward_flops": fwd.flops, "analytic_forward_flops": analytic,
        "forward_hbm_peak_bytes": fwd.hbm_peak_bytes,
        "train_row": ledger_rows[0], "analytic_train_flops": train_flops,
        "peak": ledger.peak.to_dict(), "mfu": mfu,
        "attribution_roofline": att.get("roofline")}
    print("profiled training: " + json.dumps(out), flush=True)
    return out


class ForwardCount:
    """Every engine forward in the process (warm-ups included), counted at
    ``InferenceEngine._run_forward``: a campaign's killed replica takes its
    own count with it, so the fleet's stats cannot give the total."""

    n = 0
    _lock = threading.Lock()

    @classmethod
    @contextlib.contextmanager
    def counting(cls):
        from deepgo_tpu_torch.serving.engine import InferenceEngine

        run_forward = InferenceEngine._run_forward

        def counted(self, *args, **kwargs):
            with cls._lock:
                cls.n += 1
            return run_forward(self, *args, **kwargs)

        cls.n = 0
        InferenceEngine._run_forward = counted
        try:
            yield cls
        finally:
            InferenceEngine._run_forward = run_forward


def chaos_campaign(model, cfg, label, scenario, defended: bool,
                   canary: bool, trace, cache=None,
                   reload_params=None) -> dict:
    """One campaign on a fresh two-replica fleet; the launch counts are
    zeroed just before it. ``interactive`` is the replayed interactive
    requests' latency at the router (the ground-truth pass left out)."""
    from deepgo_tpu_torch.chaos import (CampaignConfig, CampaignRunner,
                                        defended_config)

    base = FleetConfig(**CHAOS_FLEET)
    fleet = fleet_policy_engine(
        model, cfg, replicas=2, config=EngineConfig(**CHAOS_ENGINE),
        fleet=defended_config(base) if defended else base,
        supervisor=SupervisorConfig(**CHAOS_SUPERVISOR), cache=cache,
        device=DEVICE, name=label)
    closed = False
    try:
        fleet.warmup()
        runner = CampaignRunner(fleet, trace, scenario,
                                CampaignConfig(canary=canary, **CHAOS_SLO),
                                reload_params=reload_params)
        ground_truth, marks = runner.ground_truth, {}

        def marked():
            out = ground_truth()
            marks["n"] = len(fleet._tier_lat["interactive"])
            return out

        runner.ground_truth = marked
        with ForwardCount.counting() as count:
            cuda_expand.reset_launches()
            t0 = time.perf_counter()
            report = runner.run()
            seconds = time.perf_counter() - t0
            lat = 1e3 * np.array(
                list(fleet._tier_lat["interactive"])[marks["n"]:])
            # a hedge's losing duplicate may still be in its forward when
            # the run returns (counted, not yet launched): count once the
            # fleet has drained and closed
            fleet.close()
            closed = True
            launches = cuda_expand.launches
            forwards = count.n
    finally:
        if not closed:
            fleet.close()
        faults.reset()
    interactive = {"requests": int(lat.size),
                   "p50_ms": float(np.percentile(lat, 50)),
                   "p99_ms": float(np.percentile(lat, 99))} if lat.size \
        else {"requests": 0}
    return {"report": report, "launches": launches, "forwards": forwards,
            "seconds": seconds, "interactive": interactive,
            "slo": report["slo"], "grade": report["grade"]}


def check_answers(run: dict, label: str) -> None:
    answers = run["report"]["answers"]
    check(answers["lost"] == 0, f"{label}: {answers['lost']} futures lost")
    check(answers["wrong"] == 0, f"{label}: {answers['wrong']} wrong "
          f"answers returned: {answers['wrong_detail']}")
    check(run["launches"] == run["forwards"] > 0,
          f"{label}: expansion launches {run['launches']} != fleet "
          f"forwards {run['forwards']}")


def phase_chaos(model) -> dict:
    """12b: the acceptance campaign (brownout, kill, corrupt) over phase
    9f's trace on a defended two-replica fleet with the lock-order
    sanitizer armed; the brownout campaign undefended and defended; and a
    cached fleet through a mid-trace reload and a kill. The campaigns'
    ground-truth pass evaluates every trace position first, so on a cached
    fleet every replayed request would be a hit and no fault would reach a
    caller's path: the attack legs run uncached, as the JAX package's
    chaos bench runs them, and the cache gets the leg whose reload
    invalidates it."""
    from deepgo_tpu_torch.analysis import lockcheck
    from deepgo_tpu_torch.chaos import (FaultEvent, Scenario,
                                        acceptance_scenario,
                                        brownout_scenario)

    cfg = policy_cnn.CONFIGS["full"]
    trace = build_synthetic_requests(SGF_DIR, requests=REPLAY_REQUESTS,
                                     seed=SEED)
    span = trace[-1]["t"] - trace[0]["t"]
    flight_dir = tempfile.mkdtemp(prefix="chip-smoke-chaos-")
    rec = configure_flight(flight_dir)
    try:
        lockcheck.enable(True)
        lockcheck.reset()
        try:
            acc = chaos_campaign(model, cfg, "chaos-accept",
                                 acceptance_scenario(span), True, True,
                                 trace)
            locks = lockcheck.report()
        finally:
            lockcheck.enable(None)
            lockcheck.reset()
        rep = acc["report"]
        check_answers(acc, "chaos acceptance")
        check(bool((rep["canary"] or {}).get("detected")),
              f"chaos: corruption never canary-detected: {rep['canary']}")
        check(locks["cycles"] == [], f"lock-order inversions: "
              f"{locks['cycles']}")
        ab = {arm: chaos_campaign(model, cfg, f"chaos-{arm}",
                                  brownout_scenario(span), arm == "on",
                                  False, trace)
              for arm in ("off", "on")}
        for arm, run in ab.items():
            check_answers(run, f"brownout {arm}")
        cached = chaos_campaign(
            model, cfg, "chaos-cache", Scenario(
                name="cache-reload-kill", seed=17, events=(
                    FaultEvent(at_s=0.35 * span, kind="reload"),
                    FaultEvent(at_s=0.55 * span, kind="kill", replica=0))),
            True, False, trace, cache=CacheConfig(), reload_params=model)
        check_answers(cached, "cache leg")
        cache_block = cached["report"]["cache"]
        check(cache_block["stale_hits"] == 0
              and cache_block["invalidations"] >= 1
              and all(r["ok"] for r in cached["report"]["reloads"]),
              f"cache leg: {cache_block}, reloads "
              f"{cached['report']['reloads']}")
    finally:
        dumps = len(rec.dumps)
        rec.close()
        shutil.rmtree(flight_dir, ignore_errors=True)

    def brief(run):
        return {"slo": run["slo"], "interactive": run["interactive"],
                "launches": run["launches"], "seconds": run["seconds"],
                "counters": run["report"]["counters"],
                "answers": {k: run["report"]["answers"][k]
                            for k in ("checked", "wrong", "lost")}}

    out = {"launches": sum(r["launches"] for r in
                           (acc, *ab.values(), cached)),
           "acceptance": brief(acc) | {
               "canary": rep["canary"], "executed": rep["executed"],
               "grade": acc["grade"]},
           "flight_dumps": dumps,
           "locks": {"tracked": len(locks["locks"]),
                     "edges": sum(len(v) for v in locks["edges"].values()),
                     "cycles": len(locks["cycles"]),
                     "hazards": locks["hazards"]},
           "brownout_ab": {arm: brief(run) for arm, run in ab.items()},
           "cache_leg": brief(cached) | {"cache": cache_block}}
    print("chaos: " + json.dumps(out), flush=True)
    return out


def phase_sanitizers(model) -> dict:
    """12c: a ``full`` engine with the runtime sanitizer armed: mixed-size
    submits after warm-up find no new signature and no guard hit; a
    deliberately unstaged input is caught."""
    from deepgo_tpu_torch.analysis import cudacheck

    cfg = policy_cnn.CONFIGS["full"]
    cudacheck.enable(True)
    cudacheck.reset()
    try:
        engine = policy_engine(model, cfg, config=EngineConfig(
            max_wait_ms=2.0), device=DEVICE, name="sanitized")
        try:
            engine.warmup()
            gen = np.random.default_rng(SEED + 12)
            cuda_expand.reset_launches()
            before = engine.stats()["forwards"]
            for n in SANITIZER_BURSTS:
                packed, player, rank = random_records(gen, n)
                futures = [engine.submit(packed[i], int(player[i]),
                                         int(rank[i])) for i in range(n)]
                for f in futures:
                    check(bool(np.isfinite(f.result()).all()),
                          "sanitized engine: finite rows")
            launches = cuda_expand.launches
            forwards = engine.stats()["forwards"] - before
            clean = cudacheck.report()
        finally:
            engine.close()
        check(launches == forwards > 0, f"sanitized engine: launches "
              f"{launches} != forwards {forwards}")
        check(clean["steady_state_compiles"] == 0 and clean["storms"] == []
              and clean["transfers"] == [],
              f"sanitizer findings after warm-up: {json.dumps(clean)}")
        forward = make_log_prob_fn(cfg, device=DEVICE)
        packed, player, rank = random_records(gen, 8)
        staged = cudacheck.stage_h2d(packed, player, rank, device=DEVICE)
        caught = []
        for name, inputs, args in (
                ("planted-sync", (), (packed, *staged[1:])),
                ("planted-input", (packed, *staged[1:]), staged)):
            try:
                with cudacheck.transfer_guard(name, device=DEVICE,
                                              inputs=inputs):
                    forward(model, *args)
            except RuntimeError as e:
                caught.append((name, type(e).__name__, str(e)[:120]))
        planted = cudacheck.report()["transfers"]
        check(torch.cuda.get_sync_debug_mode() == 0,
              "the sync check is off again after the guards")
    finally:
        cudacheck.enable(None)
        cudacheck.reset()
    check([c[0] for c in caught] == ["planted-sync", "planted-input"]
          and [p["tag"] for p in planted] == ["planted-sync",
                                              "planted-input"],
          f"planted unstaged inputs: caught {caught}, recorded {planted}")
    out = {"launches": launches, "forwards": forwards,
           "watched": clean["watched"], "caught": caught}
    print("sanitizers: " + json.dumps(out), flush=True)
    return out


def phase_telemetry(model) -> dict:
    """12d: phase 10a's loop with ``telemetry=True``; the dash renders its
    store once."""
    from deepgo_tpu_torch.obs.dash import collect_dash, render_dash

    with tempfile.TemporaryDirectory(prefix="chip-smoke-telemetry-") as tmp:
        loop = phase_loop(model, tmp, telemetry=True)
        frame = collect_dash(os.path.join(tmp, "loop"))
        text = render_dash(frame)
    check(frame["mode"] == "store" and frame["samples"] >= 2
          and bool(frame["watchlist"]),
          f"dash: {frame['samples']} samples, watchlist "
          f"{sorted(frame['watchlist'])}")
    print("dash --json: " + json.dumps(frame), flush=True)
    print(text, flush=True)
    return {"loop": loop, "samples": frame["samples"],
            "watchlist": sorted(frame["watchlist"]),
            "anomaly_totals": frame["anomaly_totals"]}


def phase_observability() -> dict:
    """Phase 12: observability and chaos on the card."""
    t0 = time.perf_counter()
    model = fresh_model()
    out = {"profiled_training": phase_profiled_training()}
    t = {"12a": time.perf_counter() - t0}
    out["chaos"] = phase_chaos(model)
    t["12b"] = time.perf_counter() - t0 - sum(t.values())
    out["sanitizers"] = phase_sanitizers(model)
    t["12c"] = time.perf_counter() - t0 - sum(t.values())
    out["telemetry"] = phase_telemetry(model)
    t["12d"] = time.perf_counter() - t0 - sum(t.values())
    out["seconds"] = time.perf_counter() - t0
    out["sub_seconds"] = t
    print(f"phase 12: {out['seconds']:.2f} s " + json.dumps(t), flush=True)
    return out


# Phase 13, the command line on the card: the entry points a user types,
# called in-process through ``cli.main`` (so that the launch counts can be
# read), at ``full`` on the card.
# one step a call, so that the scraped step counter moves 30 times
CLI_TRAIN = {**TRAIN_RUN, "name": "chip-smoke-cli", "steps_per_call": 1}
CLI_TRAIN_STEPS, CLI_RESUME_STEPS = 30, 40
CLI_SERVE_S = 8.0
CLI_SELFPLAY = ("--model", "full", "--fleet", "2", "--games", "8",
                "--max-moves", "60")
CLI_LOOP = ("--windows", "1", "--actors", "1", "--fleet", "2",
            "--games-per-round", "8", "--max-moves", "60",
            "--window-steps", "20", "--min-positions", "512",
            "--gate-games", "8", "--gate-threshold", "0.0",
            "--stall-timeout", "300", "--seed", str(SEED))
SCRAPE_INTERVAL_S = 0.01
LOCALTEST_TIMEOUT_S = 300


def cli_sets(config: dict) -> list:
    """``--set`` pairs of an ExperimentConfig dict."""
    return [f"{k}={str(v).lower() if isinstance(v, bool) else v}"
            for k, v in config.items()]


def run_main(main, argv: list, label: str) -> str:
    """``main(argv)`` in this process; its standard output, echoed. A
    ``SystemExit`` other than 0 fails the run."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    except SystemExit as e:
        check(e.code in (0, None), f"{label} exited {e.code}: "
              f"{out.getvalue()[-2000:]}")
    text = out.getvalue()
    for line in text.splitlines()[-12:]:
        print(f"  {label}| {line[:400]}", flush=True)
    return text


def run_cli(argv: list) -> str:
    """``cli.main(argv)`` in this process; its standard output, echoed."""
    from deepgo_tpu_torch import cli

    return run_main(cli.main, argv, f"cli {argv[0]}")


class Scraper:
    """Polls an exporter's ``/metrics`` and ``/healthz`` on a thread while a
    command runs: the samples of one metric, the health codes seen and the
    first bodies of unhealthy answers (for the failure message)."""

    def __init__(self, port: int, metric: str):
        self.url = f"http://127.0.0.1:{port}"
        self.metric = metric
        self.values, self.codes, self.unhealthy = [], [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chip-smoke-scraper")

    def _get(self, route: str) -> tuple:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.url + route, timeout=5) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def _run(self) -> None:
        from deepgo_tpu_torch.obs import parse_prometheus

        while not self._stop.is_set():
            try:
                _, text = self._get("/metrics")
                value = parse_prometheus(text).get(self.metric)
                if value is not None:
                    self.values.append(value)
                code, body = self._get("/healthz")
                self.codes.append(code)
                if code != 200 and len(self.unhealthy) < 3:
                    self.unhealthy.append(body[:3000])
            except OSError:
                pass  # not up yet, or already closed
            self._stop.wait(SCRAPE_INTERVAL_S)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)


def counter_total(name: str, **labels) -> float:
    """The process-wide registry's counter ``name`` summed over the series
    whose labels include ``labels``."""
    from deepgo_tpu_torch.obs import get_registry

    total = 0.0
    for key, value in get_registry().counter(name).collect().items():
        if set(labels.items()) <= set(key):
            total += value
    return total


def cli_train_path(root: str) -> dict:
    """13a: ``train`` with ``--obs-port`` while a thread scrapes it, ``eval``
    of its checkpoint, ``train --auto-resume`` of its run directory."""
    sets = cli_sets({**CLI_TRAIN, "data_root": root,
                     "run_dir": os.path.join(root, "runs")})
    port = free_port()
    steps0 = counter_total("deepgo_train_steps_total")
    cuda_expand.reset_launches()
    t0 = time.perf_counter()
    with Scraper(port, "deepgo_train_steps_total") as scrape:
        text = run_cli(["train", "--iters", str(CLI_TRAIN_STEPS),
                        "--obs-port", str(port), "--device", DEVICE,
                        "--set", *sets])
    train_s = time.perf_counter() - t0
    launches, sym = cuda_expand.launches, cuda_expand.sym_launches
    path = re.search(r"checkpoint at (\S+)", text).group(1)
    evals = math.ceil(CLI_TRAIN["validation_size"] / CLI_TRAIN["batch_size"])
    check(launches == CLI_TRAIN_STEPS + evals and sym == 0,
          f"cli train: expansion launches {launches} != {CLI_TRAIN_STEPS} "
          f"steps + {evals} eval batches, or sym launches {sym}")
    rising = [v - steps0 for v in scrape.values]
    check(len(set(rising)) >= 2 and rising == sorted(rising)
          and 0 < rising[-1] <= CLI_TRAIN_STEPS,
          f"cli train: /metrics deepgo_train_steps_total rising, saw "
          f"{rising}")
    check(counter_total("deepgo_train_steps_total") - steps0
          == CLI_TRAIN_STEPS, "cli train: the step counter counts the run")
    check(scrape.codes and set(scrape.codes) == {200},
          f"cli train: /healthz codes {sorted(set(scrape.codes))}: "
          f"{scrape.unhealthy}")

    cuda_expand.reset_launches()
    text = run_cli(["eval", "--checkpoint", path, "--split", "validation",
                    "--device", DEVICE])
    eval_launches, eval_sym = cuda_expand.launches, cuda_expand.sym_launches
    m = re.search(r"validation: cost=(\S+) accuracy=(\S+) n=(\d+)", text)
    n = int(m.group(3))
    check(math.isfinite(float(m.group(1))) and n > 0, f"cli eval: {text}")
    check(eval_launches == math.ceil(n / CLI_TRAIN["batch_size"])
          and eval_sym == 0, f"cli eval: expansion launches {eval_launches}"
          f" for {n} positions at B = {CLI_TRAIN['batch_size']}")

    cuda_expand.reset_launches()
    text = run_cli(["train", "--iters", str(CLI_RESUME_STEPS),
                    "--auto-resume", os.path.dirname(path), "--device",
                    DEVICE, "--set", *sets])
    resume_launches = cuda_expand.launches
    check(f"at step {CLI_TRAIN_STEPS}" in text.splitlines()[0]
          and text.startswith("auto-resumed"),
          f"cli train --auto-resume resumes at {CLI_TRAIN_STEPS}: {text}")
    final = re.search(r"checkpoint at (\S+)", text).group(1)
    check(ckpt.load_meta(final)["step"] == CLI_RESUME_STEPS,
          f"cli train --auto-resume ends at {CLI_RESUME_STEPS}")
    check(resume_launches == CLI_RESUME_STEPS - CLI_TRAIN_STEPS
          and cuda_expand.sym_launches == 0,
          f"cli train --auto-resume: launches {resume_launches}")
    return {"launches": {"cli_train": launches, "cli_eval": eval_launches,
                         "cli_resume": resume_launches},
            "train_s": train_s, "scraped_steps": rising,
            "healthz_scrapes": len(scrape.codes),
            "eval": {"cost": float(m.group(1)),
                     "accuracy": float(m.group(2)), "n": n}}


def cli_serve_path(grid, tmp: str) -> dict:
    """13b: ``serve`` of the grid net as an f32 and an int8+sym replica,
    with ``--obs-port`` scraped and a checkpoint published at ``--watch``
    once the exporter answers."""
    import deepgo_tpu_torch.serving as serving_mod

    source = os.path.join(tmp, "grid.npz")
    target = os.path.join(tmp, "champion.npz")
    save_seed_checkpoint(grid, source)
    port = free_port()
    fleets = []
    build = serving_mod.fleet_policy_engine

    def capture(*args, **kwargs):
        fleets.append(build(*args, **kwargs))
        return fleets[-1]

    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    reloads0 = counter_total("deepgo_fleet_reloads_total",
                             fleet="policy-fleet")
    published = threading.Event()

    def publish() -> None:
        # the reload target: the grid net's checkpoint, written again
        # under the watched name atomically once the daemon serves
        while not scrape.codes and not published.is_set():
            time.sleep(SCRAPE_INTERVAL_S)
        shutil.copyfile(source, target + ".tmp")
        os.replace(target + ".tmp", target)
        published.set()

    serving_mod.fleet_policy_engine = capture
    cuda_expand.reset_launches()
    t0 = time.perf_counter()
    try:
        with Scraper(port, "deepgo_fleet_reloads_total") as scrape:
            publisher = threading.Thread(target=publish, daemon=True,
                                         name="chip-smoke-publish")
            publisher.start()
            text = run_cli(["serve", "--fleet", "2", "--variant",
                            "f32,int8+sym", "--checkpoint", source,
                            "--obs-port", str(port), "--watch", target,
                            "--watch-interval", "0.5", "--duration",
                            str(CLI_SERVE_S), "--device", DEVICE])
            published.set()
            publisher.join(timeout=30)
    finally:
        serving_mod.fleet_policy_engine = build
    serve_s = time.perf_counter() - t0
    launches, sym = cuda_expand.launches, cuda_expand.sym_launches
    check({s: signal.getsignal(s) for s in handlers} == handlers,
          "cli serve: SIGINT and SIGTERM handlers restored")
    check(len(fleets) == 1, "cli serve built one fleet")
    fleet = fleets[0]
    check([r.engine.variant for r in fleet._replicas] == ["f32", "int8+sym"],
          "cli serve: replica variants f32, int8+sym")
    forwards = replica_forwards(fleet.stats())
    gate = sum(2 * math.ceil(quant.ToleranceConfig().boards / b)
               for b in fleet.ladder.buckets)
    check(f"hot-reloaded {target}" in text and "1 reloads" in text,
          f"cli serve: one hot reload of {target}")
    check(counter_total("deepgo_fleet_reloads_total", fleet="policy-fleet")
          - reloads0 == 1, "cli serve: deepgo_fleet_reloads_total += 1")
    check(scrape.codes and set(scrape.codes) == {200},
          f"cli serve: /healthz codes {sorted(set(scrape.codes))}: "
          f"{scrape.unhealthy}")
    check(launches == forwards[0] and sym == gate + forwards[1]
          and min(forwards) >= len(fleet.ladder.buckets),
          f"cli serve: expansion launches {launches} != the f32 replica's "
          f"forwards {forwards[0]}, or sym launches {sym} != the gate's "
          f"{gate} + the int8+sym replica's {forwards[1]}")
    return {"launches": {"cli_serve": launches},
            "sym_launches": {"cli_serve_gate": sym - forwards[1],
                             "cli_serve_int8_sym": forwards[1]},
            "replica_forwards": forwards, "serve_s": serve_s,
            "healthz_scrapes": len(scrape.codes),
            "reload_line": next(line for line in text.splitlines()
                                if "hot-reloaded" in line)}


def cli_selfplay_path(tmp: str) -> dict:
    """13c: ``selfplay`` through a two-replica fleet, forwarded to the
    port's selfplay command line."""
    out_dir = os.path.join(tmp, "selfplay")
    cuda_expand.reset_launches()
    t0 = time.perf_counter()
    with ForwardCount.counting() as count:
        text = run_cli(["selfplay", *CLI_SELFPLAY, "--sgf-out", out_dir,
                        "--device", DEVICE])
    seconds = time.perf_counter() - t0
    launches, sym = cuda_expand.launches, cuda_expand.sym_launches
    forwards = count.n
    games = sorted(f for f in os.listdir(out_dir) if f.endswith(".sgf"))
    check(len(games) == 8, f"cli selfplay: {len(games)} SGFs")
    for name in games:
        check(transcribe_game(os.path.join(out_dir, name)) is not None,
              f"cli selfplay: {name} transcribes")
    check(launches == forwards > 0 and sym == 0,
          f"cli selfplay: expansion launches {launches} != engine forwards "
          f"{forwards}, or sym launches {sym}")
    return {"launches": {"cli_selfplay": launches}, "forwards": forwards,
            "seconds": seconds, "stats": text.splitlines()[0][:400]}


def cli_cost_path() -> dict:
    """13d: ``cost --model full --json``: every entry priced once on the
    card, the ladder's FLOP count equal to the analytic one, the card's
    table peak."""
    from deepgo_tpu_torch.obs import costmodel

    cfg = policy_cnn.CONFIGS["full"]
    memo = len(costmodel._train_memo)
    cuda_expand.reset_launches()
    t0 = time.perf_counter()
    block = json.loads(run_cli(["cost", "--model", "full", "--json",
                                "--device", DEVICE]))
    seconds = time.perf_counter() - t0
    launches, sym = cuda_expand.launches, cuda_expand.sym_launches
    entries, peak = block["entries"], block["peak"]
    ladder = BucketLadder().buckets
    # a card forward convolves at least CARD_MIN_ROWS rows (ROADMAP C11)
    check(all(entries[f"policy_forward/b{b}"]["flops"]
              == costmodel.analytic_flops(cfg, conv_rows(b, DEVICE))
              for b in ladder),
          "cli cost: the ladder's FLOP count == analytic_flops of the rows "
          "convolved")
    check(all(e["source"] == "flop_counter" for e in entries.values()),
          "cli cost: every row from the FLOP counter")
    check(peak["flops_per_s"] == 989e12 and peak["source"] == "table",
          f"cli cost: peak {peak}")
    trained = len(costmodel._train_memo) - memo  # 0 when memoized earlier
    want_expand = 2 * len(ladder) + trained + 1  # f32 + int8 ladders, steps
    check(launches == want_expand and sym == 3,
          f"cli cost: expansion launches {launches} != {want_expand} "
          f"priced entries, or sym launches {sym} != 3 ensembles")
    return {"launches": {"cli_cost": launches},
            "sym_launches": {"cli_cost": sym}, "seconds": seconds,
            "entries": {k: {"flops": e["flops"], "hbm_peak": e["hbm_peak"]}
                        for k, e in entries.items()}, "peak": peak}


def cli_lint_path() -> dict:
    """13e: ``lint`` over the checkout: exit 0, no finding."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    text = run_cli(["lint", "--root", root])
    check("lint: 0 finding(s), 0 warning(s)" in text, f"cli lint: {text}")
    return {"seconds": time.perf_counter() - t0,
            "report": text.strip().splitlines()[-1]}


def cli_loop_path(model, tmp: str) -> dict:
    """13f: ``loop --windows 1 --actors 1`` on ``full`` from phase 4's
    weights: every acked game durable."""
    seed = os.path.join(tmp, "loop-seed.npz")
    save_seed_checkpoint(model, seed)
    GateDirectAgent.forwards = 0
    loop_gatekeeper.PolicyAgent = GateDirectAgent
    cuda_expand.reset_launches()
    t0 = time.perf_counter()
    try:
        with ForwardCount.counting() as count:
            text = run_cli(["loop", "--run-dir", os.path.join(tmp, "loop"),
                            "--checkpoint", seed, *CLI_LOOP, "--device",
                            DEVICE, "--set", *cli_sets(LOOP_LEARNER)])
    finally:
        loop_gatekeeper.PolicyAgent = agents.PolicyAgent
    seconds = time.perf_counter() - t0
    launches, sym = cuda_expand.launches, cuda_expand.sym_launches
    summary = json.loads(text.strip().splitlines()[-1])
    by_path = {"cli_loop_fleet": count.n,
               "cli_loop_learner": summary["learner_step"],
               "cli_loop_gate_direct": GateDirectAgent.forwards}
    check(summary["windows_trained"] == 1 and summary["fatal"] == {},
          f"cli loop: {summary['windows_trained']} windows, fatal "
          f"{summary['fatal']}")
    check(summary["games_acked"] == summary["games_durable"] > 0,
          f"cli loop: acked {summary['games_acked']} != durable "
          f"{summary['games_durable']}")
    check(launches == sum(by_path.values()) and sym == 0
          and min(by_path.values()) > 0,
          f"cli loop: expansion launches {launches} != {by_path}, or sym "
          f"launches {sym}")
    return {"launches": by_path, "seconds": seconds,
            "games_acked": summary["games_acked"],
            "games_durable": summary["games_durable"]}


def cli_entry_path() -> dict:
    """13g: ``graft_entry.entry()`` on the card: its planes bitwise the
    plain expansion's, its bf16 log-probs within the bar of the card's
    float32 forward of the same weights, more boards drawn until 32 rows
    clear the margin gate."""
    from deepgo_tpu_torch import graft_entry

    cuda_expand.reset_launches()
    fn, args = graft_entry.entry(DEVICE)
    model, packed, player, rank = args
    with torch.no_grad():
        got = fn(*args)
        calls = 1
        check(tuple(got.shape) == (graft_entry.ENTRY_BATCH, 361)
              and got.device.type == DEVICE
              and bool(torch.isfinite(got).all()), "entry: finite rows")
        f32 = cpu_copy(model, dataclasses.replace(
            model.cfg, compute_dtype="float32")).to(DEVICE)
        rng = np.random.default_rng(SEED + 13)
        gots, refs = [got], []
        boards = [(packed, player, rank)]
        while True:
            x, y, z = boards[-1]
            refs.append(policy_cnn.log_policy(f32, plain_expand.expand_planes(
                x, y, z, dtype=torch.float32)))
            ref = torch.cat(refs).cpu().numpy()
            top2 = np.sort(ref, axis=1)[:, -2:]
            decided = top2[:, 1] - top2[:, 0] >= 0.05
            if decided.sum() >= 32:
                break
            more = tuple(torch.from_numpy(a).to(DEVICE)
                         for a in random_records(rng, graft_entry.ENTRY_BATCH))
            boards.append(more)
            gots.append(fn(model, *more))
            calls += 1
        launches, sym = cuda_expand.launches, cuda_expand.sym_launches
        mine = torch.cat(gots).cpu().numpy()
        # after the counts were read: the comparison is no launch of the path
        check(torch.equal(expand_planes(packed, player, rank),
                          plain_expand.expand_planes(packed, player, rank)),
              "entry: the kernel's planes bitwise the plain expansion's")
    check(launches == calls and sym == 0, f"entry: expansion launches "
          f"{launches} != {calls} calls of its forward, or sym {sym}")
    drift = float(np.abs(mine - ref)[np.exp(ref) >= 1e-3].max())
    top1 = bool(np.array_equal(mine.argmax(1)[decided],
                               ref.argmax(1)[decided]))
    check(drift <= 0.5 and top1, f"entry: bf16 drift {drift} or top-1 "
          f"on {int(decided.sum())} decided rows against the card's f32")
    return {"launches": {"entry": launches}, "drift": drift,
            "decided_rows": int(decided.sum()), "boards": len(mine)}


def cli_localtest_path() -> dict:
    """13h: ``python3 -m deepgo_tpu_torch.cli localtest --device cuda`` as
    a user runs it, in a process of its own, on the bundled data/sgf
    splits transcribed into a temporary directory."""
    from deepgo_tpu_torch.data.transcribe import transcribe_split

    with tempfile.TemporaryDirectory(prefix="chip-smoke-localtest-") as tmp:
        for split in ("validation", "test"):
            transcribe_split(os.path.join(SGF_DIR, split),
                             os.path.join(tmp, split), workers=1,
                             verbose=False)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "deepgo_tpu_torch.cli", "localtest",
             "--device", DEVICE, "--set", f"data_root={tmp}",
             f"run_dir={os.path.join(tmp, 'runs')}",
             "train_split=validation", "validation_split=test",
             "test_split=test"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=LOCALTEST_TIMEOUT_S)
        seconds = time.perf_counter() - t0
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
        else ""
    check(proc.returncode == 0 and last.startswith("localtest done"),
          f"cli localtest exited {proc.returncode}: {last} "
          f"{proc.stderr[-2000:]}")
    return {"seconds": seconds, "last_line": last}


def phase_command_line(model, grid) -> dict:
    """Phase 13: the command line on the card, each sub-path with the
    launch counts zeroed just before it and read just after."""
    t0 = time.perf_counter()
    out, t = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
        root = os.path.join(tmp, "data")
        write_split(root)
        for key, fn in (("train", lambda: cli_train_path(root)),
                        ("serve", lambda: cli_serve_path(grid, tmp)),
                        ("selfplay", lambda: cli_selfplay_path(tmp)),
                        ("cost", cli_cost_path), ("lint", cli_lint_path),
                        ("loop", lambda: cli_loop_path(model, tmp)),
                        ("entry", cli_entry_path),
                        ("localtest", cli_localtest_path)):
            s = time.perf_counter()
            out[key] = fn()
            t[key] = time.perf_counter() - s
            print(f"cli {key}: " + json.dumps(out[key], default=str)[:3000],
                  flush=True)
    out["seconds"] = time.perf_counter() - t0
    out["sub_seconds"] = t
    print(f"phase 13: {out['seconds']:.2f} s " + json.dumps(t), flush=True)
    return out


# Phase 14, the tools on the card: each module of deepgo_tpu_torch/tools
# through its ``main(argv)`` as a user types it, at ``full`` on the card.
# Only depth is cut: positions, steps and games.
TOOLS_CORPUS = ("--positions", "20000", "--chunk", "256", "--max-moves",
                "200", "--opening-plies", "8")
TOOLS_NET = ("num_layers=12", "channels=128", "batch_size=256")
TOOLS_ITERS = 300
TOOLS_SMALL_BUDGET = 4000
TOOLS_LOSS_RATIO = 0.7    # final EWMA over the first window's, at most
TOOLS_TOP1_GAIN = 0.05    # trained test top-1 over the untrained net's
TOOLS_SYM_BATCH = 512
TOOLS_SYM_LIMIT = 16384   # train positions swept for boards/s
TOOLS_CPU_TOP1_TOL = 0.01  # the card's bf16 vs the CPU's float32 top-1
TOOLS_SELFPLAY = ("--games", "128", "--chunk", "64", "--opening-plies", "4",
                  "--max-moves", "200")
TOOLS_TWOPLY_GAMES = 4
TOOLS_FEED_ITERS, TOOLS_FEED_WINDOW = 100, 20
TOOLS_SPLITS = ("train", "validation", "test")


def tool_lines(text: str, key: str) -> list:
    """The JSON objects among a tool's output lines that carry ``key``."""
    out = []
    for line in text.splitlines():
        if line.startswith("{\""):
            record = json.loads(line)
            if key in record:
                out.append(record)
    return out


def printed_dict(text: str, first_key: str) -> dict:
    """The ``print(dict)`` line of a tool's output whose first key is
    ``first_key``."""
    prefix = "{" + repr(first_key) + ":"
    return ast.literal_eval(next(line for line in text.splitlines()
                                 if line.startswith(prefix)))


def split_sizes(root: str) -> dict:
    return {s: len(GoDataset(root, s)) for s in TOOLS_SPLITS}


@contextlib.contextmanager
def counted_policy_forwards():
    """Counts the forwards of every policy agent built inside the block:
    ``agents.PolicyAgent`` makes its forward with
    ``models.serving.make_policy_fn`` when it is built."""
    from deepgo_tpu_torch.models import serving as serving_mod

    make = serving_mod.make_policy_fn
    count = [0]

    def counting(*args, **kwargs):
        fn = make(*args, **kwargs)

        def predict(*a):
            count[0] += 1
            return fn(*a)

        predict.device = fn.device
        return predict

    serving_mod.make_policy_fn = counting
    try:
        yield count
    finally:
        serving_mod.make_policy_fn = make


def priced_steps() -> int:
    """Train steps the cost ledger has priced in this process: an
    Experiment prices its step (one launch) the first time it meets it."""
    from deepgo_tpu_torch.obs import costmodel

    return len(costmodel._train_memo)


def tools_corpus_path(tmp: str) -> dict:
    """14a: ``make_corpus`` with the scripted pool, transcribed."""
    from deepgo_tpu_torch.tools import make_corpus

    out = os.path.join(tmp, "corpus")
    cuda_expand.reset_launches()
    t0 = time.perf_counter()
    text = run_main(make_corpus.main, ["--out", out, *TOOLS_CORPUS,
                                       "--seed", str(SEED), "--device",
                                       DEVICE], "make_corpus")
    seconds = time.perf_counter() - t0
    totals = printed_dict(text, "games")
    sgfs = sum(len(os.listdir(os.path.join(out, "sgf", s)))
               for s in TOOLS_SPLITS)
    check(sgfs == totals["games"] > 0, f"make_corpus: {sgfs} SGF files for "
          f"{totals['games']} games")
    sizes = split_sizes(os.path.join(out, "processed"))
    check(all(sizes.values()), f"make_corpus: an empty split {sizes}")
    check(cuda_expand.launches == cuda_expand.sym_launches == 0,
          "make_corpus: the scripted pool launches no kernel")
    transcribe_s = seconds - totals["gen_seconds"]
    return {"totals": totals, "examples": sizes,
            "gen_positions_per_sec": totals["positions"]
            / totals["gen_seconds"],
            "transcribe_positions_per_sec": sum(sizes.values())
            / transcribe_s, "transcribe_s": transcribe_s, "seconds": seconds}


def tools_curve_path(tmp: str, processed: str) -> dict:
    """14b: ``accuracy_curve`` at two budgets on ``full``, beside the
    untrained net's test top-1."""
    from deepgo_tpu_torch.cli import parse_overrides
    from deepgo_tpu_torch.tools import accuracy_curve

    sizes = split_sizes(processed)
    runs = os.path.join(tmp, "runs")
    sets = [*TOOLS_NET, f"validation_interval={TOOLS_ITERS}",
            f"run_dir={runs}"]
    cfg = ExperimentConfig(data_root=processed, scheme="uniform").replace(
        **parse_overrides(sets))
    priced = priced_steps()
    cuda_expand.reset_launches()
    text = run_main(accuracy_curve.main, [
        "--data-root", processed, "--budgets",
        f"{TOOLS_SMALL_BUDGET},{sizes['train']}", "--iters",
        str(TOOLS_ITERS), "--out", os.path.join(tmp, "curve.jsonl"),
        "--device", DEVICE, "--set", *sets], "accuracy_curve")
    launches, sym = cuda_expand.launches, cuda_expand.sym_launches
    priced = priced_steps() - priced
    points = tool_lines(text, "budget")
    check(len(points) == 2, f"accuracy_curve: {len(points)} points")
    evals = math.ceil(min(cfg.validation_size, sizes["validation"])
                      / cfg.batch_size) + math.ceil(sizes["test"]
                                                    / cfg.batch_size)
    check(launches == 2 * (TOOLS_ITERS + evals) + priced and sym == 0,
          f"accuracy_curve: expansion launches {launches} != 2 x "
          f"({TOOLS_ITERS} steps + {evals} evaluation batches) + {priced} "
          f"priced, or sym launches {sym}")
    for p in points:
        rows = [r for r in read_jsonl(os.path.join(runs, p["run_id"],
                                                   "metrics.jsonl"))
                if r["kind"] == "train"]
        p["first_ewma"] = rows[0]["ewma"]
        check(p["final_ewma"] <= TOOLS_LOSS_RATIO * p["first_ewma"],
              f"accuracy_curve: budget {p['budget']}'s EWMA fell from "
              f"{p['first_ewma']:.4f} to only {p['final_ewma']:.4f}")
    cuda_expand.reset_launches()
    untrained = Experiment(cfg.replace(name="curve-untrained"),
                           device=DEVICE).evaluate()
    untrained_launches = cuda_expand.launches
    check(untrained_launches == math.ceil(sizes["test"] / cfg.batch_size),
          f"untrained evaluate: launches {untrained_launches}")
    top = max(points, key=lambda p: p["budget"])
    check(top["test_top1"] >= untrained["accuracy"] + TOOLS_TOP1_GAIN,
          f"accuracy_curve: trained test top-1 {top['test_top1']:.4f} < "
          f"untrained {untrained['accuracy']:.4f} + {TOOLS_TOP1_GAIN}")
    path = ckpt.find_latest_valid(os.path.join(runs, top["run_id"]))
    check(path is not None and ckpt.load_meta(path)["step"] == TOOLS_ITERS,
          f"accuracy_curve: no checkpoint at step {TOOLS_ITERS}: {path}")
    keep = ("budget", "actual_positions", "test_top1", "test_nll",
            "first_ewma", "final_ewma", "samples_per_sec", "seconds")
    return {"points": [{k: p[k] for k in keep} for p in points],
            "untrained": untrained, "checkpoint": path, "priced": priced,
            "launches": {"tools_accuracy_curve": launches,
                         "tools_untrained_eval": untrained_launches}}


def tools_symmetry_path(path: str, processed: str) -> dict:
    """14c: ``symmetry_eval`` of the trained net on the test split and on
    train positions, and its plain test top-1 in float32 on the CPU."""
    from deepgo_tpu_torch.models.serving import make_policy_fn
    from deepgo_tpu_torch.tools import symmetry_eval

    sizes = split_sizes(processed)
    out = {"launches": {"tools_symmetry_plain": 0},
           "sym_launches": {"tools_symmetry_sym8": 0}}
    for label, extra, n in (
            ("test", ["--split", "test"], sizes["test"]),
            ("train", ["--split", "train", "--limit", str(TOOLS_SYM_LIMIT)],
             min(TOOLS_SYM_LIMIT, sizes["train"]))):
        cuda_expand.reset_launches()
        text = run_main(symmetry_eval.main, [
            "--checkpoint", path, "--data-root", processed, "--batch",
            str(TOOLS_SYM_BATCH), "--device", DEVICE, *extra],
            "symmetry_eval")
        launches, sym = cuda_expand.launches, cuda_expand.sym_launches
        lines = {r["mode"]: r for r in tool_lines(text, "mode")}
        calls = math.ceil(n / TOOLS_SYM_BATCH) + 1  # + the warm-up
        check(launches == sym == calls, f"symmetry_eval {label}: expansion "
              f"launches {launches}, sym launches {sym}, not {calls} each")
        check(lines["plain"]["n"] == lines["sym8"]["n"] == n,
              f"symmetry_eval {label}: {lines['plain']['n']} positions")
        out["launches"]["tools_symmetry_plain"] += launches
        out["sym_launches"]["tools_symmetry_sym8"] += sym
        out[label] = lines
    _, model, cfg = load_policy(path, device="cpu")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    plain = make_policy_fn(cfg32, top_k=1, device="cpu")
    cpu = symmetry_eval.evaluate(
        lambda p, *a: plain(p, *a)["log_probs"], cpu_copy(model, cfg32),
        GoDataset(processed, "test"), TOOLS_SYM_BATCH, 0, label="cpu")
    card = out["test"]["plain"]["top1"]
    check(abs(cpu["top1"] - card) <= TOOLS_CPU_TOP1_TOL,
          f"symmetry_eval: card top-1 {card} vs CPU float32 {cpu['top1']}")
    out["cpu_f32_test"] = cpu
    return out


def tools_selfplay_path(tmp: str, path: str) -> dict:
    """14d: ``make_selfplay_corpus`` of the trained net against ``oneply``
    and itself, transcribed."""
    from deepgo_tpu_torch.tools import make_selfplay_corpus

    out = os.path.join(tmp, "selfplay")
    spec = f"checkpoint:{path}"
    cuda_expand.reset_launches()
    t0 = time.perf_counter()
    with counted_policy_forwards() as forwards:
        text = run_main(make_selfplay_corpus.main, [
            "--out", out, "--pairs", f"{spec},oneply", f"{spec},{spec}",
            *TOOLS_SELFPLAY, "--seed", str(SEED), "--device", DEVICE],
            "make_selfplay_corpus")
    seconds = time.perf_counter() - t0
    launches = cuda_expand.launches
    check(launches == forwards[0] > 0 and cuda_expand.sym_launches == 0,
          f"make_selfplay_corpus: expansion launches {launches} != policy "
          f"forwards {forwards[0]}")
    totals = printed_dict(text, "games")
    sizes = split_sizes(os.path.join(out, "processed"))
    check(all(sizes.values()), f"make_selfplay_corpus: splits {sizes}")
    return {"totals": totals, "examples": sizes, "forwards": forwards[0],
            "positions_per_sec": totals["positions"] / seconds,
            "launches": {"tools_selfplay_corpus": launches}}


def tools_twoply_path(path: str) -> dict:
    """14e: ``debug_twoply`` of the trained net."""
    from deepgo_tpu_torch.tools import debug_twoply

    cuda_expand.reset_launches()
    with counted_policy_forwards() as forwards:
        text = run_main(debug_twoply.main, [
            "--ckpt", path, "--games", str(TOOLS_TWOPLY_GAMES), "--device",
            DEVICE], "debug_twoply")
    launches = cuda_expand.launches
    check(launches == forwards[0] > 0 and cuda_expand.sym_launches == 0,
          f"debug_twoply: expansion launches {launches} != forwards "
          f"{forwards[0]}")
    stats = next(line for line in text.splitlines()
                 if line.startswith("twoply:"))
    return {"stats": stats, "forwards": forwards[0],
            "launches": {"tools_twoply": launches}}


def tools_feed_path(tmp: str, processed: str) -> dict:
    """14f: ``feed_bench`` at the JAX base config; each streamed run's
    launches are read around it."""
    from deepgo_tpu_torch.tools import feed_bench

    measure = feed_bench.streamed_training_rate
    counts = []

    def counted(cfg, iters, device="cuda"):
        priced = priced_steps()
        cuda_expand.reset_launches()
        record = measure(cfg, iters, device=device)
        counts.append((cuda_expand.launches, cuda_expand.sym_launches,
                       priced_steps() - priced))
        return record

    feed_bench.streamed_training_rate = counted
    try:
        text = run_main(feed_bench.main, [
            "--data-root", processed, "--iters", str(TOOLS_FEED_ITERS),
            "--out", os.path.join(tmp, "feed.jsonl"), "--device", DEVICE,
            "--set", f"print_interval={TOOLS_FEED_WINDOW}",
            f"run_dir={os.path.join(tmp, 'runs')}"], "feed_bench")
    finally:
        feed_bench.streamed_training_rate = measure
    records = tool_lines(text, "kind")
    streamed = [r for r in records if r["kind"] == "streamed_training"]
    check(len(records) == 8 and len(streamed) == len(counts) == 4,
          f"feed_bench: {len(records)} records, {len(counts)} streamed runs")
    for r, (launches, sym, priced) in zip(streamed, counts):
        check(launches == TOOLS_FEED_ITERS + priced and sym == 0,
              f"feed_bench {r['wire']} prefetch {r['device_prefetch']}: "
              f"launches {launches} != {TOOLS_FEED_ITERS} steps + {priced} "
              f"priced, sym {sym}")
        check(r["windows"] == TOOLS_FEED_ITERS // TOOLS_FEED_WINDOW - 1,
              f"feed_bench: {r['windows']} steady windows")
    return {"records": records,
            "launches": {"tools_feed": sum(c[0] for c in counts)}}


def tools_notebook_path(tmp: str) -> dict:
    """14g: the port's walkthrough cells with ``DEVICE = "cuda"``, executed
    in order in one namespace, in a directory holding ``data/sgf``."""
    from deepgo_tpu_torch.tools import make_notebook

    work = os.path.join(tmp, "notebook")
    os.makedirs(os.path.join(work, "data"))
    os.symlink(SGF_DIR, os.path.join(work, "data", "sgf"))
    namespace: dict = {}
    out = io.StringIO()
    cuda_expand.reset_launches()
    with contextlib.chdir(work):
        for i, (kind, src) in enumerate(make_notebook.cells(DEVICE)):
            if kind != "code":
                continue
            try:
                with contextlib.redirect_stdout(out):
                    exec(compile(src, f"walkthrough cell {i}", "exec"),
                         namespace)
            except Exception as e:  # noqa: BLE001 — reported as the check
                check(False, f"walkthrough cell {i} raised {e!r}")
    launches = cuda_expand.launches
    check(namespace["DEVICE"] == DEVICE and len(namespace["games"]) == 8
          and math.isfinite(namespace["more"]["final_ewma"]),
          "walkthrough: the cells ran to their games")
    for line in out.getvalue().splitlines()[-6:]:
        print(f"  walkthrough| {line[:400]}", flush=True)
    return {"test": namespace["test"], "launches":
            {"tools_notebook": launches}}


def phase_tools() -> dict:
    """Phase 14: the tools on the card, each sub-path with the launch
    counts zeroed just before it and read just after."""
    t0 = time.perf_counter()
    out, t = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tools-") as tmp:
        processed = os.path.join(tmp, "corpus", "processed")
        for key, fn in (
                ("corpus", lambda: tools_corpus_path(tmp)),
                ("curve", lambda: tools_curve_path(tmp, processed)),
                ("symmetry", lambda: tools_symmetry_path(
                    out["curve"]["checkpoint"], processed)),
                ("selfplay", lambda: tools_selfplay_path(
                    tmp, out["curve"]["checkpoint"])),
                ("twoply", lambda: tools_twoply_path(
                    out["curve"]["checkpoint"])),
                ("feed", lambda: tools_feed_path(tmp, processed)),
                ("notebook", lambda: tools_notebook_path(tmp))):
            s = time.perf_counter()
            out[key] = fn()
            t[key] = time.perf_counter() - s
            print(f"tools {key}: " + json.dumps(out[key], default=str)[:3000],
                  flush=True)
    out["seconds"] = time.perf_counter() - t0
    out["sub_seconds"] = t
    print(f"phase 14: {out['seconds']:.2f} s " + json.dumps(t), flush=True)
    return out


# Phase 15, the port's bench (deepgo_tpu_torch/bench.py): every ported mode
# through bench.main in this process at the card sizes (the bench's
# *_SIZES["cuda"] tables). Cut, depth only: the serving modes' requests a
# submitter (512 -> 128; a fleet serves ~0.5-0.8k boards/s). The trace is a
# capture the phase records first with `cli workload record` over
# data/sgf's openings.
BENCH_MODES = (
    ("latency", ["--mode", "latency"]),
    ("train", ["--mode", "train"]),
    ("large", ["--mode", "large"]),
    ("serving", ["--mode", "serving"]),
    ("serving_faults", ["--mode", "serving", "--faults"]),
    ("fleet_faults", ["--mode", "serving", "--fleet", "2", "--faults"]),
    ("variant", ["--mode", "serving", "--variant", "int8+sym"]),
    ("trace", ["--mode", "serving", "--trace", "{capture}"]),
    ("distributed", ["--mode", "distributed", "--faults"]),
    ("search", ["--mode", "search"]),
    ("chaos", ["--mode", "chaos"]),
    ("mixed", ["--mode", "mixed"]),
    # last: the loop mode runs under deterministic kernels (restored after)
    ("loop", ["--mode", "loop"]),
    ("loop_faults", ["--mode", "loop", "--faults"]),
)
CAMPAIGN_MODES = ("search", "chaos", "mixed")   # lines with a chaos_gate
LOOP_MODES = ("loop", "loop_faults")
# the heterogeneous fleets' CPU surge replicas (platforms round-robin)
CPU_REPLICAS = ("chaos-surge-1", "mixed-1")
BENCH_CAPTURE = ("--requests", "512", "--games", "32",
                 "--opening-moves", "12", "--model", "full")
BENCH_REQUESTS_PER_SUBMITTER = 128  # of the bench's 512 (depth only)
BENCH_MFU_CAP = 1.05
BENCH_GATE_FACTOR = 10.0   # the last-good value a --gate run must fail


class EngineForwards:
    """Every ``InferenceEngine`` made inside the block: its name and its
    ``forwards`` (warm-ups included). A closed engine is read when it
    closes; one never closed (a killed replica) is read at the end, when
    ``started`` is asked."""

    def __enter__(self):
        from deepgo_tpu_torch.serving import engine as engine_mod

        self.engines: dict = {}
        self._made: list = []
        self._cls = engine_mod.InferenceEngine
        self._close = close = self._cls.close
        self._init = init = self._cls.__init__
        engines, made = self.engines, self._made

        def counting(eng, *args, **kwargs):
            try:
                return close(eng, *args, **kwargs)
            finally:  # keyed by the engine itself: an id can be reused
                engines[eng] = (eng.name, eng.stats()["forwards"])

        def making(eng, *args, **kwargs):
            init(eng, *args, **kwargs)
            made.append(eng)

        self._cls.close = counting
        self._cls.__init__ = making
        return self

    def __exit__(self, *exc):
        self._cls.close = self._close
        self._cls.__init__ = self._init

    def forwards(self, keep=lambda name: True) -> int:
        """The forwards of the engines closed in the block."""
        return sum(n for name, n in self.engines.values() if keep(name))

    def started(self, keep=lambda name: True) -> int:
        """The forwards of every engine made in the block, closed or not:
        a forward is counted before it runs, so this bounds its launches
        from above."""
        return sum(eng.stats()["forwards"] for eng in self._made
                   if keep(eng.name))


class MoveFailures:
    """Every exception a ``GameService.play`` call raised inside the
    block, with the fleet's counters when it was raised, kept for
    ``bench_error`` to name what failed a move (the bench line only counts
    such moves)."""

    def __enter__(self):
        from deepgo_tpu_torch.sessions import service as service_mod

        self.failures: list = []
        self._cls = service_mod.GameService
        self._play = play = self._cls.play
        failures = self.failures

        def keeping(svc, *args, **kwargs):
            try:
                return play(svc, *args, **kwargs)
            except Exception as e:
                try:
                    fleet = svc.fleet.stats()["fleet"]
                except Exception as s:  # noqa: BLE001 — evidence only
                    fleet = {"error": repr(s)}
                failures.append({"error": e, "fleet": fleet})
                raise

        self._cls.play = keeping
        return self

    def __exit__(self, *exc):
        self._cls.play = self._play


def bench_line(text: str, label: str) -> dict:
    lines = [line for line in text.splitlines() if line.startswith("{")]
    check(len(lines) == 1, f"bench {label}: {len(lines)} JSON lines")
    print(f"bench-line {label} {lines[0]}", flush=True)
    return json.loads(lines[0])


def bench_run(label: str, argv: list, card: str, expect_exit: int = 0
              ) -> dict:
    """``bench.main(argv)`` in this process, with the launch counts zeroed
    just before it and read just after, each run on sanitizers of its own
    (the JAX bench runs a mode a process). A chaos_gate line exits 1 when
    its gate failed, 0 when it passed. In the loop modes the gate's direct
    forwards are counted and the learner's window records kept."""
    from deepgo_tpu_torch import bench
    from deepgo_tpu_torch import loop as loop_pkg
    from deepgo_tpu_torch.analysis import cudacheck, lockcheck

    saved = {k: os.environ.get(k) for k in (
        "DEEPGO_LOCKCHECK", "DEEPGO_XLACHECK", "DEEPGO_FLIGHT_DIR")}
    # a flight directory of the run's own: its trace.jsonl holds this
    # run's anomaly events alone, its ts/ this run's series
    flight = tempfile.mkdtemp(prefix=f"{label}-",
                              dir=os.environ.get("DEEPGO_FLIGHT_DIR"))
    os.environ["DEEPGO_FLIGHT_DIR"] = flight
    lockcheck.enable(None)
    cudacheck.enable(None)
    lockcheck.reset()
    cudacheck.reset()
    private_registry()  # the rungs' dispatch times of this run alone
    hosts: list = []
    distributed = bench._bench_distributed
    bench._bench_distributed = lambda faults, device: distributed(
        faults, device, hosts_out=hosts)
    windows: list = []
    read_windows = loop_pkg.read_windows

    def reading(run_dir):
        windows[:] = read_windows(run_dir)
        return windows

    if label in LOOP_MODES:
        loop_pkg.read_windows = reading
        GateDirectAgent.forwards = 0
        loop_gatekeeper.PolicyAgent = GateDirectAgent
    out = io.StringIO()
    code = 0
    priced = priced_steps()
    t0 = time.perf_counter()
    cuda_expand.reset_launches()
    try:
        with EngineForwards() as engines, MoveFailures() as moves, \
                contextlib.redirect_stdout(out):
            bench.main([*argv, "--device", DEVICE])
    except SystemExit as e:
        code = e.code or 0
    finally:
        launches, sym = cuda_expand.launches, cuda_expand.sym_launches
        bench._bench_distributed = distributed
        loop_pkg.read_windows = read_windows
        loop_gatekeeper.PolicyAgent = agents.PolicyAgent
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    line = bench_line(out.getvalue(), label)
    if "chaos_gate" in line:
        expect_exit = 0 if line["chaos_gate"]["pass"] else 1
    check(code == expect_exit, f"bench {label} exited {code}, not "
          f"{expect_exit}: {line.get('error')} {line.get('gate')}")
    check(line["value"] > 0 and "errors" not in line,
          f"bench {label}: value {line['value']}")
    bench_error(label, line, flight, moves.failures)
    suffix = " (2 simulated elastic hosts)" if label == "distributed" else ""
    check(line["device"] == card + suffix,
          f"bench {label}: device {line['device']!r}, not the card")
    mfus = [e["mfu"] for e in (line.get("roofline") or {}).get(
        "entries", {}).values() if e.get("mfu") is not None]
    check(all(math.isfinite(m) and 0 <= m <= BENCH_MFU_CAP for m in mfus),
          f"bench {label}: roofline MFU {mfus}")
    check(bool(mfus) == (label not in ("latency", "distributed",
                                       *CAMPAIGN_MODES, *LOOP_MODES)),
          f"bench {label}: {len(mfus)} roofline MFU entries")
    check((sym > 0) == (label == "variant"),
          f"bench {label}: {sym} sym kernel launches")
    return {"line": line, "launches": launches, "sym_launches": sym,
            "priced": priced_steps() - priced, "engines": engines,
            "hosts": hosts, "seconds": seconds, "windows": windows,
            "gate_direct": GateDirectAgent.forwards}


CLEAN_ANOMALY_ERROR = re.compile(
    r"^\d+ telemetry anomalies on a clean run \(detector must stay "
    r"silent\)$")
FAILOVER_EXHAUSTED_ERROR = re.compile(
    r"^FailoverExhausted: FleetRouter\[bench-fleet\] request failed over "
    r"\d+ time\(s\) and no healthy replica remains$")
DISPATCH_P99 = "deepgo_serving_dispatch_seconds"
SURGE_WRONG = re.compile(
    r"^surge: \d+ wrong / 0 lost answer\(s\) on the heterogeneous fleet$")
MIXED_SLO_MISS = re.compile(
    r"^coexistence: interactive SLO missed — \d+\.\d+% within 0\.15s "
    r"\(target 95%\) while batch saturated$")
MIXED_NEVER_SHED = ("coexistence: the batch tier never shed — the scan did "
                    "not actually saturate")
MIXED_ONE_MOVE_FAILED = ("coexistence: 1 interactive move(s) failed "
                         "outright under transient chaos")
# the typed, retriable errors a move's engine reply surfaces when the
# fleet's defences are spent: every deadline tier (ReplyExhausted) or the
# request's failover budget (FailoverExhausted)
MOVE_FAILURE_TYPES = ("ReplyExhausted", "FailoverExhausted")
SEARCH_KILL_MISSED = (
    "chaos: the kill event never fired",
    "chaos: the kill fired but neither failover nor respawn engaged — the "
    "fault missed the fleet")


def bench_error(label: str, line: dict, flight: str,
                moves: list = ()) -> None:
    """No ``error`` in the line, but for documented ones (PERF.md, ROADMAP
    C7, C9, C10, C13, C14), each held to its exact shape: ``chaos``' surge
    rounding (``surge_rounding``), ``mixed``'s interactive SLO miss, an
    unsaturated scan and one move whose reply failed typed (``moves``: the
    exceptions ``MoveFailures`` kept) with every other check through,
    ``search``'s kill
    that missed the fleet with the move landed in time, and the serving
    modes' two below.

    * ``fleet_faults``: the JAX bench's default fleet plan
      (``fleet_route:transient@2``) can put both transient route faults on
      one request, which has then excluded both replicas of the fleet and
      resolves as a typed ``FailoverExhausted`` (the JAX bench on the CPU
      does so in most runs). Accepted when that is the line's only error,
      exactly one request failed, and the chaos was detected;
    * a clean ``serving`` or ``variant`` run's silence contract: on the
      card the two-sided step and drift detectors fire on the dispatch
      p99 of the run's cumulative histogram as the start-up's slow
      dispatches dilute (the p99 falls while the mean dispatch time of
      the last second holds). Accepted only when every detection of the
      run (its own ``trace.jsonl``) is a step or drift *down* on a
      dispatch p99: a p99 that rises, or any other series, still fails.
      The run's series are printed beside it (``c7_evidence``)."""
    error = line.get("error")
    if error is None:
        return
    anomalies = line.get("anomalies") or {}
    if label == "fleet_faults":
        parts = error.split("; ")
        check(len(parts) == 1 and FAILOVER_EXHAUSTED_ERROR.match(parts[0])
              and line["outcomes"].get("failed") == 1
              and anomalies.get("count", 0) >= 1,
              f"bench {label}: error {error!r}, outcomes {line['outcomes']}, "
              f"{anomalies.get('count')} anomalies")
        print(f"bench {label}: accepted (C7): {error}", flush=True)
        return
    if label == "chaos":
        surge_rounding(line)
        return
    if label == "mixed":
        reasons = line["chaos_gate"]["reasons"]
        inter = line["interactive"]
        failed = [{"error": repr(m["error"]),
                   "cause": repr(m["error"].__cause__),
                   "fleet": m["fleet"]} for m in moves]
        # C14: at most one move, failed by a typed retriable error
        check(reasons and all(MIXED_SLO_MISS.match(r) or r == MIXED_NEVER_SHED
                              or r == MIXED_ONE_MOVE_FAILED for r in reasons)
              and inter["errors"] == len(moves) <= 1
              and all(type(m["error"]).__name__ in MOVE_FAILURE_TYPES
                      for m in moves),
              f"bench mixed: {reasons}; failed moves {failed}")
        print("bench mixed: accepted (C9" + (", C14" if moves else "")
              + "): " + "; ".join(reasons) + "; interactive "
              + json.dumps(inter) + ", scan "
              + json.dumps(line["analysis"]["outcomes"]) + ", surge cpu "
              f"boards {line['surge_cpu_boards']}"
              + (", failed moves " + json.dumps(failed, default=str)
                 if moves else ""), flush=True)
        return
    if label == "search":
        reasons = line["chaos_gate"]["reasons"]
        chaos = line["chaos"]
        check(len(reasons) == 1 and reasons[0] in SEARCH_KILL_MISSED
              and chaos["move_lost"] == 0 and chaos["deadline_met"]
              and not chaos["fallback"], f"bench search: {reasons}")
        print(f"bench search: accepted (C13): {reasons[0]}; the chaos leg "
              + json.dumps({k: chaos[k] for k in (
                  "move", "simulations", "lost_simulations", "wall_s",
                  "failovers", "respawns")}), flush=True)
        return
    check(label in ("serving", "variant") and bool(
        CLEAN_ANOMALY_ERROR.match(error)), f"bench {label}: error {error!r}")
    events, path = [], os.path.join(flight, "trace.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            events = [rec for rec in map(json.loads, f)
                      if rec.get("kind") == "anomaly"]
    falls = [e for e in events if e["metric"] == DISPATCH_P99
             and e["series"].endswith(":p99")
             and e["detector"] in ("step", "drift")
             and e["value"] < e["baseline"]]
    c7_evidence(label, os.path.join(flight, "ts"), events)
    check(len(events) == anomalies.get("count") and falls == events,
          f"bench {label}: error {error!r}: {len(events)} detections "
          f"recorded, {len(falls)} of them falls of a dispatch p99: "
          f"{events}")
    print(f"bench {label}: accepted (C7): {error}; every detection a fall "
          f"of a dispatch p99: " + json.dumps(
              [{k: e[k] for k in ("series", "detector", "value", "baseline",
                                  "score")} for e in events]), flush=True)


def surge_rounding(line: dict) -> None:
    """The chaos line's one accepted breach (ROADMAP C10): answers of the
    surge leg's CPU replica outside rtol 1e-4 of the ground truth, which
    the card replica gave. Accepted only when it is the gate's one reason,
    no leg lost an answer, the integrity guard saw no corrupt row, the
    wrong answers are no more than the CPU replica served, and each wrong
    board, recomputed here on the card and on the CPU, differs by
    rounding: outside rtol 1e-4 and within ``CROSS_RUNG_TOL``."""
    from deepgo_tpu_torch import bench
    from deepgo_tpu_torch.serving import replay as replay_mod
    from deepgo_tpu_torch.utils.digest import exact_digest

    reasons = line["chaos_gate"]["reasons"]
    surge = line["chaos"]["surge"]
    cpu_boards = sum(r["boards"] or 0 for r in surge["replicas"]
                     if r["platform"] == "cpu")
    check(len(reasons) == 1 and SURGE_WRONG.match(reasons[0])
          and surge["counters"]["integrity_failures"] == 0
          and 0 < surge["answers"]["wrong"] <= cpu_boards,
          f"bench chaos: {reasons}, surge {surge['answers']} "
          f"{surge['counters']}, cpu boards {cpu_boards}")
    trace = replay_mod.build_synthetic_requests(
        os.path.join(SGF_DIR, "test"), requests=200, games=16,
        opening_moves=10, rate_per_s=45.0, seed=11)
    boards = {exact_digest(it["packed"], it["player"], it["rank"]): it
              for it in trace}
    wrong = sorted({w["digest"] for w in surge["answers"]["wrong_detail"]})
    items = [boards[d] for d in wrong]
    packed = np.stack([it["packed"] for it in items])
    player = np.array([it["player"] for it in items], dtype=np.int32)
    rank = np.array([it["rank"] for it in items], dtype=np.int32)
    name, _ = bench.CHAOS_SIZES["cuda"]
    cfg = policy_cnn.CONFIGS[name]
    rows = {}
    for dev in (DEVICE, "cpu"):
        model = bench._init_params(cfg, torch.device(dev))
        rows[dev] = make_log_prob_fn(cfg, dev)(model, packed, player, rank)
    evidence = []
    for i, digest in enumerate(wrong):
        card, cpu = rows[DEVICE][i], rows["cpu"][i]
        evidence.append({
            "digest": digest, "max_abs": float(np.abs(card - cpu).max()),
            "close_rtol_1e-4": bool(np.allclose(card, cpu, rtol=1e-4,
                                                atol=1e-5))})
    check(all(not e["close_rtol_1e-4"] and e["max_abs"] <= CROSS_RUNG_TOL
              for e in evidence),
          f"bench chaos: the surge's wrong boards, card vs cpu: {evidence}")
    print(f"bench chaos: accepted (C10): {reasons[0]}; cpu replica served "
          f"{cpu_boards} boards; each wrong board card vs cpu: "
          + json.dumps(evidence), flush=True)


def c7_evidence(label: str, ts_dir: str, events: list) -> None:
    """Prints each fired dispatch p99 series of the run's store: per tick
    the dispatch count, the cumulative p99 the detector watched, and the
    mean dispatch time of the last second (the sum's and count's deltas
    over 10 ticks), a windowed reading of the same dispatches. The same
    detector is run over that windowed mean and its detections printed."""
    from deepgo_tpu_torch.obs import anomaly as anomaly_mod
    from deepgo_tpu_torch.obs import registry as obs_registry
    from deepgo_tpu_torch.obs import timeseries as ts_mod

    samples = ts_mod.load_samples(ts_dir)
    if not samples:
        return
    t0 = samples[0]["t"]
    for series in sorted({e["series"] for e in events
                          if e["series"].startswith(DISPATCH_P99)
                          and e["series"].endswith(":p99")}):
        base = series[:-len(":p99")]
        got = {f: dict(ts_mod.series_from_samples(samples, f"{base}:{f}")
                       .get(f"{base}:{f}", [])) for f in ("p99", "count",
                                                          "sum")}
        ticks = sorted(got["p99"])
        witness = anomaly_mod.AnomalyDetector(
            watchlist=(anomaly_mod.WatchSpec("windowed_mean"),),
            registry=obs_registry.MetricsRegistry(), flight=False)
        rows, hits = [], []
        for i, t in enumerate(ticks):
            j = max(0, i - 10)
            dn = got["count"].get(t, 0) - got["count"].get(ticks[j], 0)
            ds = got["sum"].get(t, 0) - got["sum"].get(ticks[j], 0)
            mean = ds / dn if dn > 0 and i >= 10 else None
            if mean is not None:
                hits += [a.to_dict() for a in witness.observe(
                    t, {"windowed_mean": mean})]
            rows.append([round(t - t0, 2), int(got["count"].get(t, 0)),
                         round(got["p99"][t] * 1e3, 3),
                         None if mean is None else round(mean * 1e3, 3)])
        print(f"c7_evidence {label} {series}: [t_s, count, p99_ms, "
              f"mean_1s_ms] {json.dumps(rows)}", flush=True)
        print(f"c7_evidence {label} {series}: the detector over the "
              f"windowed mean: {len(hits)} detections {json.dumps(hits)}",
              flush=True)


def check_bench_launches(label: str, run: dict) -> int:
    """Each mode's expansion launches against what it counts: the
    forwards and steps it ran, the priced entries, the engines' forwards.
    Returns the launches to book (the survivor's for distributed)."""
    from deepgo_tpu_torch import bench

    line, launches = run["line"], run["launches"]
    eng = run["engines"]
    if label == "inference":
        b, k, r = bench.INFERENCE_SIZES["cuda"]
        want = k * (1 + r + 1)  # warm-up, repeats, the priced call
        check(launches == want, f"bench inference: {launches} launches "
              f"!= {k} batches x {r + 2} calls")
    elif label == "latency":
        sizes, reps = bench.LATENCY_SIZES["cuda"]
        want = len(sizes) * (reps + 1)
        check(launches == want, f"bench latency: {launches} launches != "
              f"{len(sizes)} sizes x {reps + 1} forwards")
    elif label in ("train", "large"):
        b, k, r = (bench.TRAIN_SIZES if label == "train"
                   else bench.LARGE_SIZES)["cuda"]
        runs = (line["configs"] if label == "train"
                else line["settings"]).values()
        steps = sum((r + 1) * max(1, k) for s in runs
                    if "samples_per_sec" in s)
        errors = [s["error"] for s in runs if "error" in s]
        # a setting may fail only by running out of memory (the trade
        # ``large`` probes); its launches before the OOM are not counted
        check(all(e.startswith("OutOfMemoryError:") for e in errors),
              f"bench {label}: settings failed: {errors}")
        check(launches == steps + run["priced"] or (
            errors and launches >= steps + run["priced"]),
              f"bench {label}: {launches} launches != {steps} steps + "
              f"{run['priced']} priced")
    elif label in CAMPAIGN_MODES:
        # the card's replicas only (the CPU surge replicas run the plain
        # expansion; mixed's session children count in their processes):
        # at most every forward of every card engine started
        started = eng.started(lambda n: n not in CPU_REPLICAS)
        check(0 < launches <= started, f"bench {label}: {launches} launches "
              f"outside (0, {started} forwards of the card's engines]")
    elif label in LOOP_MODES:
        spw = bench.LOOP_SIZES["cuda"][0]["steps_per_window"]
        steps = line["learner_step"] + line["windows_replayed"] * spw
        certain = steps + run["gate_direct"]
        if label == "loop":
            want = certain + eng.started()
            check(launches == want, f"bench loop: {launches} launches != "
                  f"{steps} learner and replayed steps + "
                  f"{run['gate_direct']} gate forwards + {eng.started()} "
                  "fleet forwards")
        else:
            # the killed window's steps run again, and an injected fault
            # may stop a counted forward before its launch: more than the
            # steps and gate forwards, at most those + a window + every
            # forward of every engine started
            top = certain + spw + eng.started()
            check(certain < launches <= top, f"bench loop_faults: "
                  f"{launches} launches outside ({certain}, {top}]")
    elif label == "distributed":
        (rc, out, err), _ = run["hosts"]
        done = tagged(out, "ELASTIC_DONE")
        check(line["recoveries"] >= 1 and line["steps_lost"]
              <= bench.DIST_CKPT_INTERVAL and line["victim_rc"] == -9,
              f"bench distributed: {line['recoveries']} recoveries, "
              f"{line['steps_lost']} steps lost, victim {line['victim_rc']}")
        launches = done[-1]["expand_launches"]
        check(launches >= line["final_step"],
              f"bench distributed: the survivor launched {launches} for "
              f"{line['final_step']} steps")
    else:
        rungs = len(bench.SERVING_SIZES["cuda"][3])
        if label == "variant":
            f32 = eng.forwards(lambda n: n != "vab-int8+sym")
            sym = eng.forwards(lambda n: n == "vab-int8+sym")
            check(launches == rungs + f32 and run["sym_launches"]
                  >= rungs + sym, f"bench variant: {launches} launches != "
                  f"{rungs} priced + {f32} f32 forwards, sym "
                  f"{run['sym_launches']} < {rungs} + {sym}")
        elif label in ("serving", "trace"):
            want = rungs + eng.forwards()
            check(launches == want, f"bench {label}: {launches} launches != "
                  f"{rungs} priced + {eng.forwards()} engine forwards")
        else:
            # an injected fault may stop a forward before its launch, and
            # a killed engine is not closed: at least the A/B bursts after
            # the chaos (its plan reset), at most every forward of every
            # engine started (counted before it runs)
            ab = eng.forwards(lambda n: n.startswith("ab-"))
            started = eng.started()
            check(rungs + ab <= launches <= rungs + started,
                  f"bench {label}: {launches} launches outside [{rungs} "
                  f"priced + {ab} A/B forwards, {rungs} priced + {started} "
                  f"forwards of every engine started]")
    return launches


def check_bench_mode(label: str, line: dict) -> None:
    """The serving modes' own accounting: every request resolved, the
    chaos visible, the reload and the variant gate through."""
    if "submitted" in line:
        check(line["submitted"] == sum(line["outcomes"].values()),
              f"bench {label}: submitted {line['submitted']} != outcomes "
              f"{line['outcomes']}")
    if label == "serving_faults":
        check(line["restarts"] >= 1, f"bench {label}: no restart")
    if label == "fleet_faults":
        check(line["respawns"] >= 1 and line["reload"]["ok"] is True
              and line["replicas_serving"] == 2,
              f"bench {label}: respawns {line['respawns']}, reload "
              f"{line['reload']}, serving {line['replicas_serving']}")
    if label == "variant":
        v = line["variant"]
        check(v["served"] and v["tolerance"]["verdict"] == "pass",
              f"bench variant: tolerance {v['tolerance'].get('verdict')}")
    if label == "trace":
        check(line["outcomes"].get("ok") == line["submitted"]
              and line["replay"]["fidelity_ok"],
              f"bench trace: outcomes {line['outcomes']}")
    if label == "search":
        clean, chaos = line["clean"], line["chaos"]
        check(len(clean["moves"]) == clean["searches"] and clean["lost"] == 0
              and chaos["move_lost"] == 0 and chaos["move"] >= 0,
              f"bench search: clean {clean['moves']} lost {clean['lost']}, "
              f"chaos move {chaos['move']}")
    if label == "chaos":
        for leg, r in line["chaos"].items():
            # the surge leg's wrong answers are bench_error's (C10)
            check(r["answers"]["lost"] == 0
                  and (leg == "surge" or r["answers"]["wrong"] == 0),
                  f"bench chaos {leg}: answers {r['answers']}")
        check(line["chaos"]["cache_reload"]["cache"]["stale_hits"] == 0,
              "bench chaos: a stale cache hit")
    if label == "mixed":
        crash = line["crash_resume"]
        # a failed interactive move is bench_error's (C14)
        check(crash["lost_acked"] == 0 and crash["bit_identical"]
              and crash["victim_rc"] == -9,
              f"bench mixed: crash_resume {crash}, interactive "
              f"{line['interactive']}")
    if label in LOOP_MODES:
        check(line["games_lost"] == 0 and line["resume_bitexact"]
              and line["windows"] == line["windows_replayed"] == 3
              and line["champion_newer"],
              f"bench {label}: lost {line['games_lost']}, bitexact "
              f"{line['resume_bitexact']}, windows {line['windows']}")
    if label == "loop_faults":
        # one restart per injected kill: a sync beside a guarded dispatch
        # in a component's thread would raise there and show as more
        restarts = line["component_restarts"]
        kinds = {name.split("-")[0] for name in restarts}
        check(line["lockcheck"]["cycles"] == 0
              and line["xlacheck"]["transfer_violations"] == 0
              and kinds == {"actor", "learner", "gatekeeper"}
              and sorted(restarts.values()) == [1, 1, 1]
              and line["fleet_respawns"] >= 1,
              f"bench loop_faults: {line['lockcheck']} {line['xlacheck']} "
              f"restarts {line['component_restarts']}, respawns "
              f"{line['fleet_respawns']}")


def bench_cli_contract(tmp: str, card: str) -> dict:
    """The command line in a process of its own: ``python -m
    deepgo_tpu_torch.bench --mode inference`` (probe and watchdog armed)
    prints one line, exits 0 and records the card run in a temporary
    last-good table."""
    table = os.path.join(tmp, "last_good.json")
    env = {k: v for k, v in os.environ.items()
           if k not in ("BENCH_PREFLIGHT", "BENCH_WATCHDOG")}
    env.update(BENCH_LAST_GOOD=table, DEEPGO_FLIGHT="0")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deepgo_tpu_torch.bench", "--mode",
         "inference"], capture_output=True, text=True, timeout=600, env=env)
    check(proc.returncode == 0, f"bench child exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    check(len(lines) == 1, f"bench child printed {len(lines)} lines")
    line = bench_line(lines[0], "cli_inference")
    check(line["value"] > 0 and line["device"] == card
          and line["probe"]["live"] is True,
          f"bench child: {line['value']} on {line['device']!r}, probe "
          f"{line['probe']}")
    with open(table) as f:
        recorded = json.load(f)[line["metric"]]
    check(recorded["value"] == line["value"], "the child's run recorded")
    return {"line": line, "table": table,
            "seconds": time.perf_counter() - t0}


def phase_bench(requests: int = BENCH_REQUESTS_PER_SUBMITTER) -> dict:
    """Phase 15: the port's bench, every ported mode at the card sizes, each
    with the launch counts zeroed just before it and read just after; the
    serving modes at ``requests`` a submitter."""
    from deepgo_tpu_torch import bench

    t0 = time.perf_counter()
    card = card_line()
    saved_env = {k: os.environ.get(k) for k in (
        "BENCH_PREFLIGHT", "BENCH_WATCHDOG", "DEEPGO_FLIGHT_DIR")}
    saved_table = bench.LAST_GOOD_PATH
    saved_sizes = bench.SERVING_SIZES
    name, submitters, _, ladder = saved_sizes["cuda"]
    bench.SERVING_SIZES = {**saved_sizes, "cuda": (
        name, submitters, requests, ladder)}
    out, t = {"launches": {}, "sym_launches": {}}, {}
    learner_ms: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-bench-") as tmp:
        os.environ.update(BENCH_PREFLIGHT="0", BENCH_WATCHDOG="0",
                          DEEPGO_FLIGHT_DIR=tmp)
        try:
            s = time.perf_counter()
            cli = bench_cli_contract(tmp, card)
            t["cli_inference"] = time.perf_counter() - s
            bench.LAST_GOOD_PATH = cli["table"]
            # the gate reads the child's record: pass at it, fail at 10x
            run = bench_run("inference", ["--mode", "inference", "--gate"],
                            card)
            check(run["line"]["gate"]["verdict"] in ("pass", "warn"),
                  f"bench gate at the recorded value: {run['line']['gate']}")
            out["launches"]["bench_inference"] = check_bench_launches(
                "inference", run)
            runs = {"cli_inference": cli["line"], "inference": run["line"]}
            t["inference"] = run["seconds"]
            with open(cli["table"]) as f:
                table = json.load(f)
            metric = run["line"]["metric"]
            table[metric]["value"] = BENCH_GATE_FACTOR * run["line"]["value"]
            with atomic_write(cli["table"], mode="w") as f:
                json.dump(table, f)
            s = time.perf_counter()
            failed = bench_run("inference_gate_10x", [
                "--mode", "inference", "--gate"], card, expect_exit=1)
            check(failed["line"]["gate"]["verdict"] == "fail",
                  f"bench gate at {BENCH_GATE_FACTOR}x: "
                  f"{failed['line']['gate']}")
            t["inference_gate_10x"] = time.perf_counter() - s
            capture = os.path.join(tmp, "capture")
            s = time.perf_counter()
            run_cli(["workload", "record", "--out", capture, "--sgf-dir",
                     os.path.join(SGF_DIR, "train"), *BENCH_CAPTURE,
                     "--device", DEVICE])
            t["capture"] = time.perf_counter() - s
            failures = []
            for label, argv in BENCH_MODES:
                s = time.perf_counter()
                try:  # every mode runs; the phase fails after them
                    run = bench_run(label, [a.format(capture=capture)
                                            for a in argv], card)
                    check_bench_mode(label, run["line"])
                    out["launches"][f"bench_{label}"] = \
                        check_bench_launches(label, run)
                    if label == "variant":
                        out["sym_launches"]["bench_variant_int8_sym"] = \
                            run["sym_launches"]
                    runs[label] = run["line"]
                    if label in LOOP_MODES:
                        spw = bench.LOOP_SIZES["cuda"][0]["steps_per_window"]
                        learner_ms[label] = [1e3 * w["seconds"] / spw
                                             for w in run["windows"]]
                except RuntimeError as e:
                    print(f"bench {label}: FAILED {e}", flush=True)
                    failures.append(str(e))
                t[label] = time.perf_counter() - s
            check(not failures, " | ".join(failures))
        finally:
            print(f"phase 15 sub-seconds: {json.dumps(t)}", flush=True)
            bench.LAST_GOOD_PATH = saved_table
            bench.SERVING_SIZES = saved_sizes
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    out["numbers"] = bench_numbers(runs, learner_ms)
    out["seconds"] = time.perf_counter() - t0
    out["sub_seconds"] = t
    print(f"phase 15: {out['seconds']:.2f} s " + json.dumps(t), flush=True)
    print("bench numbers: " + json.dumps(out["numbers"]), flush=True)
    return out


def bench_numbers(runs: dict, learner_ms: dict) -> dict:
    """The numbers PERF.md keeps from each bench line (and the loop
    learner's ms a step, window by window, under deterministic kernels)."""
    def mfu(line):
        return {k: e["mfu"] for k, e in line["roofline"]["entries"].items()
                if e.get("mfu") is not None}

    serving = {k: {f: runs[k].get(f) for f in (
        "value", "p50_ms", "p99_ms", "batch_occupancy", "outcomes",
        "restarts", "failovers", "respawns", "failover_p50_ms")
        if f in runs[k]} for k in ("serving", "serving_faults",
                                   "fleet_faults", "variant", "trace")}
    serving["fleet_faults"]["tiers"] = runs["fleet_faults"]["tiers"]
    var = runs["variant"]["variant"]
    trace = runs["trace"]
    dist = runs["distributed"]
    return {
        "inference": {k: runs["inference"][k] for k in (
            "value", "vs_baseline", "ms_per_batch", "noise_frac")}
        | {"mfu": mfu(runs["inference"]),
           "cli_value": runs["cli_inference"]["value"]},
        "train": {**runs["train"]["configs"], "mfu": mfu(runs["train"])},
        "large": {**runs["large"]["settings"], "mfu": mfu(runs["large"])},
        "latency": runs["latency"]["batches"],
        "serving": serving,
        "serving_mfu": mfu(runs["serving"]),
        "variant": {k: var.get(k) for k in (
            "f32_boards_per_sec", "boards_per_sec",
            "throughput_ratio_vs_f32", "cost_ratio_vs_plain_per_rung")},
        "trace": {k: trace["cache"].get(k) for k in (
            "speedup", "ok", "hit_rate", "forward_frac_avoided",
            "off_boards_per_sec", "on_boards_per_sec")}
        | {"span_error_frac": trace["replay"].get("span_error_frac"),
           "lag_frac": trace["replay"].get("lag_frac")},
        "ab_overhead": {k: {b: runs[k][b]["ab"]["overhead_frac"] for b in (
            "tracing", "anomalies", "workload")} for k in (
            "serving", "serving_faults", "fleet_faults", "variant",
            "trace")},
        "anomalies": {k: runs[k]["anomalies"].get("count") for k in (
            "serving", "serving_faults", "fleet_faults", "variant",
            "trace")},
        "distributed": {k: dist[k] for k in (
            "value", "detect_latency_s", "steps_lost", "tp_from", "tp_to",
            "final_step", "survivor_samples_per_sec")},
    } | campaign_numbers(runs, learner_ms)


def campaign_numbers(runs: dict, learner_ms: dict) -> dict:
    """The search, chaos, mixed and loop modes' numbers for PERF.md."""
    search, chaos, mixed = runs["search"], runs["chaos"], runs["mixed"]
    legs = {leg: {"good_frac": r["slo"]["good_frac"], "ok": r["slo"]["ok"],
                  "wrong": r["answers"]["wrong"], "lost": r["answers"]["lost"],
                  **{k: r["counters"][k] for k in (
                      "failovers", "respawns", "hedges", "ejections",
                      "integrity_failures")}}
            for leg, r in chaos["chaos"].items()}
    return {
        "search": {
            "value": search["value"],
            "clean": {k: search["clean"][k] for k in (
                "simulations", "wall_s", "wave_occupancy")}
            | {"hit_rate": search["clean"]["transposition"]["hit_rate"]},
            "chaos": {k: search["chaos"][k] for k in (
                "move_lost", "simulations", "lost_simulations", "wall_s",
                "failovers", "respawns")}},
        "chaos": {"value": chaos["value"], **legs},
        "mixed": {"value": mixed["value"],
                  "interactive": mixed["interactive"],
                  "scan": mixed["analysis"]["outcomes"],
                  "surge_cpu_boards": mixed["surge_cpu_boards"],
                  "crash_resume": {k: mixed["crash_resume"][k] for k in (
                      "victim_acks", "lost_acked", "bit_identical")}},
        "loop": {label: {k: runs[label][k] for k in (
            "value", "seconds", "games_acked", "windows", "gates_passed",
            "learner_step", "component_restarts", "fleet_respawns",
            "fleet_failovers")} | {"learner_ms_per_step": learner_ms.get(
                label)} for label in LOOP_MODES},
    }


def kernel_entry(name, replaces, launches_by_path, rows, top,
                 source="expand.cu") -> dict:
    return {"name": name, "route": "cuda",
            "source": f"deepgo_tpu_torch/ops/csrc/{source}",
            "replaces": replaces,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "exact": all(r["exact"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "kernel_ms": top["ms"],
            "launch_ms": top["launch_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "share_of_bound": top["share_of_bound"],
            "library_ms": top.get("library_ms"),
            "shape": top.get("shape") or (f"B={top['batch']} "
                                          f"S={top['symmetries']} "
                                          f"{top['dtype']}"),
            "by_shape": rows}


def parse_phases(argv: list) -> tuple[set, int, int]:
    """``--phases 4,11`` (default: all), ``--cards N`` (default 1) and
    ``--bench-requests N``, phase 15's serving requests a submitter
    (default 128; the bench's own is 512, where C7's clean-run
    detections were seen). Phases 1-3 always run; a phase that needs an
    earlier one's net brings it along (5-10 and 13 need phase 4's, 6, 8,
    9 and 13 phase 5's too)."""
    phases, cards = set(range(4, 16)), 1
    requests = BENCH_REQUESTS_PER_SUBMITTER
    args = list(argv)
    while args:
        flag = args.pop(0)
        if flag == "--phases" and args:
            phases = {int(p) for p in args.pop(0).split(",")}
        elif flag == "--cards" and args:
            cards = int(args.pop(0))
        elif flag == "--bench-requests" and args:
            requests = int(args.pop(0))
        else:
            raise SystemExit(f"chip_smoke: unknown argument {flag!r}; use "
                             "--phases LIST, --cards N and "
                             "--bench-requests N")
    if not phases <= set(range(1, 16)):
        raise SystemExit(f"chip_smoke: phases run from 1 to 15: {phases}")
    if cards not in (1, PAR_CARDS) or (cards > 1 and phases != {11}):
        raise SystemExit(f"chip_smoke: --cards {PAR_CARDS} goes with "
                         "--phases 11 alone")
    if phases & {6, 8, 9, 13}:
        phases.add(5)
    if phases & {5, 6, 8, 9, 10, 13}:
        phases.add(4)
    return phases, cards, requests


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one CUDA card",
              file=sys.stderr)
        return 1
    # phase 15's loop modes turn deterministic kernels on in this process
    # (bench.main), and cuBLAS reads its workspace setting when it first
    # runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if sys.argv[1:2] == ["--deterministic"] and len(sys.argv) == 3:
        return deterministic_main(sys.argv[2])
    if sys.argv[1:2] == ["--loop-learner"] and len(sys.argv) == 3:
        set_deterministic()
        det_learner_run(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--loop-witness"] and len(sys.argv) == 4:
        return loop_witness_main(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--par-group"] and len(sys.argv) == 3:
        return par_group_main(sys.argv[2])
    if sys.argv[1:2] == ["--elastic-host"] and len(sys.argv) == 7:
        return elastic_host_main(sys.argv[2], sys.argv[3],
                                 *map(int, sys.argv[4:7]))
    if sys.argv[1:2] == ["--par-rank"] and len(sys.argv) == 6:
        return par_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                             int(sys.argv[4]), sys.argv[5])
    phases, cards, bench_requests = parse_phases(sys.argv[1:])
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card {kind}, phases "
          f"{sorted(phases | {1, 2, 3})}, cards {cards}", flush=True)
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
    epilogue = phase_epilogue()
    bn_epilogue = phase_bn_epilogue()
    expand_paths, sym_paths, summary = {}, {}, {}
    if 4 in phases:
        path = phase_main_path(rng)
        expand_paths["serving_f32"] = path["launches"]
        summary["f32_path"] = {
            "cross_rung_max_abs": path["cross_rung"],
            "cross_rung_spread": path["cross_rung_spread"],
            "forward_wall_ms": path["forward_wall_ms"],
            "profile": path["profile"], "engine": path["stats"]}
    if 5 in phases:
        var = phase_variant_path(rng)
        sym_paths["serving_int8_sym"] = var["launches"]
        summary["int8_sym_path"] = {k: var[k] for k in (
            "gate", "gate_s", "cross_rung", "cross_rung_spread",
            "identities", "forward_wall_ms", "profile",
            "expand_launches")} | {"engine": var["stats"]}
    if 6 in phases:
        summary["card_vs_cpu_f32_max_abs"] = phase_card_vs_cpu(
            "plain forward", make_log_prob_fn, path["model"], path["boards"])
        summary["card_vs_cpu_fused_sym_f32_max_abs"] = phase_card_vs_cpu(
            "fused sym forward", quant.make_fused_sym_policy_fn, var["model"],
            tuple(a[:CARD_VS_CPU_BOARDS] for a in var["boards"]))
    if 7 in phases:
        train = phase_train_path()
        expand_paths["training"] = train["run"]["launches"]
        sym_paths["training"] = train["run"]["sym_launches"]
        summary["train_path"] = train | {"run": {
            k: v for k, v in train["run"].items() if k != "validation"}}
    if 8 in phases:
        fleet = phase_fleet_path(path["model"], var["model"])
        expand_paths |= {
            "fleet_cache": fleet["cache"]["launches"],
            "fleet_restart": fleet["restart"]["launches"],
            "fleet_reload": fleet["reload"]["launches"],
            "fleet_mixed_f32": fleet["variants"]["expand_launches"],
            "fleet_surge": fleet["surge"]["launches"],
            "value_fleet": fleet["value"]["launches"]}
        sym_paths["fleet_mixed_int8_sym"] = fleet["variants"]["sym_launches"]
        summary["fleet_path"] = fleet
    if 9 in phases:
        games = phase_games_path(path["model"], var["model"])
        expand_paths |= {
            "selfplay_engine": games["selfplay"]["launches"],
            "match_direct": games["direct_match"]["launches"],
            "selfplay_fleet": games["fleet_selfplay"]["launches"],
            "search_fleet": games["search"]["launches"],
            "arena_f32": games["arena"]["launches"],
            "replay_fleet": games["replay"]["launches"]}
        sym_paths["arena_int8_sym"] = games["arena"]["sym_launches"]
        summary["games_path"] = games
    if 10 in phases:
        loop = phase_loop_path(path["model"])
        expand_paths |= {**loop["loop"]["launches_by_path"],
                         "value_training": loop["value"]["launches"],
                         "sessions_fleet": loop["sessions"]["launches"]}
        summary["loop_path"] = loop
    if 11 in phases and cards == 1:
        par = phase_parallel()
        expand_paths |= {"parallel_group": par["group"]["launches"],
                         "elastic_survivor": par["elastic"]["launches"]}
        summary["parallel_path"] = par
    if cards > 1:
        par4 = phase_four_cards()
        expand_paths |= {f"dp4_rank{r}": n
                         for r, n in enumerate(par4["launches"])}
        summary["parallel_4_cards"] = par4
    if 12 in phases:
        obs = phase_observability()
        expand_paths |= {
            "obs_profiled_training": obs["profiled_training"]["launches"],
            "obs_chaos_fleet": obs["chaos"]["launches"],
            "obs_sanitized_engine": obs["sanitizers"]["launches"],
            **{f"obs_{k}": v for k, v in
               obs["telemetry"]["loop"]["launches_by_path"].items()}}
        summary["observability_path"] = obs
        sps = obs["profiled_training"]["samples_per_sec"]
        if 7 in phases:
            sps = {"phase_7": train["run"]["samples_per_sec"], **sps}
        print("training samples/s: " + json.dumps(sps), flush=True)
    if 13 in phases:
        cmd = phase_command_line(path["model"], var["model"])
        for sub in cmd.values():
            if isinstance(sub, dict):
                expand_paths |= sub.get("launches", {})
                sym_paths |= sub.get("sym_launches", {})
        summary["command_line_path"] = cmd
    if 14 in phases:
        tools = phase_tools()
        for sub in tools.values():
            if isinstance(sub, dict):
                expand_paths |= sub.get("launches", {})
                sym_paths |= sub.get("sym_launches", {})
        summary["tools_path"] = tools
    if 15 in phases:
        benched = phase_bench(bench_requests)
        expand_paths |= benched["launches"]
        sym_paths |= benched["sym_launches"]
        summary["bench_path"] = {k: v for k, v in benched.items()
                                 if k != "launches"}

    def top_row(rows, s):
        return next(r for r in rows if r["batch"] == 512
                    and r["symmetries"] == s and r["dtype"] == "bfloat16"
                    and not r["sliced"])

    kernels = {"kernels": [
        kernel_entry("expand_planes", "deepgo_tpu/ops/pallas_expand.py:84",
                     expand_paths, kernel_rows, top_row(kernel_rows, 1)),
        kernel_entry("expand_planes_sym",
                     "deepgo_tpu/ops/pallas_expand.py:90",
                     sym_paths, sym_rows, top_row(sym_rows, 8)),
        *(kernel_entry(f"bias_relu_{half}", None,
                       {path: n[half] for path, n in
                        epilogue["launches"].items()},
                       epilogue[half], epilogue[half][0], "epilogue.cu")
          for half in ("forward", "backward")),
        *(kernel_entry(f"bn_relu_{half}", None,
                       {path: n[half] for path, n in
                        bn_epilogue["launches"].items()},
                       bn_epilogue[half], bn_epilogue[half][0],
                       "bn_epilogue.cu")
          for half in ("forward", "backward")),
    ]}
    summary["seconds"] = time.perf_counter() - t_start
    print("summary: " + json.dumps(summary), flush=True)
    print(all_cards() if cards > 1 else card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
