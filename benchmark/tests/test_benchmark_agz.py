"""The ``agz40.train.b512`` cell on the CPU at a tiny size: a sound run is
correct, each planted fault is not, the control reads well above the
program, the readers' arithmetic on a recorded step, and the cost of the
published network."""

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from benchmark import control, cost, cost_resnet, harness, trace
from benchmark.tests.conftest import REPO
from benchmark.tests.test_benchmark_harness import FIXTURE

CELL = "agz40.train.b512"
CFG = json.loads((Path(REPO) / "benchmark" / "configs" / "agz40.json")
                 .read_text())
METRICS = ("train_mfu.agz40", "conv_roofline.agz40",
           "epilogue_roofline.agz40", "device.idle_frac.agz40",
           "loader.wait_frac.agz40")
# 3 blocks of 16 filters in float32: the program meets the reference to
# float32 round-off, so a sound run sits far under every limit and a fault
# far over; bfloat16's readings at this width are the card's business
TINY = {"config": {"blocks": 3, "channels": 16, "compute_dtype": "float32"},
        "traffic": {"batch": 32, "games": 20, "game_positions": 20,
                    "warmup_steps": 2, "trace_seconds": 0.3,
                    "host_trace_seconds": 0.2}}


# the same at the card's precision, on a batch of 64 rows
TINY_BF16 = {**TINY, "config": {"blocks": 3, "channels": 16},
             "traffic": {**TINY["traffic"], "batch": 64}}


def _run(patch=None, trace_on=0, overrides=TINY, control=False):
    return harness.run(["--workload", CELL, "--seed", "2147483713",
                        "--seconds", "0.5", "--trace", str(trace_on)],
                       time.perf_counter(), device="cpu", overrides=overrides,
                       patch=patch, control=control)


def _run_apart(patch, bf16=False):
    """A run in a process of its own (a planted fault stays for the
    process); its result line."""
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "from benchmark.tests import test_benchmark_agz as t;"
            "print(json.dumps(t._run(sys.argv[2], overrides=t.TINY_BF16 "
            "if sys.argv[3] == '1' else t.TINY, control=True)))")
    out = subprocess.run([sys.executable, "-c", code, REPO, patch,
                          "1" if bf16 else "0"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_sound_run_is_correct_and_traced_it_reads_the_loader():
    line = _run()
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"grad_gap", "change_gap", "grad_diff",
                                   "head_gap", "policy_fc_diff", "stats_gap",
                                   "rows_unmatched"}
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    traced = _run(trace_on=1)
    # on the CPU no peak and no device kernels: the loader's share alone
    assert set(traced["metrics"]) == {"loader.wait_frac.agz40"}


FAULTS = ["benchmark.faults_resnet:bn_frozen",
          "benchmark.faults_resnet:outcome_dropped",
          "benchmark.faults:state_unchanged", "benchmark.faults:half_batch"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(fault):
    line = _run_apart(fault)
    assert not line["correct"], line["checks"]


def test_in_bfloat16_a_half_batch_turns_the_policy_heads_gradient():
    """The half batch keeps the gradients' norms (on the card it passes
    every gap of norms) and turns the policy head's dense gradient, where
    bfloat16 barely moves it."""
    sound = _run(overrides=TINY_BF16, control=True)["control"]["program"]
    half = _run_apart("benchmark.faults:half_batch", bf16=True)
    half = half["control"]["program"]
    assert half["policy_fc_diff"] >= 10 * sound["policy_fc_diff"]


def test_the_control_reads_well_above_a_bfloat16_program():
    """At a test's width in bfloat16 the program's median leaf's gradient
    gap lies near the card's limit, and the fp8 control's several times
    above it."""
    got = control.readings(CELL, [21, 22], 0.3, device="cpu",
                           overrides=TINY_BF16)
    for number in ("grad_diff", "policy_fc_diff"):
        assert got["control_min"][number] >= 3 * got["program_max"][number]
    for number in ("head_gap", "stats_gap"):
        assert got["control_min"][number] > got["program_max"][number]


def test_the_control_is_judged_by_the_cells_limits():
    """The control's verdict comes from the same rule as ``correct``: under
    limits far above its readings it is correct, under limits of 0 not."""
    limits = json.loads((Path(REPO) / "benchmark" / "limits"
                         / f"{CELL}.json").read_text())

    def verdict(scale):
        line = _run(control=True, overrides={
            **TINY, "limits": {k: v * scale for k, v in limits.items()}})
        return line["control"]["correct"]

    assert verdict(1e6) and not verdict(0.0)


def test_cost_of_the_published_network():
    assert cost_resnet.num_params(CFG) == CFG["params"] == 46_486_674
    assert cost_resnet.forward_flops(CFG) == pytest.approx(30.985e9, rel=1e-4)
    assert cost_resnet.train_flops(CFG) == pytest.approx(92.898e9, rel=1e-4)
    # 39 residual blocks of 14 tensors, the conv block's 6, a tensor 256 x
    # 361 bf16
    assert cost_resnet.epilogue_bytes(CFG) == (6 + 14 * 39) * 256 * 361 * 2


def test_the_readers_on_a_recorded_step():
    s = trace.summarize(FIXTURE, 1e-5, 0)
    peak = cost.peak("NVIDIA H100 80GB HBM3")
    counters = {p: {"steps": 2, "rows_per_card": 4, "window_s": 1e-5,
                    "loader_wait_s": 1e-6} for p in ("clock", "device",
                                                     "host")}
    run = types.SimpleNamespace(summary={"device": s, "host": s},
                                counters=counters, cfg=CFG, cost=cost,
                                peak=peak, cards=1)
    read = {m: harness.load_reader(m).read(run) for m in METRICS}
    flops = cost_resnet.train_flops(CFG, 4) * 2
    assert read["train_mfu.agz40"] == pytest.approx(
        100 * flops / 1e-5 / peak["bf16_flops"])
    assert read["conv_roofline.agz40"] == pytest.approx(
        100 * cost_resnet.conv_train_flops(CFG, 4) * 2
        / peak["bf16_flops"] / 2e-6)
    assert read["epilogue_roofline.agz40"] == pytest.approx(
        100 * cost_resnet.epilogue_bytes(CFG, 4) * 2
        / peak["hbm_bytes_per_s"] / 2e-6)
    assert read["device.idle_frac.agz40"] == pytest.approx(0.5)
    assert read["loader.wait_frac.agz40"] == pytest.approx(0.1)
    # a network without residual blocks, or a trace with nothing on the
    # card, gives nothing to read
    policy = json.loads((Path(REPO) / "benchmark" / "configs" / "full.json")
                        .read_text())
    run.cfg = policy
    for m in METRICS[:3]:
        assert harness.load_reader(m).read(run) is None
    run.cfg = CFG
    empty = trace.summarize([], 1.0, 0)
    run.summary = {"device": empty, "host": empty}
    for m in METRICS[1:4]:
        assert harness.load_reader(m).read(run) is None
