"""The harness on the CPU: the contract of BENCHMARK.json, discovery of new
files, the trace reduction and the readers' arithmetic, the generators'
counts, the whole-name import check, and faults planted under the timed
path coming out as ``correct`` false."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from benchmark import cost, data, harness, trace
from benchmark.tests.conftest import REPO, tiny

BENCH = Path(REPO) / "benchmark"
SPEC = json.loads((Path(REPO) / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_every_named_file_exists_and_the_check_fits_its_time():
    for c in SPEC["configs"]:
        cfg = json.loads((Path(REPO) / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cost.num_params(cfg) == cfg["params"]
    for w in SPEC["workloads"]:
        files = harness.cell_files(SPEC, w["name"], Path(REPO))
        assert (BENCH / "drivers" / f"{files['traffic']['kind']}.py").exists()
        assert harness.end_to_end(SPEC, w["name"])
        assert harness.per_layer(SPEC, w["name"])
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    s = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_new_config_mix_and_metric_are_found_from_files_alone(tmp_path):
    """A cell added as new files and new entries runs, with no existing
    file of the benchmark changed."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    b = tmp_path / "benchmark"
    (b / "configs" / "tiny.json").write_text(json.dumps({
        **json.loads((b / "configs" / "full.json").read_text()),
        "name": "tiny", "num_layers": 3, "channels": 16, "params": 0}))
    (b / "traffic" / "infer.b64.json").write_text(json.dumps({
        **json.loads((b / "traffic" / "infer.b8192.json").read_text()),
        "batch": 64, "pool_batches": 2, "warmup_calls": 1,
        "trace_seconds": 0.3, "host_trace_seconds": 0.2}))
    (b / "limits" / "tiny.infer.b64.json").write_text('{"logp_drift": 0.08}')
    (b / "metrics" / "rows.infer.py").write_text(
        "def read(run):\n    return run.counters['clock']['rows']\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.infer.b64", "config": "tiny",
                              "traffic": "infer.b64", "chips": 1,
                              "why": "test"})
    [infer] = [m for m in spec["end_to_end"]
               if m["name"] == "infer_boards_per_s"]
    infer["workloads"].append("tiny.infer.b64")
    spec["per_layer"].append({"name": "rows.infer", "unit": "rows",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "infer_boards_per_s",
                              "workloads": ["tiny.infer.b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json, time; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import harness;"
            "print(json.dumps([harness.run(['--workload', 'tiny.infer.b64',"
            " '--seed', '5', '--seconds', '0.3', '--trace', str(t)],"
            " time.perf_counter(), device='cpu') for t in (0, 1)]))")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=tmp_path,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and set(plain["metrics"]) == {
        "infer_boards_per_s", "setup_s"}
    assert traced["metrics"]["rows.infer"]["value"] > 0
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert not changed


class _Event:
    """A profiler event as ``trace.summarize`` reads it."""

    def __init__(self, name, start, dur, device, corr=0, link=0, thread=1):
        self._v = (name, start, dur, device, corr, link, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def device_index(self):
        return 0

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[0].startswith("train.")


# a recorded shape of one training step, in ns: host spans, the ops that
# launch, and their kernels on the card (the annotation's device mirror
# included, which is no work)
FIXTURE = [
    _Event("train.forward", 0, 5_000, False, corr=1),
    _Event("aten::cudnn_convolution", 100, 900, False, corr=2),
    _Event("train.expand", 1_000, 500, False, corr=3),
    _Event("train.forward", 0, 5_000, True, link=1),
    _Event("sm90_xmma_fprop_implicit_gemm", 1_000, 2_000, True, link=2),
    _Event("expand_planes_kernel<bf16>", 3_000, 1_000, True, link=3),
    _Event("ncclDevKernel_AllReduce", 6_000, 1_000, True, link=0),
    _Event("train.backward", 5_000, 3_000, False, corr=4),
    _Event("aten::add", 7_100, 100, False, corr=5),
    _Event("elementwise_kernel", 8_000, 1_000, True, link=5),
]


def test_trace_summary_and_readers_on_a_recorded_step():
    s = trace.summarize(FIXTURE, 1e-5, 0)
    assert s["busy_s"] == pytest.approx(5e-6)
    assert s["category_s"] == pytest.approx(
        {"conv": 2e-6, "expand": 1e-6, "other": 2e-6})
    # idle 4-6 us while train.forward is open, 7-8 us in train.backward
    assert s["gaps"] == pytest.approx({"train.forward": 2e-6,
                                       "train.backward": 1e-6})
    summaries = {"device": s, "host": s}
    peak = cost.peak("NVIDIA H100 80GB HBM3")
    cfg = json.loads((BENCH / "configs" / "full.json").read_text())
    counters = {p: {"steps": 2, "rows_per_card": 4, "window_s": 1e-5,
                    "loader_wait_s": 1e-6, "rows": 8, "positions": 8,
                    "dispatches": 2}
                for p in ("clock", "device", "host")}
    run = types.SimpleNamespace(summary=summaries, counters=counters,
                                cfg=cfg, cost=cost, peak=peak, cards=1)
    read = {m: harness.load_reader(m).read(run) for m in
            (x["name"] for x in SPEC["per_layer"])}
    assert read["device.idle_frac.train"] == pytest.approx(0.5)
    assert read["loader.wait_frac.train"] == pytest.approx(0.1)
    assert read["train_mfu"] == pytest.approx(
        100 * cost.train_flops(cfg, 4) * 2 / 1e-5 / peak["bf16_flops"])
    assert read["conv_roofline.train"] == pytest.approx(
        100 * cost.train_flops(cfg, 4) * 2 / peak["bf16_flops"] / 2e-6)
    assert read["expand_roofline.infer"] == pytest.approx(
        100 * cost.expand_bytes(8) / peak["hbm_bytes_per_s"] / 1e-6)
    empty = trace.summarize([], 1.0, 0)
    run.summary = {"device": empty, "host": empty}
    assert harness.load_reader("conv_roofline.infer").read(run) is None
    assert harness.load_reader("device.idle_frac.infer").read(run) is None


def test_generators_counts(tmp_path):
    rng = np.random.default_rng(1)
    packed, player, rank = data.records(rng, 50, [2, 6, 8, 8, 8, 8, 6, 2, 2])
    assert packed.shape == (50, 9, 19, 19) and packed.dtype == np.uint8
    assert (packed.max(axis=(0, 2, 3)) == [2, 6, 8, 8, 8, 8, 6, 2, 2]).all()
    assert set(player) == {1, 2} and rank.min() >= 1 and rank.max() <= 9
    raw = data.write_split(str(tmp_path / "train"), rng, 7, 11, 5, [2] * 9)
    games = json.loads((tmp_path / "train" / "games.json").read_text())
    assert len(games) == 7 and sum(g["count"] for g in games) == 77
    assert os.path.getsize(tmp_path / "train" / "planes.bin") == 77 * 3249
    assert len(set(raw["target"])) <= 5
    from deepgo_tpu_torch.data.dataset import GoDataset
    ds = GoDataset(str(tmp_path), "train")
    got = ds.batch_at(np.arange(77))
    assert np.array_equal(got[0], raw["packed"])
    assert np.array_equal(got[3], raw["target"])


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package_by_whole_name():
    for path in BENCH.rglob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "deepgo_tpu"}
        assert not found, (path, found)
    for path in (BENCH / "reference").rglob("*.py"):
        assert "deepgo_tpu_torch" not in _imports(path), path
    # whole top-level names: the port's name starts with the JAX package's
    sys.modules.setdefault("deepgo_tpu_torch_probe", types.ModuleType("x"))
    assert "deepgo_tpu" not in harness.forbidden_modules()
    sys.modules["deepgo_tpu.fake"] = types.ModuleType("deepgo_tpu.fake")
    try:
        assert harness.forbidden_modules() == ["deepgo_tpu"]
    finally:
        del sys.modules["deepgo_tpu.fake"]
        del sys.modules["deepgo_tpu_torch_probe"]


def test_run_refuses_without_cards():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "full.infer.b8192", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 2 and not out.stdout.strip()
    assert "needs 1 CUDA device" in out.stderr


def _run(workload, kind, patch=None, **traffic):
    return harness.run(["--workload", workload, "--seed", "2147483713",
                        "--seconds", "0.5"], time.perf_counter(),
                       device="cpu", overrides=tiny(kind, **traffic),
                       patch=patch)


SOUND = [("large.train.b1024", "train"), ("full.infer.b8192", "infer")]


@pytest.mark.parametrize("workload,kind", SOUND)
def test_a_sound_run_is_correct(workload, kind):
    line = _run(workload, kind)
    assert line["correct"], line["checks"]


FAULTS = [
    ("large.train.b1024", "train", "state_unchanged"),
    ("large.train.b1024", "train", "half_batch"),
    ("full.infer.b8192", "infer", "answer_altered"),
]


@pytest.mark.parametrize("workload,kind,fault", FAULTS)
def test_a_planted_fault_is_not_correct(workload, kind, fault):
    """Each fault a cell can have, planted under the timed path in a run
    that skips only the look for a card, comes out as ``correct`` false.
    Run in a process of its own: a planted fault stays for the process."""
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "from benchmark.tests import test_benchmark_harness as t;"
            "print(json.dumps(t._run(*sys.argv[2:4], patch=sys.argv[4])))")
    out = subprocess.run(
        [sys.executable, "-c", code, REPO, workload, kind,
         f"benchmark.faults:{fault}"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert not line["correct"], line["checks"]
