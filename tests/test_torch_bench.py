"""The port's benchmark (``deepgo_tpu_torch.bench``) against the JAX
package's ``bench.py`` on the CPU, at the JAX bench's CPU sizes.

* bitwise: ``_rand_batch`` on one seed, ``_grid_decisive_params`` on the
  same He-init weights carried across with ``models/convert.py``;
* equal: ``_METRIC_OF``, the ``DEFAULT_*_FAULTS`` specs,
  ``DIST_CKPT_INTERVAL``;
* the same verdict and ``gate`` block from both packages' ``_apply_gate``
  and ``_exit_gate`` over a grid of cases;
* float32 ``small`` weights from JAX: the inference body's sum within rtol
  1e-5 of the JAX bench's ``run_many`` body, and the first call of
  ``_time_train_step`` within 1e-5 of JAX's train step losses;
* every ported mode through ``main`` with ``--device cpu``: one JSON line
  whose metric and top-level keys are the JAX bench's for that mode. The
  modes run as child processes in a few lanes started with the first test
  (``python -m deepgo_tpu_torch.bench ...``), beside the in-process tests;
  the JAX bench's keys come from a child too (``python
  tests/test_torch_bench.py jax-keys OUT CAPTURE``), whose runs skip the
  JAX A/B bursts and train timing (stubs that leave the top-level keys
  as they are) and feed the distributed mode canned host output;
* ``--device cuda`` without a card: one line, ``value`` 0.0, a probe
  ``error``, exit 1.
"""

import copy
import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import REPO_ROOT  # first: run as a script, it puts the repo
import bench as jax_bench  # noqa: E402, I001 — on the path for this import
from deepgo_tpu.models import policy_cnn as jax_policy_cnn
from deepgo_tpu.obs import registry as jax_registry
from deepgo_tpu.ops import expand_planes as jax_expand_planes
from deepgo_tpu.training import make_train_step as jax_make_train_step
from deepgo_tpu.training import \
    make_train_step_many as jax_make_train_step_many
from deepgo_tpu.training.optimizers import OPTIMIZERS as JAX_OPTIMIZERS

from deepgo_tpu_torch import bench
from deepgo_tpu_torch.models import convert, policy_cnn

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL_F32 = {"num_layers": 3, "channels": 64, "compute_dtype": "float32"}
LANE_TIMEOUT_S = 400

# label -> (bench argv, the JAX bench's key label); --device cpu is added
MODES = {
    "inference": (["--mode", "inference"], "inference"),
    "train": (["--mode", "train"], "train"),
    "large": (["--mode", "large"], "large"),
    "serving": (["--mode", "serving"], "serving"),
    "serving_faults": (["--mode", "serving", "--faults"], "serving_faults"),
    "fleet_faults": (["--mode", "serving", "--fleet", "2", "--faults"],
                     "fleet_faults"),
    "variant": (["--mode", "serving", "--variant", "int8+sym"], "variant"),
    "trace": (["--mode", "serving", "--trace", "{capture}"], "trace"),
    "distributed": (["--mode", "distributed", "--faults"], "distributed"),
}
# the lanes run side by side, each mode of a lane after the other, beside
# the JAX bench's keys: four children of one compute thread each, so the
# file leaves cores to the other test workers
LANES = (("serving", "serving_faults", "large"),
         ("fleet_faults", "variant", "train"),
         ("distributed", "trace", "inference"))


@pytest.fixture(scope="module", autouse=True)
def private_jax_registry():
    """The JAX package's steps here count into a registry of their own."""
    saved = jax_registry._default
    jax_registry._default = jax_registry.MetricsRegistry()
    yield
    jax_registry._default = saved


def child_env(tmp: str) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DEEPGO_FAULTS", "DEEPGO_LOCKCHECK",
                        "DEEPGO_XLACHECK")}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", DEEPGO_FLIGHT="0",
               BENCH_PREFLIGHT="0", BENCH_WATCHDOG="0",
               BENCH_LAST_GOOD=os.path.join(tmp, "last_good.json"))
    return env


def run_child(argv: list, env: dict, timeout: float = LANE_TIMEOUT_S):
    proc = subprocess.run([sys.executable, *argv], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def json_lines(stdout: str) -> list:
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]


class Lanes:
    """Children started together: each lane runs its modes in order in a
    thread; ``result(label)`` waits for one."""

    def __init__(self, tmp: str, capture: str):
        self.env = child_env(tmp)
        self.results: dict = {}
        self.done = {label: threading.Event() for label in MODES}
        self.done["jax_keys"] = threading.Event()
        self.jax_keys_path = os.path.join(tmp, "jax_keys.json")
        self.capture = capture
        jobs = [[(label, self._bench_argv(label)) for label in lane]
                for lane in LANES]
        jobs.append([("jax_keys", [os.path.abspath(__file__), "jax-keys",
                                   self.jax_keys_path, capture])])
        self.threads = [threading.Thread(target=self._run, args=(lane,),
                                         daemon=True) for lane in jobs]
        for t in self.threads:
            t.start()

    def _bench_argv(self, label: str) -> list:
        argv = [a.format(capture=self.capture) for a in MODES[label][0]]
        return ["-m", "deepgo_tpu_torch.bench", *argv, "--device", "cpu"]

    def _run(self, lane) -> None:
        for label, argv in lane:
            try:
                self.results[label] = run_child(argv, self.env)
            except subprocess.TimeoutExpired as e:
                self.results[label] = (None, "", f"timed out: {e}")
            finally:
                self.done[label].set()

    def result(self, label: str):
        assert self.done[label].wait(LANE_TIMEOUT_S), f"{label} never ended"
        return self.results[label]

    def jax_keys(self) -> dict:
        rc, out, err = self.result("jax_keys")
        assert rc == 0, err[-3000:]
        with open(self.jax_keys_path) as f:
            return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def lanes(tmp_path_factory):
    """A capture recorded with the port's ``cli workload record``, then the
    lanes; joined when the module ends."""
    from deepgo_tpu_torch import cli

    tmp = str(tmp_path_factory.mktemp("bench"))
    capture = os.path.join(tmp, "capture")
    cli.main(["workload", "record", "--out", capture, "--requests", "64",
              "--device", "cpu"])
    started = Lanes(tmp, capture)
    yield started
    for t in started.threads:
        t.join(LANE_TIMEOUT_S)


# ---- the contract's pieces, bitwise or equal ----


@pytest.mark.parametrize("prefix", [(4,), (2, 8), (1, 1)])
def test_rand_batch_is_the_jax_bench_s(prefix):
    ours = bench._rand_batch(np.random.default_rng(3), prefix)
    theirs = jax_bench._rand_batch(np.random.default_rng(3), prefix)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def jax_small(cfg_kw=None):
    cfg = jax_policy_cnn.ModelConfig(**(cfg_kw or {"num_layers": 3,
                                                   "channels": 64}))
    return cfg, jax_policy_cnn.init(jax.random.key(0), cfg)


def test_grid_decisive_params_are_the_jax_bench_s():
    jcfg, jparams = jax_small()
    cfg = policy_cnn.ModelConfig(num_layers=3, channels=64)
    model = convert.model_from_jax(jparams, cfg, device="cpu")
    theirs = jax_bench._grid_decisive_params(jcfg, jparams)
    ours = convert.params_to_jax(bench._grid_decisive_params(cfg, model))
    flat_t = jax.tree_util.tree_leaves(theirs)
    flat_o = jax.tree_util.tree_leaves(ours)
    assert len(flat_t) == len(flat_o)
    for a, b in zip(flat_o, flat_t):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", [
    "_METRIC_OF", "DEFAULT_CHAOS_FAULTS", "DEFAULT_FLEET_FAULTS",
    "DEFAULT_DIST_FAULTS", "DEFAULT_LOOP_FAULTS", "DIST_CKPT_INTERVAL",
    "BASELINE_BOARDS_PER_SEC"])
def test_contract_constants_are_the_jax_bench_s(name):
    assert getattr(bench, name) == getattr(jax_bench, name)


# ---- the gate ----

ROOF = {"entries": {"inference_scan/b512": {"mfu": 0.40}}}
BASE = {"metric": "policy_inference_boards_per_sec_per_chip",
        "value": 1000.0, "device": "card", "timestamp": "t",
        "git_sha": "abc", "roofline": ROOF}
DIST = {"metric": "distributed_elastic_recovery_latency_s", "value": 5.0,
        "device": "card", "steps_lost": 3, "roofline": None}


def gate_case(name):
    """(last-good table, fresh result, threshold) of one grid case."""
    fresh = {"metric": BASE["metric"], "value": 990.0, "device": "card",
             "roofline": ROOF}
    table = {BASE["metric"]: BASE}
    if name == "pass":
        pass
    elif name == "fail":
        fresh["value"] = 500.0
    elif name == "warn":
        fresh["value"] = 930.0
    elif name == "noise_widened":
        fresh.update(value=850.0, noise_frac=0.1)
    elif name == "cross_device":
        fresh["device"] = "another card"
    elif name == "missing_baseline":
        table = {}
    elif name == "errored":
        fresh["error"] = "boom"
    elif name == "variant_refused":
        fresh["variant"] = {"name": "int8", "served": False,
                            "tolerance": {"verdict": "fail"}}
    elif name == "variant_passed":
        fresh["variant"] = {"name": "int8", "served": True,
                            "tolerance": {"verdict": "pass"}}
    elif name == "cache_below_target":
        fresh["cache"] = {"speedup": 1.4, "target_speedup": 2.0,
                          "ok": False}
    elif name == "steady_state_compiles":
        fresh["xlacheck"] = {"steady_state_compiles": 2}
    elif name == "mfu_floor":
        fresh["roofline"] = {"entries": {"inference_scan/b512":
                                         {"mfu": 0.20}}}
    elif name.startswith("steps_lost"):
        table = {DIST["metric"]: DIST}
        fresh = {"metric": DIST["metric"], "value": 4.8, "device": "card",
                 "steps_lost": {"steps_lost_within": 20,
                                "steps_lost_past": 24,
                                "steps_lost_no_baseline": 30}[name]}
        if name == "steps_lost_no_baseline":
            table = {DIST["metric"]: {**DIST, "steps_lost": None}}
    else:
        raise AssertionError(name)
    return table, fresh


GATE_CASES = ["pass", "fail", "warn", "noise_widened", "cross_device",
              "missing_baseline", "errored", "variant_refused",
              "variant_passed", "cache_below_target",
              "steady_state_compiles", "mfu_floor", "steps_lost_within",
              "steps_lost_past", "steps_lost_no_baseline"]


def gate_of(module, table_path, fresh, threshold):
    result = copy.deepcopy(fresh)
    args = types.SimpleNamespace(gate=threshold)
    saved = module.LAST_GOOD_PATH
    module.LAST_GOOD_PATH = table_path
    try:
        module._apply_gate(result, args)
        try:
            module._exit_gate(result, args)
            code = 0
        except SystemExit as e:
            code = e.code
    finally:
        module.LAST_GOOD_PATH = saved
    return result.get("gate"), code


@pytest.mark.parametrize("threshold", [0.10, None])
@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_verdicts_are_the_jax_bench_s(case, threshold, tmp_path):
    table, fresh = gate_case(case)
    path = str(tmp_path / "last_good.json")
    with open(path, "w") as f:
        json.dump(table, f)
    ours = gate_of(bench, path, fresh, threshold)
    theirs = gate_of(jax_bench, path, fresh, threshold)
    assert ours == theirs
    if threshold is None:
        assert ours == (None, 0)
    expected = {"pass": "pass", "fail": "fail", "warn": "warn",
                "noise_widened": "warn", "cross_device": "skip",
                "missing_baseline": "skip", "errored": "skip",
                "variant_refused": "fail", "variant_passed": "pass",
                "cache_below_target": "fail",
                "steady_state_compiles": "fail", "mfu_floor": "fail",
                "steps_lost_within": "pass", "steps_lost_past": "fail",
                "steps_lost_no_baseline": "pass"}[case]
    if threshold is not None:
        assert ours[0]["verdict"] == expected
        assert ours[1] == (1 if expected == "fail" else 0)


def test_exit_gate_holds_a_chaos_verdict_as_the_jax_bench_does():
    for verdict in (True, False):
        result = {"chaos_gate": {"pass": verdict}}
        args = types.SimpleNamespace(gate=None)
        codes = []
        for module in (bench, jax_bench):
            try:
                module._exit_gate(result, args)
                codes.append(0)
            except SystemExit as e:
                codes.append(e.code)
        assert codes[0] == codes[1] == (0 if verdict else 1)


# ---- the last-good records and the failure line ----


def test_diagnostic_line_never_reports_the_last_good_value(tmp_path,
                                                           monkeypatch):
    path = str(tmp_path / "last_good.json")
    monkeypatch.setattr(bench, "LAST_GOOD_PATH", path)
    line = json.loads(bench._diagnostic_json("probe failed", "inference"))
    assert line["value"] == 0.0 and line["error"] == "probe failed"
    assert "last_good" not in line and "stale" not in line
    with open(path, "w") as f:
        json.dump({BASE["metric"]: BASE}, f)
    line = json.loads(bench._diagnostic_json("probe failed", "inference"))
    assert line["value"] == 0.0 and "stale" not in line
    assert line["last_good"]["value"] == 1000.0
    assert line["last_good"]["device"] == "card"
    assert line["metric"] == jax_bench._METRIC_OF["inference"][0]


def test_record_last_good_refuses_errors_and_dead_probes(tmp_path,
                                                         monkeypatch):
    path = str(tmp_path / "last_good.json")
    monkeypatch.setattr(bench, "LAST_GOOD_PATH", path)
    ok = {"metric": BASE["metric"], "value": 5.0, "device": "card",
          "probe": {"live": True}}
    for bad in ({"error": "x"}, {"stale": True},
                {"probe": {"live": False}}):
        bench._record_last_good({**ok, **bad})
        assert not os.path.exists(path)
    bench._record_last_good(ok)
    bench._record_last_good({**ok, "metric": "policy_inference_latency_ms",
                             "value": 2.0})
    with open(path) as f:
        table = json.load(f)
    assert table[BASE["metric"]]["value"] == 5.0
    assert table["policy_inference_latency_ms"]["value"] == 2.0
    assert table[BASE["metric"]]["git_sha"] and \
        table[BASE["metric"]]["timestamp"]


@pytest.mark.parametrize("factor,code", [(1.0, None), (10.0, 1)])
def test_main_gates_against_the_previous_record_then_records(
        factor, code, tmp_path, monkeypatch, capsys):
    """The card path of ``main`` with the measurement stubbed: the gate
    reads the table before this run's record is written, and a failed
    gate leaves the table as it was."""
    path = str(tmp_path / "last_good.json")
    monkeypatch.setattr(bench, "LAST_GOOD_PATH", path)
    monkeypatch.setenv("BENCH_PREFLIGHT", "0")
    monkeypatch.setenv("BENCH_WATCHDOG", "0")
    monkeypatch.setenv("DEEPGO_FLIGHT", "0")
    monkeypatch.setattr(bench, "_on_card", lambda device: True)
    monkeypatch.setattr(bench, "_device_label", lambda device: "card")
    monkeypatch.setattr(bench, "_run_mode", lambda args, device, exp: {
        "metric": BASE["metric"], "value": 1000.0, "unit": "boards/sec",
        "noise_frac": 0.0})
    with open(path, "w") as f:
        json.dump({BASE["metric"]: {**BASE, "value": 1000.0 * factor,
                                    "roofline": None}}, f)
    if code is None:
        bench.main(["--mode", "inference", "--gate"])
    else:
        with pytest.raises(SystemExit) as e:
            bench.main(["--mode", "inference", "--gate"])
        assert e.value.code == code
    (line,) = json_lines(capsys.readouterr().out)
    assert line["gate"]["verdict"] == ("pass" if code is None else "fail")
    assert line["gate"]["baseline"] == 1000.0 * factor
    with open(path) as f:
        recorded = json.load(f)[BASE["metric"]]
    # a pass records this run; a fail keeps the previous record
    assert recorded["value"] == 1000.0 * factor
    assert ("timestamp" in recorded) and \
        (recorded["timestamp"] != "t") == (code is None)


@pytest.mark.parametrize("argv,message", [
    (["--mode", "train", "--faults"], "--faults only applies"),
    (["--mode", "latency", "--fleet", "2"], "--fleet only applies"),
    (["--mode", "serving", "--fleet", "1"], "--fleet needs N >= 2"),
    (["--mode", "serving", "--variant", "int4"], "unknown --variant"),
    (["--mode", "serving", "--variant", "int8", "--faults"],
     "--variant applies"),
    (["--mode", "search", "--faults"], "--faults only applies"),
    (["--mode", "loop", "--trace", "X"], "--trace only applies"),
    (["--mode", "bogus"], "invalid choice"),
    (["--mode", "latency", "--device", "tpu"], "--device must be"),
])
def test_argument_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


# ---- the slice against the JAX bench, float32 ----


def port_small(jparams):
    return convert.model_from_jax(jparams, policy_cnn.ModelConfig(
        **SMALL_F32), device="cpu")


def test_inference_body_matches_the_jax_bench_s_run_many():
    jcfg, jparams = jax_small(SMALL_F32)
    data = jax_bench._rand_batch(np.random.default_rng(0), (2, 16))

    def run_many(params, packed, player, rank):  # bench.py's body
        def body(acc, b):
            planes = jax_expand_planes(b[0], b[1], b[2],
                                       dtype=jnp.dtype(jcfg.compute_dtype))
            logits = jax_policy_cnn.apply(params, planes, jcfg)
            return acc + logits.sum(), None

        acc, _ = jax.lax.scan(body, jnp.float32(0), (packed, player, rank))
        return acc

    theirs = float(jax.jit(run_many)(jparams, *data))
    model = port_small(jparams)
    with torch.inference_mode():
        ours = float(bench._run_many(model, model.cfg,
                                     *bench._on_device(CPU, *data)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)


@pytest.mark.parametrize("k_steps", [2, 0])
def test_first_train_call_matches_the_jax_step(k_steps, monkeypatch):
    jcfg, jparams = jax_small(SMALL_F32)
    model = port_small(jparams)  # before the JAX step donates jparams
    batch = 8
    rng = np.random.default_rng(0)
    prefix = (k_steps, batch) if k_steps else (batch,)
    packed, player, rank = jax_bench._rand_batch(rng, prefix)
    target = rng.integers(0, 361, size=prefix).astype(np.int32)
    opt = JAX_OPTIMIZERS["sgd"](0.01, 1e-7, 0.0)
    make = jax_make_train_step_many if k_steps else jax_make_train_step
    _, _, losses = make(jcfg, opt)(
        jparams, opt.init(jparams),
        {"packed": packed, "player": player, "rank": rank,
         "target": target})
    theirs = np.atleast_1d(np.asarray(losses))

    seen = []
    name = "make_train_step_many" if k_steps else "make_train_step"
    made = getattr(bench, name)

    def recording(*args, **kwargs):
        step = made(*args, **kwargs)

        def wrapped(*a):
            out = step(*a)
            seen.append(out[2].detach().reshape(-1).numpy().copy())
            return out

        return wrapped

    monkeypatch.setattr(bench, name, recording)
    monkeypatch.setattr(bench, "_init_params", lambda cfg, device: model)
    sps, ms = bench._time_train_step(policy_cnn.ModelConfig(**SMALL_F32),
                                     batch, k_steps, 1,
                                     np.random.default_rng(0), CPU)
    assert sps > 0 and ms > 0 and len(seen) == 2
    np.testing.assert_allclose(seen[0], theirs, rtol=0, atol=1e-5)


# ---- every ported mode through main, against the JAX bench's keys ----


def test_latency_through_main_in_process(lanes, capsys, monkeypatch):
    for key in ("BENCH_PREFLIGHT", "BENCH_WATCHDOG", "DEEPGO_FLIGHT"):
        monkeypatch.setenv(key, "0")
    bench.main(["--mode", "latency", "--device", "cpu"])
    (line,) = json_lines(capsys.readouterr().out)
    jax_keys = lanes.jax_keys()["latency"]
    assert line["metric"] == jax_keys["metric"]
    assert sorted(line) == jax_keys["keys"]
    assert line["value"] > 0 and line["device"] == "cpu"
    assert set(line["batches"]) == {"batch_16"} and line["reps"] == 5


def check_mode(label: str, line: dict) -> None:
    if label == "serving_faults":
        assert line["restarts"] >= 1
        assert line["submitted"] == sum(line["outcomes"].values())
    elif label == "fleet_faults":
        assert line["submitted"] == sum(line["outcomes"].values())
        assert line["reload"]["ok"] is True and line["reloads"] >= 1
        assert line["failovers"] + line["respawns"] >= 1
        assert set(line["tiers"]) == {"interactive", "selfplay", "batch"}
    elif label == "variant":
        assert line["variant"]["served"] is True
        assert line["variant"]["tolerance"]["verdict"] == "pass"
        assert line["variant"]["throughput_ratio_vs_f32"] > 0
    elif label == "trace":
        assert line["submitted"] == 64 == line["outcomes"]["ok"]
        assert line["cache"]["requests"] == 64
        # a burst replay coalesces repeats in flight; both avoid a forward
        assert line["cache"]["hits"] + line["cache"]["coalesced"] > 0
    elif label == "distributed":
        assert line["recoveries"] == 1 and line["victim_rc"] == -9
        assert line["steps_lost"] <= bench.DIST_CKPT_INTERVAL
        # one rank a host: the reshard layer keeps tp at 1
        assert line["tp_from"] == line["tp_to"] == 1
        assert line["device"] == "cpu (2 simulated elastic hosts)"
    elif label == "large":
        assert set(line["settings"]) == {"remat_true", "remat_false"}
        assert all("samples_per_sec" in s for s in line["settings"].values())
    elif label == "train":
        assert set(line["configs"]) == {"3L/64", "12L/128"}
        assert line["batch"] == 64 and line["steps_per_call"] == 2


@pytest.mark.parametrize("label", list(MODES))
def test_mode_through_main_prints_the_jax_bench_s_line(label, lanes):
    rc, out, err = lanes.result(label)
    assert rc == 0, err[-3000:]
    lines = json_lines(out)
    assert len(lines) == 1, out[-2000:]
    (line,) = lines
    jax_keys = lanes.jax_keys()[MODES[label][1]]
    assert line["metric"] == jax_keys["metric"]
    error = line.pop("error", None)
    anomalies = line.get("anomalies") or {}
    if label == "fleet_faults" and error is not None:
        # ROADMAP C7: the JAX bench's default fleet plan
        # (fleet_route:transient@2) can put both transient route faults on
        # one request, which then has excluded both replicas and resolves
        # as a typed FailoverExhausted; the JAX bench's line says so too
        assert error.startswith("FailoverExhausted"), error
        assert line["outcomes"]["failed"] <= 1
    elif label in ("serving", "variant") and error is not None:
        # ROADMAP C7: the two-sided step / drift detectors on the
        # cumulative dispatch p99 of a clean run; no failure counter moved
        assert error.endswith("telemetry anomalies on a clean run "
                              "(detector must stay silent)"), error
        assert set(anomalies["by_kind"]) <= {"step", "drift"}
        assert anomalies["first"]["metric"] == \
            "deepgo_serving_dispatch_seconds"
    else:
        assert error is None, error
    assert sorted(line) == jax_keys["keys"]
    assert line["value"] > 0
    if label != "distributed":
        assert line["device"] == "cpu"
    check_mode(label, line)


def test_distributed_line_is_the_jax_bench_s_over_the_same_hosts(
        lanes, monkeypatch):
    """Both packages' ``_bench_distributed`` over the same canned host
    output (the hosts' processes replaced): the same line, attribution
    aside."""
    # the bench module's own name only: the lanes' threads run children
    monkeypatch.setattr(bench, "subprocess", types.SimpleNamespace(
        Popen=FakeHost, PIPE=subprocess.PIPE,
        TimeoutExpired=subprocess.TimeoutExpired))
    ours = bench._bench_distributed(bench.DEFAULT_DIST_FAULTS, CPU)
    theirs = lanes.jax_keys()["distributed_canned"]
    ours.pop("attribution")
    assert ours == theirs


@pytest.mark.parametrize("raised", ["oom", "other"])
def test_large_records_an_oom_and_fails_on_anything_else(raised,
                                                         monkeypatch):
    """An OOM of remat off is the trade ``large`` measures and lands in
    ``settings``; any other error of a setting fails the run."""
    error = (torch.OutOfMemoryError("CUDA out of memory") if raised == "oom"
             else RuntimeError("CUDA error: an illegal memory access"))

    def timed(cfg, batch, k_steps, repeats, rng, device):
        if not cfg.remat:
            raise error
        return 1000.0, 16.0

    monkeypatch.setattr(bench, "_time_train_step", timed)
    monkeypatch.setattr(bench.costmodel, "train_entry", lambda *a, **k:
                        types.SimpleNamespace(hbm_peak_bytes=None))
    if raised == "other":
        with pytest.raises(RuntimeError, match="illegal memory access"):
            bench._bench_large(CPU)
        return
    line = bench._bench_large(CPU)
    assert line["value"] == 1000.0 and "error" not in line
    assert line["settings"]["remat_false"]["error"] == \
        "OutOfMemoryError: CUDA out of memory"
    assert line["settings"]["remat_true"]["samples_per_sec"] == 1000.0


def test_cuda_without_a_card_fails_the_probe(tmp_path):
    env = child_env(str(tmp_path))
    env.update(BENCH_PREFLIGHT="1", CUDA_VISIBLE_DEVICES="")
    rc, out, err = run_child(["-m", "deepgo_tpu_torch.bench"], env,
                             timeout=120)
    assert rc == 1, err[-2000:]
    (line,) = json_lines(out)
    assert line["metric"] == "policy_inference_boards_per_sec_per_chip"
    assert line["value"] == 0.0 and "pre-flight" in line["error"]
    assert line["probe"]["live"] is False
    assert not os.path.exists(env["BENCH_LAST_GOOD"])


# ---- the JAX bench's keys, computed in a child ----

RECOVERY = {"recovery_latency_s": 5.5, "detect_latency_s": 5.25,
            "tp_from": 2, "tp_to": 1, "sharding_findings": 0}
DONE = {"recoveries": 1, "steps_lost_total": 4, "final_step": 480,
        "samples_per_sec": 321.5}


class FakeHost:
    """A host process's stand-in: host 0 (the survivor) prints one
    recovery and its summary, host 1 dies by SIGKILL."""

    def __init__(self, cmd, **kwargs):
        self.survivor = cmd[cmd.index("--process-id") + 1] == "0"
        self.returncode = 0 if self.survivor else -9

    def communicate(self, timeout=None):
        if not self.survivor:
            return "", ""
        return ("ELASTIC_RECOVERY " + json.dumps(RECOVERY) + "\n"
                + "ELASTIC_DONE " + json.dumps(DONE) + "\n", "")

    def kill(self):
        pass


def jax_keys_main(out_path: str, capture: str) -> int:
    """The JAX bench's metric and top-level keys per mode at its CPU
    sizes. Its A/B bursts and train timing are stubbed (they fill nested
    blocks only, and its CPU train timing takes minutes); the distributed
    mode runs over ``FakeHost``."""
    import contextlib
    import io

    import bench as jb

    out = {}

    def keep(label, result, extra=("device", "probe")):
        # a run's "error" is its outcome, not the line's shape
        keys = (set(result) | set(extra)) - {"error"}
        out[label] = {"metric": result["metric"], "keys": sorted(keys)}

    keep("latency", jb._bench_latency(False))
    buf = io.StringIO()
    sys.argv = ["bench.py"]
    with contextlib.redirect_stdout(buf):
        jb.main()
    line = json.loads(buf.getvalue().splitlines()[-1])
    keep("inference", line, extra=())
    jb._time_train_step = lambda *a, **k: (1.0, 1.0)
    keep("train", jb._bench_train(False))
    keep("large", jb._bench_large(False))
    ab = lambda *a, **k: {}  # noqa: E731
    jb._tracing_ab = jb._telemetry_ab = jb._workload_ab = ab
    jb._cache_ab = lambda *a, **k: {"ok": True}
    jb._variant_ab = lambda variant, *a, **k: {"name": variant,
                                               "served": True}
    for label, kw in (
            ("serving", {}),
            ("serving_faults", {"faults_spec": jb.DEFAULT_CHAOS_FAULTS}),
            ("fleet_faults", {"faults_spec": jb.DEFAULT_FLEET_FAULTS,
                              "fleet": 2}),
            ("variant", {"variant": "int8+sym"}),
            ("trace", {"trace_capture": capture})):
        keep(label, jb._bench_serving(False, **kw))
        from deepgo_tpu.utils import faults as jax_faults

        # one process per run in the JAX bench: the chaos run's sanitizer
        # switches must not carry into the next run
        jax_faults.reset()
        for key in ("DEEPGO_LOCKCHECK", "DEEPGO_XLACHECK"):
            os.environ.pop(key, None)
    subprocess.Popen = FakeHost
    canned = jb._bench_distributed(jb.DEFAULT_DIST_FAULTS)
    keep("distributed", canned, extra=("device",))
    canned.pop("attribution")
    out["distributed_canned"] = canned
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    assert sys.argv[1] == "jax-keys", sys.argv
    sys.exit(jax_keys_main(sys.argv[2], sys.argv[3]))
