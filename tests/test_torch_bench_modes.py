"""The port's bench modes ``loop``, ``search``, ``mixed`` and ``chaos``
(``deepgo_tpu_torch.bench``) against the JAX package's ``bench.py`` on the
CPU, at the JAX bench's CPU sizes.

* bitwise: ``_mixed_script(i)`` for i = 0..3; ``_parse_child_protocol`` on
  crafted text and on the output of one real port session child;
* equal: ``DEFAULT_LOOP_FAULTS`` and the four modes' metric and unit;
* each mode through ``main`` with ``--device cpu`` (``loop`` also with
  ``--faults``), beside the JAX bench's own run of the same mode: both
  print one JSON line with the same metric, the same top-level keys and
  the same keys in the nested blocks, and the port's line holds the facts
  that do not depend on timing (no answer lost or wrong, no acked move
  lost, bit-identical resumes, the windows' bit-exact replay). Both
  packages' runs are child processes, started in a few lanes with the
  first test. SLO verdicts, hit rates and rates are timing and are not
  asserted here.
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from conftest import REPO_ROOT  # first: run as a script, it puts the repo
import bench as jax_bench  # noqa: E402, I001 — on the path for this import

from deepgo_tpu_torch import bench

torch.set_num_threads(2)

LANE_TIMEOUT_S = 400
JAX_BENCH = os.path.join(REPO_ROOT, "bench.py")

# label -> the bench's argv (--device cpu is added for the port)
MODES = {
    "search": ["--mode", "search"],
    "chaos": ["--mode", "chaos"],
    "mixed": ["--mode", "mixed"],
    "loop": ["--mode", "loop"],
    "loop_faults": ["--mode", "loop", "--faults"],
}
# (package, label) per lane, each lane's runs one after the other; three
# children of one compute thread each at a time, balanced on their CPU
# times (the JAX runs take 15-40 s, the port's 4-26 s)
LANES = ((("jax", "chaos"), ("port", "mixed"), ("port", "loop")),
         (("jax", "mixed"), ("port", "chaos")),
         (("jax", "loop"), ("jax", "loop_faults"), ("jax", "search"),
          ("port", "loop_faults"), ("port", "search")))
CHAOS_LEGS = {"acceptance", "brownout_on", "brownout_off", "cache_reload",
              "surge"}


def child_env(tmp: str) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DEEPGO_FAULTS", "DEEPGO_LOCKCHECK",
                        "DEEPGO_XLACHECK")}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", DEEPGO_FLIGHT="0",
               DEEPGO_FLIGHT_DIR=tmp, BENCH_PREFLIGHT="0",
               BENCH_WATCHDOG="0",
               BENCH_LAST_GOOD=os.path.join(tmp, "last_good.json"))
    return env


def json_lines(stdout: str) -> list:
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]


class Lanes:
    """Children started together: each lane runs its benches in order in
    a thread; ``result(package, label)`` waits for one."""

    def __init__(self, tmp: str):
        self.env = child_env(tmp)
        self.results: dict = {}
        self.done = {job: threading.Event() for lane in LANES
                     for job in lane}
        self.threads = [threading.Thread(target=self._run, args=(lane,),
                                         daemon=True) for lane in LANES]
        for t in self.threads:
            t.start()

    @staticmethod
    def argv(package: str, label: str) -> list:
        if package == "jax":
            return [JAX_BENCH, *MODES[label]]
        return ["-m", "deepgo_tpu_torch.bench", *MODES[label], "--device",
                "cpu"]

    def _run(self, lane) -> None:
        for job in lane:
            try:
                proc = subprocess.run(
                    [sys.executable, *self.argv(*job)], cwd=REPO_ROOT,
                    env=self.env, capture_output=True, text=True,
                    timeout=LANE_TIMEOUT_S)
                self.results[job] = (proc.returncode, proc.stdout,
                                     proc.stderr)
            except subprocess.TimeoutExpired as e:
                self.results[job] = (None, "", f"timed out: {e}")
            finally:
                self.done[job].set()

    def result(self, package: str, label: str) -> tuple:
        job = (package, label)
        assert self.done[job].wait(LANE_TIMEOUT_S), f"{job} never ended"
        return self.results[job]


@pytest.fixture(scope="module", autouse=True)
def lanes(tmp_path_factory):
    started = Lanes(str(tmp_path_factory.mktemp("bench_modes")))
    yield started
    for t in started.threads:
        t.join(LANE_TIMEOUT_S)


# ---- the contract's pieces, bitwise or equal ----


@pytest.mark.parametrize("i", range(4))
def test_mixed_script_is_the_jax_bench_s(i):
    ours = bench._mixed_script(i)
    assert ours == jax_bench._mixed_script(i)
    assert len(ours) == 361 == len(set(ours))


CHILD_TEXTS = {
    "full": ("SESSION_RESUMED 0\nSESSION_ACK bench-00 2\n"
             "SESSION_ACK bench-00 3\nSESSION_DIGEST bench-00 ab12\n"
             "SESSION_ACK bench-01 5\nSESSION_DIGEST bench-01 cd34\n"),
    "killed": "SESSION_RESUMED 1\nSESSION_ACK bench-01 7\n",
    "noise": ("\n  \nTraceback (most recent call last):\nSESSION_ACK x\n"
              "SESSION_ACK a 1 extra\nSESSION_DIGEST only\n"
              "SESSION_RESUMED\nSESSION_RESUMED 2\nsession_ack a 3\n"
              "SESSION_ACK s 4\n"),
    "empty": "",
}


@pytest.mark.parametrize("name", list(CHILD_TEXTS))
def test_parse_child_protocol_is_the_jax_bench_s(name):
    text = CHILD_TEXTS[name]
    ours = bench._parse_child_protocol(text)
    assert ours == jax_bench._parse_child_protocol(text)
    if name == "noise":
        assert ours == {"acks": [("s", 4)], "digests": {}, "resumed": 2}


@pytest.mark.parametrize("kill_after", [None, 3])
def test_parse_child_protocol_reads_a_port_child(kill_after, tmp_path):
    """One real ``deepgo_tpu_torch.sessions.child`` on the CPU, run to its
    end or SIGKILLed after its third ack: both parsers read its stdout
    alike."""
    argv = [sys.executable, "-m", "deepgo_tpu_torch.sessions.child",
            "--store", str(tmp_path / "store"), "--games", "2", "--moves",
            "2", "--device", "cpu"]
    if kill_after is not None:
        argv += ["--kill-after-acks", str(kill_after)]
    proc = subprocess.run(argv, cwd=REPO_ROOT, env=child_env(str(tmp_path)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == (0 if kill_after is None else -9), \
        proc.stderr[-2000:]
    ours = bench._parse_child_protocol(proc.stdout)
    assert ours == jax_bench._parse_child_protocol(proc.stdout)
    assert ours["resumed"] == 0
    if kill_after is None:
        assert set(ours["digests"]) == {"bench-00", "bench-01"}
        assert len(ours["acks"]) == 8
    else:
        assert len(ours["acks"]) == kill_after and not ours["digests"]


@pytest.mark.parametrize("mode", ["loop", "search", "mixed", "chaos"])
def test_metric_and_unit_are_the_jax_bench_s(mode):
    assert bench._METRIC_OF[mode] == jax_bench._METRIC_OF[mode]


def test_default_loop_faults_is_the_jax_bench_s():
    assert bench.DEFAULT_LOOP_FAULTS == jax_bench.DEFAULT_LOOP_FAULTS


@pytest.mark.parametrize("argv,faults", [
    (["--mode", "loop", "--faults"], bench.DEFAULT_LOOP_FAULTS),
    (["--mode", "loop", "--faults", "train_step:fail@2"],
     "train_step:fail@2"),
    (["--mode", "chaos", "--trace", "cap"], None),
])
def test_check_args_accepts_the_new_modes_options(argv, faults):
    ap = bench._parser()
    args = ap.parse_args(argv)
    bench._check_args(ap, args)
    assert args.faults == faults


def test_deterministic_kernels_are_restored_after_the_run(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = torch.are_deterministic_algorithms_enabled()
    with bench._deterministic_kernels():
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert torch.are_deterministic_algorithms_enabled() == before
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


# ---- every mode through main, beside the JAX bench's run ----


def keys(block) -> list | None:
    return sorted(block) if isinstance(block, dict) else None


def nested(label: str, line: dict) -> dict:
    """The nested block keys the two lines must share."""
    if label == "chaos":
        return {leg: {"leg": keys(r), **{b: keys(r[b]) for b in (
            "slo", "answers", "counters", "canary", "cache")}}
            for leg, r in line["chaos"].items()} | {
            "trace": keys(line["trace"])}
    if label == "mixed":
        return {b: keys(line[b]) for b in (
            "interactive", "analysis", "crash_resume", "scenario")}
    if label == "search":
        return {"clean": keys(line["clean"]),
                "transposition": keys(line["clean"]["transposition"]),
                "chaos": keys(line["chaos"])}
    out = {b: keys(line.get(b)) for b in ("lockcheck", "xlacheck",
                                           "anomalies")}
    # the component classes the faults killed (which actor ingests the
    # second game is timing)
    out["restarted"] = sorted({name.split("-")[0]
                               for name in line["component_restarts"]})
    return out


def check_facts(label: str, line: dict) -> None:
    """The port's timing-free facts (phase 15 holds the same on the
    card)."""
    if label == "search":
        assert len(line["clean"]["moves"]) == line["clean"]["searches"] == 4
        assert line["clean"]["lost"] == 0
        assert line["chaos"]["move_lost"] == 0
        assert line["chaos"]["move"] >= 0
    elif label == "chaos":
        assert set(line["chaos"]) == CHAOS_LEGS
        for leg in line["chaos"].values():
            assert leg["answers"]["lost"] == leg["answers"]["wrong"] == 0
        assert line["chaos"]["cache_reload"]["cache"]["stale_hits"] == 0
        assert [r["platform"] for r in line["chaos"]["surge"]["replicas"]] \
            == ["cpu", "cpu"]
    elif label == "mixed":
        crash = line["crash_resume"]
        assert crash["victim_rc"] == -9
        assert crash["victim_acks"] == crash["kill_after_acks"] == 9
        assert crash["lost_acked"] == 0 and crash["bit_identical"]
        assert crash["resumed_sessions"] >= 1
        assert line["interactive"]["sessions"] == 3
    else:
        assert line["games_lost"] == 0 and line["resume_bitexact"]
        assert line["windows"] == line["windows_replayed"] == 3
        assert line["champion_newer"] and line["gates_passed"] == 3
        assert line["games_acked"] == line["games_durable"] > 0
        if label == "loop_faults":
            assert line["faults"] == bench.DEFAULT_LOOP_FAULTS
            assert line["lockcheck"]["cycles"] == 0
            assert line["xlacheck"]["transfer_violations"] == 0
            assert line["fleet_respawns"] + line["fleet_failovers"] >= 1
            # one restart per injected kill
            assert sorted(line["component_restarts"].values()) == [1, 1, 1]
        else:
            assert line["component_restarts"] == {}


@pytest.mark.parametrize("label", list(MODES))
def test_mode_through_main_prints_the_jax_bench_s_line(label, lanes):
    rc, out, err = lanes.result("port", label)
    lines = json_lines(out)
    assert len(lines) == 1, (rc, out[-2000:], err[-3000:])
    (line,) = lines
    j_rc, j_out, j_err = lanes.result("jax", label)
    j_lines = json_lines(j_out)
    assert len(j_lines) == 1, (j_rc, j_out[-2000:], j_err[-3000:])
    (theirs,) = j_lines
    assert line["metric"] == theirs["metric"]
    assert line["unit"] == theirs["unit"]
    assert line["device"] == "cpu"
    # a run's "error" is its outcome, not the line's shape
    error = line.pop("error", None)
    theirs.pop("error", None)
    assert sorted(line) == sorted(theirs)
    assert nested(label, line) == nested(label, theirs)
    check_facts(label, line)
    gate = line.get("chaos_gate")
    if gate is not None:
        # the verdict decides the exit code; its reasons may be timing
        # here (an SLO under a loaded CPU, a search done before the kill)
        assert rc == (0 if gate["pass"] else 1), err[-3000:]
        assert (error is None) == gate["pass"]
    else:
        assert rc == 0, err[-3000:]
        # the one timing-dependent loop check: a soak shorter than a few
        # telemetry ticks may end before the detector sees a kill
        assert error in (None, "chaos kills produced no telemetry "
                               "anomaly"), error
        assert line["value"] > 0
