"""Elastic training in the port (``parallel/elastic.py``) and the liveness
layer under it (``parallel/liveness.py``), on the CPU.

The liveness scenarios of tests/test_liveness.py run on both packages'
writer and ledger with a fake clock; their results must agree. The elastic
cases are tests/test_elastic.py's with each simulated host a process of
its own with a local world of one rank: a peer host is simulated through
its heartbeat file alone (detect -> converge -> re-mesh -> resume never
needs a live second process), and the continuation after a recovery is
bitwise the uninterrupted run's. The slow case is the real thing: two host
processes over one run directory (``python tests/test_torch_elastic.py
host ...``), one SIGKILLed by the ``kill`` fault site.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from deepgo_tpu_torch.experiments import checkpoint as ckpt  # noqa: E402
from deepgo_tpu_torch.experiments.experiment import (  # noqa: E402
    Experiment, ExperimentConfig)
from deepgo_tpu_torch.parallel import elastic, liveness  # noqa: E402
from deepgo_tpu_torch.parallel.elastic import (ElasticConfig,  # noqa: E402
                                               run_elastic, shrink_tp)
from deepgo_tpu_torch.parallel.liveness import (  # noqa: E402
    ConfigError, HeartbeatWriter, HostLost)
from deepgo_tpu_torch.utils import faults  # noqa: E402
from deepgo_tpu_torch.utils.metrics import read_jsonl  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def private_jax_registry():
    """The JAX package's calls in this file count into a metrics registry
    of their own. Its process-wide one feeds the ``obs_snapshot`` of every
    later JAX run in this worker, and tests/test_attribution.py holds its
    run's train-step total to its own 30 steps."""
    from deepgo_tpu.obs import registry as jax_registry

    saved = jax_registry._default
    jax_registry._default = jax_registry.MetricsRegistry()
    yield
    jax_registry._default = saved


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DEEPGO_FAULTS", raising=False)
    faults.reset()
    yield
    faults.reset()


# ---- liveness: the JAX tests' scenarios on both packages ----


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _modules():
    from deepgo_tpu.obs import MetricsRegistry as JaxRegistry
    from deepgo_tpu.parallel import liveness as jax_liveness
    from deepgo_tpu.utils import faults as jax_faults

    from deepgo_tpu_torch.obs import MetricsRegistry

    return {"port": (liveness, faults, MetricsRegistry),
            "jax": (jax_liveness, jax_faults, JaxRegistry)}


def _lost(lv, ledger, expected, now=None) -> dict | None:
    try:
        ledger.check_liveness(expected, now=now)
    except lv.HostLost as e:
        return {"process_id": e.process_id, "last_seen": e.last_seen,
                "silent_for_s": round(e.silent_for_s, 9),
                "budget_s": e.budget_s, "last_step": e.last_step,
                "message": str(e)}
    return None


def _liveness_scenarios(lv, flt, registry_cls, root) -> dict:
    out = {}
    d = os.path.join(root, "writer")
    clock = FakeClock()
    w = lv.HeartbeatWriter(d, 3, clock=clock)
    w.beat(40, step_latency_s=0.25)
    first = json.loads(open(w.path).read())
    clock.advance(2.0)
    w.beat(45)
    out["writer"] = (first, json.loads(open(w.path).read()), w.beats,
                     sorted(os.listdir(d)))

    flt.install("heartbeat:transient@2")
    w = lv.HeartbeatWriter(os.path.join(root, "transient"), 0,
                           clock=FakeClock())
    out["transient"] = (w.beat(1), w.misses, w.beats)
    flt.install("heartbeat:fail@1")
    w = lv.HeartbeatWriter(os.path.join(root, "hard"), 0, clock=FakeClock())
    out["hard"] = (w.beat(1), w.misses, w.beats, w.beat(2))
    flt.reset()

    d = os.path.join(root, "budget")
    clock = FakeClock()
    w = lv.HeartbeatWriter(d, 1, clock=clock)
    ledger = lv.HeartbeatLedger(d, interval_s=1.0, miss_budget=3,
                                clock=clock)
    w.beat(10)
    clock.advance(3.0)
    out["at_budget"] = _lost(lv, ledger, {1})
    clock.advance(0.01)
    out["past_budget"] = _lost(lv, ledger, {1})

    clock = FakeClock()
    ledger = lv.HeartbeatLedger(os.path.join(root, "never"), interval_s=0.5,
                                miss_budget=4, clock=clock)
    ledger.poll()
    clock.advance(1.9)
    out["never_grace"] = _lost(lv, ledger, {7})
    clock.advance(0.2)
    out["never_lost"] = _lost(lv, ledger, {7})

    d = os.path.join(root, "longest")
    clock = FakeClock()
    lv.HeartbeatWriter(d, 1, clock=clock).beat(5)
    clock.advance(2.0)
    lv.HeartbeatWriter(d, 2, clock=clock).beat(5)
    clock.advance(10.0)
    out["longest"] = _lost(lv, lv.HeartbeatLedger(
        d, interval_s=1.0, miss_budget=3, clock=clock), {1, 2})

    d = os.path.join(root, "corrupt")
    clock = FakeClock()
    lv.HeartbeatWriter(d, 0, clock=clock).beat(1)
    with open(os.path.join(d, lv.heartbeat_name(1)), "w") as f:
        f.write('{"process_id": 1, "time": ')
    logged = []
    ledger = lv.HeartbeatLedger(d, interval_s=1.0, miss_budget=2,
                                clock=clock, log=logged.append)
    out["corrupt_read"] = (sorted(ledger.read()),
                           any("skipping" in m for m in logged))
    clock.advance(2.01)
    out["corrupt_lost"] = _lost(lv, ledger, {1}) is not None

    d = os.path.join(root, "straggler")
    clock = FakeClock()
    reg = registry_cls()
    fast = lv.HeartbeatWriter(d, 0, clock=clock)
    slow = lv.HeartbeatWriter(d, 1, clock=clock)
    ledger = lv.HeartbeatLedger(d, interval_s=1.0, miss_budget=3,
                                clock=clock, registry=reg)
    for step in range(4):
        fast.beat(step, step_latency_s=0.01)
        slow.beat(step, step_latency_s=0.10)
        ledger.poll()
        clock.advance(0.5)
    report = ledger.straggler_report(factor=3.0, min_beats=3)
    gauge = reg.gauge("deepgo_straggler_ratio")
    out["straggler"] = ([(s.process_id, s.latency_s, str(s)) for s in report],
                        ledger.straggler_report(factor=50.0),
                        round(gauge.value(host="1"), 6),
                        round(gauge.value(host="0"), 6))
    snap = ledger.snapshot()
    out["snapshot"] = (snap["budget_s"], sorted(snap["hosts"]),
                       snap["hosts"][1]["step"])

    for kw in ({"interval_s": 0.0}, {"miss_budget": 0}):
        try:
            lv.HeartbeatLedger("x", **kw)
        except lv.ConfigError as e:
            out.setdefault("config_errors", []).append(str(e))
    return out


def test_liveness_scenarios_agree_with_jax(tmp_path):
    results = {name: _liveness_scenarios(*mods, str(tmp_path / name))
               for name, mods in _modules().items()}
    port = results["port"]
    assert port == results["jax"]
    assert port["writer"][0] == {"process_id": 3, "beat": 0, "step": 40,
                                 "time": 1000.0, "step_latency_s": 0.25}
    assert port["transient"] == (True, 0, 1)
    assert port["hard"] == (False, 1, 0, True)
    assert port["at_budget"] is None
    assert port["past_budget"]["last_step"] == 10
    assert port["never_grace"] is None
    assert port["never_lost"]["last_step"] is None
    assert port["longest"]["process_id"] == 1
    assert port["corrupt_read"] == ([0], True) and port["corrupt_lost"]
    assert [s[0] for s in port["straggler"][0]] == [1]
    assert port["straggler"][2] == pytest.approx(10.0)
    assert len(port["config_errors"]) == 2


def test_error_family_is_typed_and_routable():
    for cls in (liveness.ConfigError, liveness.HostLost,
                liveness.StragglerDetected, liveness.CoordinatorUnreachable):
        assert issubclass(cls, liveness.DistributedError)
        assert issubclass(cls, RuntimeError)
    assert issubclass(liveness.CoordinatorUnreachable, OSError)
    assert issubclass(liveness.ConfigError, ValueError)


# ---- re-mesh and the shrink policy ----


def test_remesh_single_process_spans_the_local_world():
    mesh = elastic.remesh(1, survivors={0})
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ConfigError, match="n_model"):
        elastic.remesh(2, survivors={0, 1})  # one rank cannot hold tp=2


@pytest.mark.parametrize("tp,alive,expected", [
    (2, 1, 2), (4, 2, 4), (4, 1, 4), (4, 3, 4), (4, 1, 2), (2, 3, 4),
    (1, 1, 8), (2, 2, 2), (2, 5, 2)])
def test_shrink_tp_is_jax_s_policy(tp, alive, expected):
    from deepgo_tpu.parallel.elastic import shrink_tp as jax_shrink_tp

    got = shrink_tp(tp, alive, expected)
    assert got == jax_shrink_tp(tp, alive, expected)
    assert tp % got == 0


# ---- config validation ----


def test_elastic_config_validation_is_typed(tmp_path):
    with pytest.raises(ConfigError, match="expected_hosts"):
        run_elastic(str(tmp_path), 5, ecfg=ElasticConfig(expected_hosts=0),
                    device="cpu")
    with pytest.raises(ConfigError, match="process_id"):
        run_elastic(str(tmp_path), 5,
                    ecfg=ElasticConfig(process_id=2, expected_hosts=2),
                    device="cpu")


# ---- elastic runs ----


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from deepgo_tpu_torch.data.transcribe import transcribe_split

    root = tmp_path_factory.mktemp("processed")
    for split in ("validation", "test"):
        transcribe_split(os.path.join(REPO, "data/sgf", split),
                         str(root / split), workers=1, verbose=False)
    return str(root)


def tiny_overrides(data_root, **kw):
    """tests/test_elastic.py's tiny config, on a local world of one rank."""
    defaults = dict(
        name="elastic-test", num_layers=2, channels=8, batch_size=8,
        rate=0.05, validation_size=16, validation_interval=5,
        print_interval=5, data_root=data_root, train_split="validation",
        validation_split="test", test_split="test", loader_threads=0,
        data_parallel=1, keep_checkpoints=0)
    defaults.update(kw)
    return defaults


def silent_peer(run_dir: str) -> None:
    """Host 1's only sign of life: one beat a minute ago. (The port's tiny
    steps outrun the miss budget's wall time, so a beat written now could
    still be fresh at the first liveness check.)"""
    import time

    HeartbeatWriter(os.path.join(run_dir, "heartbeats"), 1,
                    clock=lambda: time.time() - 60.0).beat(0)


def _records(out: str, tag: str) -> list:
    return [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
            if line.startswith(tag + " ")]


def test_single_host_elastic_completes_and_is_idempotent(data_root, tmp_path,
                                                         capsys):
    run_dir = str(tmp_path / "run")
    ecfg = ElasticConfig(process_id=0, expected_hosts=1,
                         heartbeat_interval_s=0.2, miss_budget=3)
    summary = run_elastic(run_dir, 10, overrides=tiny_overrides(data_root),
                          ecfg=ecfg, device="cpu")
    assert summary["final_step"] == 10
    assert summary["recoveries"] == 0 and summary["steps_lost_total"] == 0
    assert summary["survivors"] == [0] and summary["heartbeats"] >= 1
    assert os.path.exists(os.path.join(run_dir, "heartbeats",
                                       "heartbeat-0000.json"))
    kinds = [r["kind"] for r in
             read_jsonl(os.path.join(run_dir, "elastic-0000.jsonl"))]
    assert kinds[0] == "elastic_start" and "elastic_done" in kinds
    done = _records(capsys.readouterr().out, "ELASTIC_DONE")
    assert done[-1]["final_step"] == 10
    assert ckpt.load_meta(summary["checkpoint"])["config"]["elastic"] is True
    # the iteration count is the TOTAL target: a re-run is a no-op
    again = run_elastic(run_dir, 10, overrides=tiny_overrides(data_root),
                        ecfg=ecfg, device="cpu")
    assert again["final_step"] == 10 and again["recoveries"] == 0


def test_host_loss_before_any_checkpoint_recovers_fresh(data_root, tmp_path,
                                                        capsys):
    run_dir = str(tmp_path / "run")
    silent_peer(run_dir)
    ecfg = ElasticConfig(process_id=0, expected_hosts=2,
                         heartbeat_interval_s=0.05, miss_budget=4)
    # validation_interval=10: the first window (step 5) has no checkpoint
    summary = run_elastic(
        run_dir, 15, overrides=tiny_overrides(data_root,
                                              validation_interval=10),
        ecfg=ecfg, device="cpu")
    assert summary["final_step"] == 15 and summary["recoveries"] == 1
    assert summary["survivors"] == [0]
    assert summary["steps_lost_total"] == 5  # detected at 5, restart at 0
    rec = _records(capsys.readouterr().out, "ELASTIC_RECOVERY")[0]
    assert rec["process_id"] == 1 and rec["step_at_detection"] == 5
    assert rec["resumed_step"] == 0 and rec["steps_lost"] == 5
    assert rec["silent_for_s"] > ecfg.heartbeat_interval_s * ecfg.miss_budget
    assert rec["per_host_batch"] == 8 and rec["sharding_findings"] == 0
    kinds = [r["kind"] for r in
             read_jsonl(os.path.join(run_dir, "elastic-0000.jsonl"))]
    assert kinds.count("host_lost") == 1 and kinds.count("recovery") == 1


def test_recovery_converges_on_checkpoint_bit_exact(data_root, tmp_path):
    lossy = str(tmp_path / "lossy")
    silent_peer(lossy)
    summary = run_elastic(
        lossy, 15, overrides=tiny_overrides(data_root),
        ecfg=ElasticConfig(process_id=0, expected_hosts=2,
                           heartbeat_interval_s=0.05, miss_budget=4),
        device="cpu")
    assert summary["recoveries"] == 1
    assert summary["steps_lost_total"] == 0  # checkpoint@5, detection@5
    assert summary["final_step"] == 15
    ref = run_elastic(str(tmp_path / "clean"), 15,
                      overrides=tiny_overrides(data_root),
                      ecfg=ElasticConfig(process_id=0, expected_hosts=1),
                      device="cpu")
    assert ref["recoveries"] == 0
    meta_l, p_l, o_l = ckpt.load_checkpoint(summary["checkpoint"])
    meta_c, p_c, o_c = ckpt.load_checkpoint(ref["checkpoint"])
    assert meta_l["step"] == meta_c["step"] == 15
    for a, b in zip(p_l + o_l, p_c + o_c):
        np.testing.assert_array_equal(a, b)
    assert meta_l["ewma"] == meta_c["ewma"]


def test_obs_port_healthz_flips_on_peer_silence_and_recovers(
        data_root, tmp_path, monkeypatch):
    """An elastic host's ``/healthz`` (``ElasticConfig.obs_port``) on a fake
    clock: 200 while host 1's silence is inside the 3 s miss budget, 503
    the moment it passes it (and through the recovery), 200 again once
    the host has resumed from the converged checkpoint without host 1."""
    import urllib.error
    import urllib.request

    run_dir = str(tmp_path / "run")
    now = {"t": 1000.0}

    def clock():
        return now["t"]

    HeartbeatWriter(os.path.join(run_dir, "heartbeats"), 1,
                    clock=clock).beat(0)
    exporters, seen = [], []
    real_start = elastic.start_exporter

    def start(port):
        exporters.append(real_start(port))
        return exporters[-1]

    def healthz():
        url = exporters[0].url + "/healthz"
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    class ScrapingWriter(HeartbeatWriter):
        """Host 0's writer: scrape /healthz after every beat; at the
        first window move the clock to just inside, then just past, host
        1's budget."""

        def beat(self, step, step_latency_s=None):
            out = super().beat(step, step_latency_s)
            if step == 5 and not any(s[0] == "inside" for s in seen):
                now["t"] = 1000.0 + 2.9
                seen.append(("inside", step, *healthz()))
                now["t"] = 1000.0 + 3.1
                seen.append(("past", step, *healthz()))
            else:
                seen.append(("beat", step, *healthz()))
            return out

    def log(msg):
        if "converging" in msg:
            seen.append(("detected", None, *healthz()))

    monkeypatch.setattr(elastic, "start_exporter", start)
    monkeypatch.setattr(elastic, "HeartbeatWriter", ScrapingWriter)
    summary = run_elastic(
        run_dir, 10, overrides=tiny_overrides(data_root),
        ecfg=ElasticConfig(process_id=0, expected_hosts=2,
                           heartbeat_interval_s=1.0, miss_budget=3,
                           obs_port=0),
        clock=clock, log=log, device="cpu")
    assert summary["recoveries"] == 1 and summary["final_step"] == 10
    assert [(what, step, code) for what, step, code, _ in seen[:6]] == [
        ("beat", 0, 200), ("inside", 5, 200), ("past", 5, 503),
        ("detected", None, 503), ("beat", 5, 200), ("beat", 10, 200)]
    past = seen[2][3]["components"]["heartbeats"]
    assert past["lost_process_id"] == 1 and past["budget_s"] == 3.0
    assert past["silent_for_s"] == pytest.approx(3.1)
    detected = seen[3][3]["components"]["heartbeats"]
    assert detected["recovering"] is True
    assert detected["lost_process_id"] == 1
    assert all(code == 200 for _, _, code, _ in seen[4:])
    assert exporters[0]._closed  # closed when run_elastic returns


def test_recovery_budget_exhaustion_surfaces_host_lost(data_root, tmp_path):
    run_dir = str(tmp_path / "run")
    silent_peer(run_dir)
    with pytest.raises(HostLost):
        run_elastic(run_dir, 15, overrides=tiny_overrides(data_root),
                    ecfg=ElasticConfig(process_id=0, expected_hosts=2,
                                       heartbeat_interval_s=0.05,
                                       miss_budget=4, max_recoveries=0),
                    device="cpu")


def test_dist_collective_site_threaded_only_when_elastic(data_root,
                                                         tmp_path):
    faults.install("dist_collective:fail@1")
    exp = Experiment(ExperimentConfig(run_dir=str(tmp_path / "a"),
                                      elastic=True,
                                      **tiny_overrides(data_root)),
                     device="cpu")
    with pytest.raises(faults.InjectedFailure):
        exp.run(2)
    faults.install("dist_collective:fail@1")
    exp = Experiment(ExperimentConfig(run_dir=str(tmp_path / "b"),
                                      **tiny_overrides(data_root)),
                     device="cpu")
    exp.run(2)  # non-elastic runs never consult the site
    assert exp.step == 2


# ---- the real thing: two host processes, one SIGKILL ----


def run_host(rundir, data_root, *, host=0, hosts=1, iters=2000,
             faults_env=None, budget=(0.5, 8)):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DEEPGO_FAULTS")}
    env.update(OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    if faults_env:
        env["DEEPGO_FAULTS"] = faults_env
    interval, miss = budget
    cmd = [sys.executable, os.path.abspath(__file__), "host", rundir,
           data_root, str(host), str(hosts), str(iters), str(interval),
           str(miss)]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def host_main(argv) -> int:
    """One elastic host: ``host RUN_DIR DATA_ROOT HOST HOSTS ITERS
    INTERVAL MISS``; the overrides are those of the chaos test."""
    run_dir, data_root = argv[0], argv[1]
    host, hosts, iters = int(argv[2]), int(argv[3]), int(argv[4])
    interval, miss = float(argv[5]), int(argv[6])
    run_elastic(run_dir, iters,
                overrides=tiny_overrides(data_root, name="elastic-chaos",
                                         validation_interval=100),
                ecfg=ElasticConfig(process_id=host, expected_hosts=hosts,
                                   heartbeat_interval_s=interval,
                                   miss_budget=miss, init_deadline_s=120,
                                   step_deadline_s=300),
                device="cpu")
    return 0


@pytest.mark.slow
def test_two_host_sigkill_chaos_recovers_bit_exact(data_root, tmp_path):
    """Two elastic hosts over one shared run dir; host 1 is SIGKILLed by
    the ``kill`` fault site after its step-5 beat. The survivor detects
    the loss within the miss budget (modulo its window cadence),
    converges on the latest valid checkpoint, resumes, and lands on a
    final state bitwise the uninterrupted single host's."""
    shared = str(tmp_path / "fleet")
    # the survivor must still be training when the loss is declared: at
    # the port's ~200 CPU steps/s, 2,000 steps outlast the 4 s budget
    iters, interval, miss = 2000, 0.5, 8
    budget_s = interval * miss
    procs = [run_host(shared, data_root, host=0, hosts=2, iters=iters,
                      budget=(interval, miss)),
             run_host(shared, data_root, host=1, hosts=2, iters=iters,
                      faults_env="kill:step@7", budget=(interval, miss))]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    (rc0, out0, err0), (rc1, _, err1) = outs
    assert rc1 == -9, (rc1, err1[-800:])
    assert rc0 == 0, (rc0, err0[-2000:])
    done = _records(out0, "ELASTIC_DONE")
    recs = _records(out0, "ELASTIC_RECOVERY")
    assert done and done[-1]["final_step"] == iters
    assert recs, "survivor never reported a recovery"
    rec = recs[0]
    assert rec["process_id"] == 1 and rec["survivors"] == [0]
    assert budget_s < rec["detect_latency_s"] < budget_s + 20.0
    assert rec["resumed_step"] <= rec["step_at_detection"]

    ref_dir = str(tmp_path / "ref")
    ref = run_host(ref_dir, data_root, iters=iters, budget=(interval, miss))
    _, ref_err = ref.communicate(timeout=300)
    assert ref.returncode == 0, ref_err[-2000:]
    meta_s, p_s, o_s = ckpt.load_checkpoint(
        os.path.join(shared, ckpt.checkpoint_name(iters)))
    meta_r, p_r, o_r = ckpt.load_checkpoint(
        os.path.join(ref_dir, ckpt.checkpoint_name(iters)))
    for a, b in zip(p_s + o_s, p_r + o_r):
        np.testing.assert_array_equal(a, b)
    assert meta_s["ewma"] == meta_r["ewma"]


if __name__ == "__main__":
    torch.set_num_threads(2)
    assert sys.argv[1] == "host", sys.argv
    sys.exit(host_main(sys.argv[2:]))
