"""The port's process-group layer (``parallel/distributed.py``,
``parallel/deadlines.py``, ``utils/watchdog.py``) and multi-rank
``Experiment`` runs, on the CPU.

Single-process paths first: the ``initialize`` no-op and its typed
refusals, the hybrid mesh's hosts-major order and survivors filter (the
same fake pod through both packages gives the same grid), the per-process
batch arithmetic, this rank's rows of a global batch with its fault site,
and the deadline and watchdog scenarios of tests/test_deadlines.py and
tests/test_watchdog.py run on both packages, whose results must agree.

Then two gloo ranks (one process each, a ``file://`` rendezvous): a
data-parallel train step whose two losses are equal; ``Experiment`` runs
of 10 steps at ``data_parallel=2`` and at ``tensor_parallel=2`` (sharded
validation, checkpoints gathered and written by rank 0) against the
port's single-device run of the same config, step-indexed so the global
batches are the single device's (EWMA within rtol 1e-5, parameters within
rtol 1e-4 / atol 1e-6, validation NLL within 1e-5); and a JAX 4 x 2
checkpoint restored under 2 x 1, bitwise.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from deepgo_tpu_torch.experiments import checkpoint as ckpt  # noqa: E402
from deepgo_tpu_torch.experiments.experiment import (  # noqa: E402
    Experiment, ExperimentConfig)
from deepgo_tpu_torch.parallel import deadlines, distributed  # noqa: E402
from deepgo_tpu_torch.parallel.liveness import (  # noqa: E402
    ConfigError, CoordinatorUnreachable)
from deepgo_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from deepgo_tpu_torch.utils import faults, watchdog  # noqa: E402

from test_torch_parallel import (assert_bitwise, jax_checkpoint_4x2,  # noqa: E402
                                 port_leaves, rank_main, spawn_ranks)

torch.set_num_threads(2)

EWMA_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
VAL_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DEEPGO_FAULTS", raising=False)
    faults.reset()
    yield
    faults.reset()


# ---- initialize ----


def test_initialize_single_process_is_a_noop():
    distributed.initialize(device="cpu")
    distributed.initialize(num_processes=1, device="cpu")
    assert distributed.world_size() == 1 and distributed.process_index() == 0
    assert not torch.distributed.is_initialized()


def test_initialize_refuses_what_cannot_work():
    with pytest.raises(ConfigError, match="coordinator"):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ConfigError, match="process_id 2 outside"):
        distributed.initialize("tcp://localhost:1", 2, 2, device="cpu")
    with pytest.raises(ConfigError, match="no process group"):
        distributed.local_device()
    if not torch.cuda.is_available():  # no fallback from cuda to gloo
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.initialize("tcp://localhost:1", 2, 0)


# ---- the hybrid mesh, against the JAX package's ----


class FakeDevice:
    def __init__(self, process_index: int, device_id: int):
        self.process_index = process_index
        self.id = device_id


def fake_pod(hosts: int, per_host: int) -> list:
    return [FakeDevice(p, p * per_host + i)
            for p in range(hosts) for i in range(per_host)]


def _grid(mesh):
    return [[(d.process_index, d.id) for d in row] for row in mesh.devices]


@pytest.mark.parametrize("hosts,per_host,n_model,processes", [
    (2, 4, 1, None), (2, 4, 2, None), (3, 2, 1, {0, 2}), (4, 2, 2, {1, 3})])
def test_hybrid_mesh_is_hosts_major_like_jax(hosts, per_host, n_model,
                                             processes):
    import random

    from deepgo_tpu.parallel import distributed as jax_distributed

    devices = fake_pod(hosts, per_host)
    random.Random(7).shuffle(devices)  # discovery order is no contract
    mesh = distributed.hybrid_mesh(n_model, devices=devices,
                                   processes=processes)
    want = jax_distributed.hybrid_mesh(n_model, devices=devices,
                                       processes=processes)
    assert mesh.axis_names == tuple(want.axis_names)
    assert _grid(mesh) == _grid(want)
    assert mesh.device_mesh is None  # a layout of fake devices
    for row in _grid(mesh):  # each model-parallel group on one host
        assert len({p for p, _ in row}) == 1


def test_hybrid_mesh_refusals():
    devices = fake_pod(3, 2)
    with pytest.raises(ConfigError, match="no devices"):
        distributed.hybrid_mesh(1, devices=devices, processes={9})
    with pytest.raises(ConfigError, match="n_model"):
        distributed.hybrid_mesh(4, devices=fake_pod(1, 2))
    with pytest.raises(ConfigError, match="n_model"):
        distributed.hybrid_mesh(2)  # one rank here


# ---- per-process batches and this rank's rows ----


def test_per_host_batch_divides_evenly(monkeypatch):
    monkeypatch.setattr(distributed, "world_size", lambda: 4)
    assert distributed.per_host_batch(256) == 64
    with pytest.raises(ConfigError, match=r"254.*4"):
        distributed.per_host_batch(254)


@pytest.mark.parametrize("batch,width,want", [
    (256, 2, 128), (8, 4, 2), (8, 8, 1), (256, 3, None), (1, 2, None),
    (8, 0, None)])
def test_per_host_batch_rebalances_over_survivors(batch, width, want):
    from deepgo_tpu.parallel import distributed as jax_distributed

    outcomes = []
    for module in (distributed, jax_distributed):
        try:
            outcomes.append(module.per_host_batch(batch, process_count=width))
        except module.ConfigError as e:
            outcomes.append(("ConfigError", str(e)))
    assert outcomes[0] == outcomes[1]
    if want is not None:
        assert outcomes[0] == want


def test_local_rows_fault_site_and_histogram():
    from deepgo_tpu_torch.obs import get_registry

    mesh = make_mesh(1, 1)
    batch = {"target": np.arange(8, dtype=np.int32),
             "packed": np.zeros((8, 9, 19, 19), np.uint8)}
    hist = get_registry().histogram("deepgo_collective_seconds")
    before = (hist.snapshot() or {"count": 0})["count"]
    out = distributed.local_rows(mesh, batch)
    np.testing.assert_array_equal(out["target"], batch["target"])
    assert out["packed"].shape == (8, 9, 19, 19)
    assert hist.snapshot()["count"] == before + 1
    faults.install("dist_collective:fail@1")
    with pytest.raises(faults.InjectedFailure):
        distributed.local_rows(mesh, batch)


# ---- deadlines and watchdog: the JAX tests' scenarios on both packages ----


class FakeArm:
    def __init__(self):
        self.armed: list[tuple] = []
        self.disarmed = 0

    def __call__(self, label, timeout_s, diagnostic_json=None):
        self.armed.append((label, timeout_s))
        outer = self

        class Handle:
            def disarm(self):
                outer.disarmed += 1

        return Handle()


def _packages():
    from deepgo_tpu.parallel import deadlines as jax_deadlines
    from deepgo_tpu.parallel import distributed as jax_distributed
    from deepgo_tpu.utils import faults as jax_faults

    return {"port": (deadlines, distributed, faults),
            "jax": (jax_deadlines, jax_distributed, jax_faults)}


def _deadline_scenarios(dl, dist_mod, flt, monkeypatch) -> dict:
    out = {}
    arm = FakeArm()
    with dl.deadline("claim", 7.5, arm=arm):
        out["armed_inside"] = (list(arm.armed), arm.disarmed)
    try:
        with dl.deadline("boom", 2.0, arm=arm):
            raise RuntimeError("x")
    except RuntimeError:
        pass
    out["disarmed_after_raise"] = arm.disarmed
    off = FakeArm()
    with dl.deadline("off", 0.0, arm=off):
        pass
    with dl.deadline("off", -1.0, arm=off):
        pass
    out["zero_timeout_armed"] = off.armed

    noop = FakeArm()
    dl.initialize_with_deadline(num_processes=1, timeout_s=30.0, arm=noop)
    out["noop_armed_and_disarmed"] = (bool(noop.armed),
                                      noop.disarmed == len(noop.armed))

    calls = {"n": 0}

    def refuse_twice(coordinator, num_processes, process_id, **kw):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise ConnectionRefusedError("dial 127.0.0.1:1 refused")

    class Rng:
        def uniform(self, lo, hi):
            return hi

    slept: list = []
    with monkeypatch.context() as m:
        m.setattr(dist_mod, "initialize", refuse_twice)
        dl.initialize_with_deadline(
            "127.0.0.1:1", 2, 0, timeout_s=60.0, attempts=5, base_delay=0.5,
            max_delay=8.0, rng=Rng(), sleep=slept.append, arm=FakeArm())
    out["jitter"] = (calls["n"], slept)

    def always_refuse(coordinator, num_processes, process_id, **kw):
        raise ConnectionRefusedError("nobody home")

    exhaust = FakeArm()
    with monkeypatch.context() as m:
        m.setattr(dist_mod, "initialize", always_refuse)
        try:
            dl.initialize_with_deadline(
                "10.0.0.7:1234", 2, 0, timeout_s=60.0, attempts=3,
                sleep=lambda s: None, arm=exhaust)
        except OSError as e:  # CoordinatorUnreachable is a ConnectionError
            out["exhausted"] = (type(e).__name__, "10.0.0.7:1234" in str(e))
    out["exhaust_arm"] = (exhaust.armed, exhaust.disarmed)

    flt.install("dist_init:transient@2")
    dl.initialize_with_deadline(num_processes=1, timeout_s=30.0,
                                sleep=lambda s: None, arm=FakeArm())
    flt.install("dist_init:fail@1")
    hard_slept: list = []
    try:
        dl.initialize_with_deadline(num_processes=1, timeout_s=30.0,
                                    sleep=hard_slept.append, arm=FakeArm())
    except flt.InjectedFailure:
        out["hard_fault"] = ("InjectedFailure", hard_slept)
    flt.reset()

    guard_arm = FakeArm()
    n = {"calls": 0}

    def step(x):
        n["calls"] += 1
        return x * 2

    guarded = dl.guard_first_call(step, "first-step", 30.0, arm=guard_arm)
    out["guard"] = [guarded(x) for x in (3, 4, 5)]
    out["guard_arm"] = (guard_arm.armed, guard_arm.disarmed, n["calls"])

    retry_arm = FakeArm()
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise RuntimeError("first call blew up")
        return 1

    guarded = dl.guard_first_call(flaky, "first", 10.0, arm=retry_arm)
    try:
        guarded()
    except RuntimeError:
        pass
    out["guard_retry"] = (guarded(), len(retry_arm.armed),
                          retry_arm.disarmed)
    return out


def test_deadline_scenarios_agree_with_jax(monkeypatch):
    results = {name: _deadline_scenarios(*mods, monkeypatch)
               for name, mods in _packages().items()}
    port = results["port"]
    assert port == results["jax"]
    assert port["jitter"] == (3, [0.5, 1.0])
    assert port["exhausted"] == ("CoordinatorUnreachable", True)
    assert port["exhaust_arm"] == ([("dist-init(10.0.0.7:1234)", 60.0)], 1)
    assert port["guard_arm"] == ([("first-step", 30.0)], 1, 3)
    assert port["guard_retry"] == (1, 2, 2)
    assert issubclass(CoordinatorUnreachable, ConnectionError)


def test_guard_first_call_synchronises_tensor_outputs():
    arm = FakeArm()
    guarded = deadlines.guard_first_call(
        lambda x: {"loss": torch.as_tensor(x) * 2, "k": [torch.ones(2)]},
        "first-step", 30.0, arm=arm)
    assert float(guarded(3)["loss"]) == 6.0
    assert arm.armed == [("first-step", 30.0)] and arm.disarmed == 1


def test_watchdog_poll_counts_agree_with_jax():
    from deepgo_tpu.utils import watchdog as jax_watchdog

    budgets = (1.5, 0.1, 2.0, 2.000001, 0.0, -3.0, 7.25)
    got = [watchdog._poll_count(b) for b in budgets]
    assert got == [jax_watchdog._poll_count(b) for b in budgets]
    assert got[:6] == [2, 1, 2, 3, 1, 1]


def test_watchdog_fractional_fuse_does_not_fire_early():
    code = ("import sys, time\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "from deepgo_tpu_torch.utils import watchdog\n"
            "wd = watchdog.arm('boundary-test', timeout_s=1.5)\n"
            "time.sleep(1.2)\n"
            "wd.disarm()\n"
            "print('SURVIVED')\n")
    t0 = time.time()
    r = subprocess.run([sys.executable, "-c", code, REPO],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, (r.returncode, r.stderr[-500:])
    assert "SURVIVED" in r.stdout
    assert time.time() - t0 >= 1.2


# ---- two ranks ----


def tiny(data_root, run_dir, **kw):
    """tests/test_torch_experiment.py's tiny config."""
    return dict(dict(
        name="test", num_layers=3, channels=16, compute_dtype="float32",
        batch_size=8, rate=0.05, validation_size=32, validation_interval=10,
        print_interval=10, data_root=data_root, train_split="validation",
        validation_split="test", test_split="test", loader_threads=0,
        data_parallel=1, cost_ledger=False, run_dir=str(run_dir)), **kw)


# name -> tiny() overrides of a two-rank Experiment run
PAIR_RUNS = {"dp2": {"data_parallel": 2, "momentum": 0.9},
             "tp2": {"tensor_parallel": 2, "momentum": 0.9}}


def _task_pair(rank: int, workdir: str) -> None:
    from deepgo_tpu_torch.parallel import reshard
    from test_torch_parallel import CFG, batch, load_tree, port_run

    with open(os.path.join(workdir, "inputs.json")) as f:
        inputs = json.load(f)
    out = {}
    # one data-parallel train step: both ranks see the global loss
    tree = load_tree(os.path.join(workdir, "init.npz"), CFG)
    losses, *_ = port_run(tree, (2, 1), False, 0.0, False)
    print(f"DIST_OK rank={rank} loss={losses[0]!r}", flush=True)
    mesh = make_mesh(2, 1)
    out["rows"] = distributed.local_rows(mesh, batch(0))["target"].tolist()
    for name, kw in PAIR_RUNS.items():
        exp = Experiment(ExperimentConfig(**tiny(
            inputs["data_root"], os.path.join(workdir, "runs"), **kw)),
            run_id=name, device="cpu")
        summary = exp.run(10)
        path = exp.save()
        out[name] = {"ewma": exp.ewma, "path": path,
                     "validation": summary["last_validation"],
                     "mesh": exp.mesh.shape}
    # threaded loading runs (its stream is per rank, not the single
    # device's)
    exp = Experiment(ExperimentConfig(**tiny(
        inputs["data_root"], os.path.join(workdir, "runs"), data_parallel=2,
        loader_threads=1)), run_id="threaded", device="cpu")
    exp.run(4)
    out["threaded_ewma"] = exp.ewma
    # a JAX 4 x 2 checkpoint under 2 x 1
    exp = Experiment.load(os.path.join(workdir, "jax42.npz"), device="cpu",
                          remesh={"data_parallel": 2, "tensor_parallel": 1})
    params, state = reshard.gather_to_host(exp.model, exp.opt_state,
                                           exp.placement)
    out["restore_findings"] = exp.last_restore_findings
    out["restored_velocity_shape"] = list(
        exp.opt_state["velocity"]["layers.1.weight"].shape)
    if rank == 0:
        np.savez(os.path.join(workdir, "restored.npz"),
                 *(ckpt.tree_leaves(params) + ckpt.tree_leaves(state)))
    with open(os.path.join(workdir, f"pair-{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from deepgo_tpu_torch.data.transcribe import transcribe_split

    root = tmp_path_factory.mktemp("processed")
    for split in ("validation", "test"):
        transcribe_split(os.path.join(REPO, "data/sgf", split),
                         str(root / split), workers=1, verbose=False)
    return str(root)


@pytest.fixture(scope="module")
def pair(tmp_path_factory, data_root):
    from test_torch_parallel import jax_init_tree, save_tree

    workdir = str(tmp_path_factory.mktemp("pair"))
    save_tree(os.path.join(workdir, "init.npz"), jax_init_tree())
    jax42 = jax_checkpoint_4x2(os.path.join(workdir, "jax42.npz"))
    with open(os.path.join(workdir, "inputs.json"), "w") as f:
        json.dump({"data_root": data_root}, f)
    outs = spawn_ranks(__file__, "pair", 2, workdir)
    results = []
    for r in range(2):
        with open(os.path.join(workdir, f"pair-{r}.json")) as f:
            results.append(json.load(f))
    return {"dir": workdir, "stdout": outs, "ranks": results,
            "jax42": jax42}


def test_two_process_train_step_losses_are_equal(pair):
    losses = [float(line.split("loss=")[1]) for out in pair["stdout"]
              for line in out.splitlines() if line.startswith("DIST_OK")]
    assert len(losses) == 2
    assert losses[0] == losses[1]
    assert np.isfinite(losses[0]) and losses[0] > 0


def test_each_data_rank_holds_its_rows(pair):
    from test_torch_parallel import batch

    target = batch(0)["target"].tolist()
    assert pair["ranks"][0]["rows"] == target[:16]
    assert pair["ranks"][1]["rows"] == target[16:]


@pytest.mark.parametrize("name", sorted(PAIR_RUNS))
def test_two_rank_experiment_matches_one_device(pair, data_root, tmp_path,
                                                name):
    ranks = pair["ranks"]
    assert ranks[0][name]["ewma"] == ranks[1][name]["ewma"]
    assert ranks[0][name]["validation"] == ranks[1][name]["validation"]
    ref = Experiment(ExperimentConfig(**tiny(
        data_root, tmp_path, **{**PAIR_RUNS[name], "data_parallel": 1,
                                "tensor_parallel": 1})),
        run_id=name, device="cpu")
    summary = ref.run(10)
    np.testing.assert_allclose(ranks[0][name]["ewma"], ref.ewma,
                               rtol=EWMA_RTOL)
    val, ref_val = ranks[0][name]["validation"], summary["last_validation"]
    assert val["n"] == ref_val["n"] == 32
    np.testing.assert_allclose(val["cost"], ref_val["cost"], rtol=VAL_RTOL)
    # rank 0 wrote the checkpoint: the full state, the 1 x 1 run's within
    # tolerance, and a manifest naming the two-rank layout
    path = ranks[0][name]["path"]
    meta, p, o = ckpt.load_checkpoint(path)
    assert meta["step"] == 10
    assert (meta["mesh"]["data"], meta["mesh"]["model"]) == tuple(
        ranks[0][name]["mesh"][a] for a in ("data", "model"))
    ref_p, ref_o = port_leaves(ref)
    for a, b in zip(p + o, ref_p + ref_o):
        np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert sorted(f for f in os.listdir(os.path.dirname(path))
                  if f.startswith("metrics")) == ["metrics-rank0001.jsonl",
                                                  "metrics.jsonl"]


def test_threaded_loading_trains_on_two_ranks(pair):
    ewmas = [r["threaded_ewma"] for r in pair["ranks"]]
    assert ewmas[0] == ewmas[1] and np.isfinite(ewmas[0])


def test_jax_4x2_checkpoint_restores_under_2x1(pair):
    params, state = pair["jax42"]
    with np.load(os.path.join(pair["dir"], "restored.npz")) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    assert_bitwise(leaves, params + state)
    for r in pair["ranks"]:
        assert r["restore_findings"] == []
        # ZeRO over the two data ranks: the hidden conv's momentum splits
        # its in-channels (the first JAX dimension that divides by 2; port
        # dimension 1)
        assert r["restored_velocity_shape"] == [16, 8, 3, 3]


if __name__ == "__main__":
    torch.set_num_threads(2)
    rank_main({"pair": _task_pair})
