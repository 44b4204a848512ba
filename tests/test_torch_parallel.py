"""The port's parallel layer (``deepgo_tpu_torch/parallel``) against the
JAX package's, on the CPU.

Four gloo ranks (one process each, a ``file://`` rendezvous in a temporary
directory) train ``num_layers=3, channels=16`` in float32 for 3 steps from
the JAX package's initial params, on the batches of tests/test_parallel.py,
under the layouts 4 x 1 and 2 x 2 (tensor parallel), each with and without
ZeRO. The JAX package runs the same steps on its 8-device CPU mesh. Bars,
those of tests/test_parallel.py: losses within rtol 1e-5, parameters within
rtol 1e-4 / atol 1e-6; inside the port ZeRO equals replicated bitwise.

The checkpoint manifest is a pure function of the layout and the leaves'
shapes: it equals the JAX package's ``reshard.manifest`` string for string.
Checkpoints cross the packages and layouts bitwise: a 1 x 1 port file
restored by the ranks under 2 x 2 + ZeRO and saved again loads in the JAX
``Experiment.load(remesh=...)`` with the original leaves, and a JAX 4 x 2
file restores in the port (1 x 1 here; 2 x 1 in test_torch_distributed.py).

The ranks run this file as a script (``python tests/test_torch_parallel.py
TASK RANK RANKS DIR``); it imports neither jax nor the JAX package at the
top, so they stay fast, and the JAX side is imported inside the tests.
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
from deepgo_tpu_torch.models import convert, policy_cnn  # noqa: E402
from deepgo_tpu_torch.parallel import reshard, tensor  # noqa: E402
from deepgo_tpu_torch.parallel.liveness import ConfigError  # noqa: E402
from deepgo_tpu_torch.parallel.mesh import (RankDevice,  # noqa: E402
                                            make_mesh)
from deepgo_tpu_torch.utils import faults  # noqa: E402

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
STEPS = 3
CFG = policy_cnn.ModelConfig(num_layers=3, channels=16,
                             compute_dtype="float32")
# (name, (data, model), zero, momentum, explicit step)
RUNS = [("4x1", (4, 1), False, 0.9, False),
        ("4x1+zero", (4, 1), True, 0.9, False),
        ("2x2", (2, 2), False, 0.9, False),
        ("2x2+zero", (2, 2), True, 0.9, False),
        ("explicit", (4, 1), False, 0.0, True)]
SALTED_CFG = dict(name="salted", num_layers=3, channels=16, momentum=0.9,
                  data_root="<unused>", loader_threads=0, keep_checkpoints=0,
                  data_parallel=1)


# ---- the ranks ----


def spawn_ranks(script: str, task: str, n: int, workdir: str,
                timeout: float = 240.0) -> list[str]:
    """Run ``task`` of ``script`` on ``n`` gloo ranks, one process each,
    meeting through a ``file://`` store in ``workdir``; returns their
    stdouts. The first rank to fail ends the others (they would wait for
    it in a collective) and fails the call with its stderr."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    logs = [os.path.join(workdir, f"{task}-{r}") for r in range(n)]
    procs = []
    for r, log in enumerate(logs):
        with open(log + ".out", "w") as out, open(log + ".err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, script, task, str(r), str(n), workdir],
                cwd=REPO, env=env, stdout=out, stderr=err))
    deadline = time.monotonic() + timeout
    try:
        while (any(p.poll() is None for p in procs)
               and all(p.poll() in (None, 0) for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        with open(log + ".err") as f:
            assert p.returncode == 0, f.read()[-3000:]
    outs = []
    for log in logs:
        with open(log + ".out") as f:
            outs.append(f.read())
    return outs


def rank_main(tasks: dict) -> None:
    """A rank's entry: ``TASK RANK RANKS DIR`` on the command line."""
    task, rank, n, workdir = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    from deepgo_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{os.path.join(workdir, 'store')}", n,
                           rank, device="cpu")
    try:
        tasks[task](rank, workdir)
    finally:
        distributed.shutdown()


def batch(seed: int, bs: int = 32) -> dict:
    """tests/test_parallel.py's ``_batch``, as numpy."""
    rng = np.random.default_rng(seed)
    return {
        "packed": rng.integers(0, 3, size=(bs, 9, 19, 19), dtype=np.uint8),
        "player": rng.integers(1, 3, size=bs, dtype=np.int32),
        "rank": rng.integers(1, 10, size=bs, dtype=np.int32),
        "target": rng.integers(0, 361, size=bs, dtype=np.int32),
    }


def save_tree(path: str, tree) -> None:
    np.savez(path, *ckpt.tree_leaves(tree))


def load_tree(path: str, cfg=CFG):
    with np.load(path) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    return ckpt.unflatten_like(convert.params_to_jax(policy_cnn.PolicyCNN(cfg)),
                               leaves)


def port_run(tree, layout, zero, momentum, explicit):
    """``STEPS`` steps of the port under ``layout`` from ``tree``: (losses,
    full params leaves, full optimizer-state leaves, the placement, the
    local state)."""
    from deepgo_tpu_torch.parallel import data_sharding, zero as zero_lib
    from deepgo_tpu_torch.parallel.shard_map_step import \
        make_shard_map_train_step
    from deepgo_tpu_torch.training import make_train_step, sgd

    d, m = layout
    mesh = make_mesh(d, m)
    placement = reshard.Placement.for_model(CFG, mesh, tensor_parallel=m,
                                            zero_opt=zero)
    opt = sgd(0.05, rate_decay=1e-4, momentum=momentum)
    if zero:
        opt = zero_lib.shard_optimizer(opt, placement)
    full = convert.model_from_jax(tree, CFG, device="cpu")
    model, _ = reshard.place_state(full, None, placement)
    state = opt.init(model)
    step = (make_shard_map_train_step(CFG, opt, mesh) if explicit
            else make_train_step(CFG, opt, mesh=mesh))
    rows = data_sharding(mesh)
    losses = []
    for i in range(STEPS):
        local = {k: torch.from_numpy(np.ascontiguousarray(rows.take(v)))
                 for k, v in batch(i).items()}
        model, state, loss = step(model, state, local)
        losses.append(float(loss))
    params, opt_state = reshard.gather_to_host(model, state, placement)
    return (losses, ckpt.tree_leaves(params), ckpt.tree_leaves(opt_state),
            placement, state)


def _task_layouts(rank: int, workdir: str) -> None:
    from deepgo_tpu_torch.parallel import zero as zero_lib

    tree = load_tree(os.path.join(workdir, "init.npz"))
    arrays, info = {}, {}
    for name, layout, zero, momentum, explicit in RUNS:
        losses, p, o, placement, state = port_run(tree, layout, zero,
                                                  momentum, explicit)
        info[name] = {
            "losses": losses,
            "sharded_fraction": zero_lib.sharded_fraction(placement, state),
            "local_velocity": {n: list(t.shape) for n, t in
                               state.get("velocity", {}).items()}}
        for i, leaf in enumerate(p):
            arrays[f"{name}/p{i}"] = leaf
        for i, leaf in enumerate(o):
            arrays[f"{name}/o{i}"] = leaf
    # a 1 x 1 checkpoint restored under 2 x 2 + ZeRO and written again
    exp = Experiment.load(os.path.join(workdir, "salted11.npz"), device="cpu",
                          remesh={"data_parallel": 2, "tensor_parallel": 2})
    info["restore_findings"] = exp.last_restore_findings
    info["restored_local_shapes"] = {
        n: list(p.shape) for n, p in exp.model.named_parameters()}
    exp.save(os.path.join(workdir, "port22.npz"))
    if rank == 0:
        np.savez(os.path.join(workdir, "runs.npz"), **arrays)
        with open(os.path.join(workdir, "runs.json"), "w") as f:
            json.dump(info, f)


# ---- the JAX side ----


def jax_init_tree():
    import jax

    from deepgo_tpu.models import ModelConfig, init

    params = init(jax.random.key(0), ModelConfig(num_layers=3, channels=16,
                                                 compute_dtype="float32"))
    return jax.tree.map(np.asarray, params)


def jax_run(name):
    import jax

    from deepgo_tpu.models import ModelConfig, init
    from deepgo_tpu.parallel import (data_sharding, make_mesh as jax_mesh,
                                     replicated_sharding)
    from deepgo_tpu.parallel.shard_map_step import make_shard_map_train_step
    from deepgo_tpu.training import sgd
    from test_parallel import _run_steps

    _, layout, zero, momentum, explicit = next(r for r in RUNS
                                               if r[0] == name)
    mesh = jax_mesh(*layout)
    if not explicit:
        losses, params, state = _run_steps(mesh, tp=layout[1] > 1,
                                           steps=STEPS, zero=zero,
                                           momentum=momentum)
    else:
        cfg = ModelConfig(num_layers=3, channels=16, compute_dtype="float32")
        opt = sgd(0.05, rate_decay=1e-4)
        params = jax.device_put(init(jax.random.key(0), cfg),
                                replicated_sharding(mesh))
        state = jax.device_put(opt.init(params), replicated_sharding(mesh))
        step = make_shard_map_train_step(cfg, opt, mesh)
        losses = []
        for i in range(STEPS):
            params, state, loss = step(
                params, state, jax.device_put(batch(i), data_sharding(mesh)))
            losses.append(float(loss))
    return (losses, [np.asarray(x) for x in jax.tree.leaves(params)],
            [np.asarray(x) for x in jax.tree.leaves(state)])


def salt(exp: Experiment) -> None:
    """Position-distinct values in every float leaf (fresh momentum is all
    zeros otherwise), so a shard-order bug cannot cancel out."""
    with torch.no_grad():
        for p in exp.model.parameters():
            p += torch.arange(p.numel(), dtype=p.dtype).view(p.shape) / p.numel()
        for v in exp.opt_state["velocity"].values():
            v += torch.arange(v.numel(), dtype=v.dtype).view(v.shape) / v.numel()


def port_leaves(exp: Experiment):
    return (ckpt.tree_leaves(convert.params_to_jax(exp.model)),
            ckpt.tree_leaves(convert.opt_state_to_jax(exp.opt_state)))


def assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One four-rank run of every layout, plus the 2 x 2 checkpoint."""
    workdir = str(tmp_path_factory.mktemp("ranks"))
    save_tree(os.path.join(workdir, "init.npz"), jax_init_tree())
    exp = Experiment(ExperimentConfig(run_dir=workdir, **SALTED_CFG),
                     run_id="salted", device="cpu")
    exp.init()
    salt(exp)
    exp.save(os.path.join(workdir, "salted11.npz"))
    spawn_ranks(__file__, "layouts", 4, workdir)
    with open(os.path.join(workdir, "runs.json")) as f:
        info = json.load(f)
    with np.load(os.path.join(workdir, "runs.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def leaves(name, kind):
        n = sum(1 for k in arrays if k.startswith(f"{name}/{kind}"))
        return [arrays[f"{name}/{kind}{i}"] for i in range(n)]

    return {"dir": workdir, "info": info, "leaves": leaves,
            "salted": port_leaves(exp)}


# ---- layouts against the JAX package ----


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_layout_matches_jax_mesh(ranks, name):
    j_losses, j_params, j_state = jax_run(name)
    p_losses = ranks["info"][name]["losses"]
    np.testing.assert_allclose(p_losses, j_losses, rtol=LOSS_RTOL)
    for a, b in zip(ranks["leaves"](name, "p"), j_params):
        np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    for a, b in zip(ranks["leaves"](name, "o"), j_state):
        np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_zero_equals_replicated_bitwise(ranks, layout):
    info = ranks["info"]
    assert info[layout]["losses"] == info[f"{layout}+zero"]["losses"]
    for kind in ("p", "o"):
        assert_bitwise(ranks["leaves"](layout, kind),
                       ranks["leaves"](f"{layout}+zero", kind))


def test_zero_state_is_sharded(ranks):
    info = ranks["info"]
    assert info["4x1+zero"]["sharded_fraction"] > 0.9
    assert info["4x1"]["sharded_fraction"] == 0.0
    # rank 0's hidden-conv momentum under 2 x 2 + ZeRO: out-channels over
    # "model", in-channels over "data" (JAX: P(None, None, 'data',
    # 'model')), so a quarter of the (16, 16, 3, 3) leaf
    assert info["2x2+zero"]["local_velocity"]["layers.1.weight"] == \
        [8, 8, 3, 3]
    assert info["2x2"]["local_velocity"]["layers.1.weight"] == [8, 16, 3, 3]
    # the 1-channel head stays whole over "model"
    assert info["2x2"]["local_velocity"]["layers.2.weight"] == [1, 16, 3, 3]


def test_tensor_parallel_network_holds_its_shards(ranks):
    shapes = ranks["info"]["restored_local_shapes"]
    assert shapes["layers.0.weight"] == [8, 37, 5, 5]
    assert shapes["layers.0.bias"] == [8, 19, 19]
    assert shapes["layers.1.weight"] == [8, 16, 3, 3]
    assert shapes["layers.2.weight"] == [1, 16, 3, 3]
    assert ranks["info"]["restore_findings"] == []


# ---- the manifest, a pure function of shapes ----


MANIFEST_OPTS = {"momentum": {"momentum": 0.9},
                 "adagrad": {"optimizer": "adagrad"}}
MANIFEST_CASES = (
    [(d, m, opt, True) for d, m in ((1, 1), (2, 1), (4, 1), (2, 2), (4, 2))
     for opt in sorted(MANIFEST_OPTS)]
    + [(d, 1, opt, False) for d in (1, 2, 4) for opt in sorted(MANIFEST_OPTS)])


@pytest.mark.parametrize("d,m,opt,zero_opt", MANIFEST_CASES)
def test_manifest_equals_jax_string_for_string(d, m, opt, zero_opt,
                                               tmp_path):
    import jax

    from deepgo_tpu.experiments.experiment import Experiment as JaxExperiment
    from deepgo_tpu.experiments.experiment import \
        ExperimentConfig as JaxExperimentConfig
    from deepgo_tpu.parallel import reshard as jax_reshard

    kw = dict(num_layers=3, channels=16, data_parallel=d, tensor_parallel=m,
              zero_opt=zero_opt, run_dir=str(tmp_path), **MANIFEST_OPTS[opt])
    jexp = JaxExperiment(JaxExperimentConfig(**kw))
    jexp.init()
    want = jax_reshard.manifest(jexp.mesh, jexp.params, jexp.opt_state,
                                zero_opt=zero_opt)
    # no ranks: a layout-only mesh and the leaves' shapes
    mesh = make_mesh(d, m, devices=[RankDevice(r, r) for r in range(d * m)])
    params = jax.tree.map(lambda x: np.empty(x.shape, np.float32),
                          jexp.params)
    state = jax.tree.map(lambda x: np.empty(x.shape, np.float32),
                         jexp.opt_state)
    got = reshard.manifest(mesh, params, state, zero_opt=zero_opt,
                           tensor_parallel=m)
    assert got == want
    assert ckpt.manifest(params, state, zero_opt=zero_opt, mesh=mesh,
                         tensor_parallel=m) == want


# ---- checkpoints across packages and layouts ----


def test_port_2x2_zero_checkpoint_manifest_is_jax_s(ranks, tmp_path):
    from deepgo_tpu.experiments.experiment import Experiment as JaxExperiment
    from deepgo_tpu.experiments.experiment import \
        ExperimentConfig as JaxExperimentConfig
    from deepgo_tpu.parallel import reshard as jax_reshard

    meta = ckpt.load_meta(os.path.join(ranks["dir"], "port22.npz"))
    jexp = JaxExperiment(JaxExperimentConfig(**{
        **SALTED_CFG, "data_parallel": 2, "tensor_parallel": 2,
        "run_dir": str(tmp_path)}))
    jexp.init()
    assert meta["mesh"] == jax_reshard.manifest(
        jexp.mesh, jexp.params, jexp.opt_state, zero_opt=True)
    assert meta["config"]["tensor_parallel"] == 2


@pytest.mark.parametrize("d,m", [(4, 2), (2, 2), (1, 1)])
def test_port_2x2_zero_checkpoint_loads_in_jax(ranks, d, m):
    import jax

    from deepgo_tpu.experiments.experiment import Experiment as JaxExperiment

    jexp = JaxExperiment.load(os.path.join(ranks["dir"], "port22.npz"),
                              remesh={"data_parallel": d,
                                      "tensor_parallel": m})
    assert dict(jexp.mesh.shape) == {"data": d, "model": m}
    params, state = ranks["salted"]
    assert_bitwise([np.asarray(x) for x in jax.tree.leaves(jexp.params)],
                   params)
    assert_bitwise([np.asarray(x) for x in jax.tree.leaves(jexp.opt_state)],
                   state)


def jax_checkpoint_4x2(path: str):
    """A JAX 4 x 2 (+ ZeRO) checkpoint of salted state; returns its leaves
    as the JAX package holds them."""
    import jax
    import jax.numpy as jnp

    from deepgo_tpu.experiments.experiment import Experiment as JaxExperiment
    from deepgo_tpu.experiments.experiment import \
        ExperimentConfig as JaxExperimentConfig

    jexp = JaxExperiment(JaxExperimentConfig(**{
        **SALTED_CFG, "data_parallel": 4, "tensor_parallel": 2,
        "run_dir": os.path.dirname(path)}), run_id="jax42")
    jexp.init()

    def salted(leaf):
        return leaf + jnp.arange(leaf.size, dtype=leaf.dtype).reshape(
            leaf.shape) / leaf.size

    jexp.params = jax.tree.map(salted, jexp.params)
    jexp.opt_state = jax.tree.map(salted, jexp.opt_state)
    jexp.save(path)
    return ([np.asarray(x) for x in jax.tree.leaves(jexp.params)],
            [np.asarray(x) for x in jax.tree.leaves(jexp.opt_state)])


def test_jax_4x2_checkpoint_restores_in_the_port_at_1x1(tmp_path):
    path = str(tmp_path / "jax42.npz")
    params, state = jax_checkpoint_4x2(path)
    assert ckpt.load_meta(path)["mesh"]["devices"] == 8
    exp = Experiment.load(path, device="cpu",
                          remesh={"data_parallel": 1, "tensor_parallel": 1})
    assert exp.mesh.shape == {"data": 1, "model": 1}
    assert exp.last_restore_findings == []
    p, o = port_leaves(exp)
    assert_bitwise(p, params)
    assert_bitwise(o, state)


def _rewrite_meta(path, mutate):
    """Rewrite the npz's meta in place: the integrity block covers array
    payloads only, so this is the corruption the manifest check is for."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta"]).decode())
    mutate(meta)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def test_corrupt_manifest_refused_and_skipped(ranks, tmp_path):
    import shutil

    run = tmp_path / "run"
    run.mkdir()
    old = str(run / ckpt.checkpoint_name(10))
    newer = str(run / ckpt.checkpoint_name(20))
    shutil.copy(os.path.join(ranks["dir"], "port22.npz"), old)
    shutil.copy(os.path.join(ranks["dir"], "port22.npz"), newer)

    def mutate(meta):
        meta["mesh"]["devices"] = 99  # 2 x 2 != 99

    _rewrite_meta(newer, mutate)
    with pytest.raises(ckpt.CheckpointError, match="inconsistent"):
        ckpt.verify_checkpoint(newer)
    skipped = []
    assert ckpt.find_latest_valid(str(run), log=skipped.append) == old
    assert any("mesh manifest" in line for line in skipped)


# ---- meshes, placements and the reshard fault sites, no ranks ----


def test_make_mesh_without_ranks():
    with pytest.raises(ConfigError, match="mesh 2x2 needs 4 devices, have 1"):
        make_mesh(2, 2)
    mesh = make_mesh(1, 1)
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.group("data") is None and mesh.local_index("model") == 0
    layout = make_mesh(2, 2, devices=[RankDevice(r, r) for r in range(4)])
    assert [[d.id for d in row] for row in layout.devices] == [[0, 1], [2, 3]]
    with pytest.raises(RuntimeError, match="no process group"):
        layout.group("data")


def test_row_shardings_say_which_rows_a_data_rank_holds():
    from deepgo_tpu_torch.parallel import (data_sharding,
                                           replicated_sharding,
                                           superbatch_sharding)

    mesh = make_mesh(4, 2, devices=[RankDevice(r, r) for r in range(8)])
    superbatch = np.arange(3 * 8).reshape(3, 8)
    assert data_sharding(mesh).rows(8) == slice(0, 2)  # data index 0
    np.testing.assert_array_equal(superbatch_sharding(mesh).take(superbatch),
                                  superbatch[:, :2])
    assert replicated_sharding(mesh).take(superbatch) is superbatch
    with pytest.raises(ConfigError, match="do not divide over 4"):
        data_sharding(mesh).rows(6)


def test_param_shardings_follow_the_jax_rule():
    mesh = make_mesh(2, 2, devices=[RankDevice(r, r) for r in range(4)])
    specs = tensor.param_shardings(tensor.param_shapes(
        policy_cnn.ModelConfig(num_layers=3, channels=(16, 6))), mesh)
    assert specs["layers.0.weight"] == (None, None, None, "model")
    assert specs["layers.0.bias"] == (None, None, "model")
    assert specs["layers.1.weight"] == (None, None, None, "model")  # 6 % 2
    assert specs["layers.2.weight"] == ()  # the 1-channel head
    assert tensor.port_dim("layers.1.weight", (None, None, "data", "model"),
                           "data") == 1


class TestReshardFaultSites:
    @pytest.fixture(autouse=True)
    def _clean_faults(self, monkeypatch):
        monkeypatch.delenv("DEEPGO_FAULTS", raising=False)
        faults.reset()
        yield
        faults.reset()

    def _state(self):
        cfg = policy_cnn.ModelConfig(num_layers=2, channels=4)
        model = policy_cnn.init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        placement = reshard.Placement.for_model(
            cfg, make_mesh(1, 1), tensor_parallel=1, zero_opt=True)
        state = {"rate": torch.tensor(0.1)}
        return model, state, placement

    def test_transient_gather_absorbed_hard_surfaces(self):
        model, state, placement = self._state()
        faults.install("reshard_gather:transient@2")
        params, _ = reshard.gather_to_host(model, state, placement)
        assert_bitwise(ckpt.tree_leaves(params),
                       ckpt.tree_leaves(convert.params_to_jax(model)))
        faults.install("reshard_gather:fail@1")
        with pytest.raises(faults.InjectedFailure):
            reshard.gather_to_host(model, state, placement)

    def test_transient_scatter_absorbed_hard_surfaces(self):
        model, state, placement = self._state()
        params, opt = reshard.gather_to_host(model, state, placement)
        faults.install("reshard_scatter:transient@2")
        named, _ = reshard.scatter(params, opt, placement, "cpu")
        assert all(torch.equal(named[n], p)
                   for n, p in model.named_parameters())
        faults.install("reshard_scatter:fail@1")
        with pytest.raises(faults.InjectedFailure):
            reshard.scatter(params, opt, placement, "cpu")

    def test_collective_timeout_emulated_by_slow_site(self):
        model, state, placement = self._state()
        params, opt = reshard.gather_to_host(model, state, placement)
        faults.install("reshard_collective:slow@80")
        t0 = time.monotonic()
        named, _, findings = reshard.restore(params, opt, placement, "cpu")
        assert time.monotonic() - t0 >= 0.08
        assert findings == []
        faults.install("reshard_collective:fail@1")
        with pytest.raises(faults.InjectedFailure):
            reshard.scatter(params, opt, placement, "cpu")

    def test_placement_check_reports_a_misplaced_leaf(self):
        model, _, placement = self._state()
        named = dict(model.named_parameters())
        named["layers.0.bias"] = named["layers.0.bias"][:2]
        findings = reshard.check_placement("test", named,
                                           placement.param_specs, placement)
        assert [f["leaf"] for f in findings] == ["layers.0.bias"]
        assert findings[0]["want"] == (4, 19, 19)


if __name__ == "__main__":
    torch.set_num_threads(2)
    rank_main({"layouts": _task_layouts})
