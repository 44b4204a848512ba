"""The port's experiment layer and checkpoint write side against the JAX
package's.

The bundled ``data/sgf`` splits are transcribed with the JAX package and
both packages train on them at a tiny size (3 layers x 16 channels,
float32, batch 8, ``loader_threads=0`` so the data stream is step-indexed
and equal in both). Bars:

* checkpoints: a port-written file passes the JAX package's verifying
  reader with the digest JAX computes for the same state, and the JAX
  ``Experiment.load`` continues it with bitwise the same params and
  optimizer state (and the other way round); the ``mesh`` manifest equals
  ``reshard.manifest`` on a 1 x 1 mesh.
* 20 steps from the same initial params: EWMA within ``EWMA_RTOL``
  relative, final params within ``PARAM_TOL`` max-abs (float32; the
  convolution gradients are summed in another order).
* ``evaluate()`` on one checkpoint: top-1 counts differ by no more than the
  rows whose top-1 logit margin is below 1e-4, and NLL within 1e-4.
* inside the port: a resumed run equals an uninterrupted one bitwise.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from conftest import REPO_ROOT
from deepgo_tpu.data.transcribe import transcribe_split
from deepgo_tpu.experiments import checkpoint as jax_ckpt
from deepgo_tpu.experiments.experiment import Experiment as JaxExperiment
from deepgo_tpu.experiments.experiment import \
    ExperimentConfig as JaxExperimentConfig
from deepgo_tpu.parallel import make_mesh, reshard
from deepgo_tpu.training import optimizers as jax_opt

from deepgo_tpu_torch.experiments import checkpoint as ckpt
from deepgo_tpu_torch.experiments.experiment import (Experiment,
                                                     ExperimentConfig)
from deepgo_tpu_torch.experiments.repeated import warm_restart
from deepgo_tpu_torch.models import convert
from deepgo_tpu_torch.training import optimizers
from deepgo_tpu_torch.utils import faults
from deepgo_tpu_torch.utils.metrics import read_jsonl

from test_torch_policy import numpy_tree

torch.set_num_threads(2)

EWMA_RTOL = 1e-5
PARAM_TOL = 1e-5
EVAL_NLL_TOL = 1e-4
TOP1_MARGIN = 1e-4


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("processed")
    for split in ("validation", "test"):
        transcribe_split(os.path.join(REPO_ROOT, "data/sgf", split),
                         str(root / split), workers=1, verbose=False)
    return str(root)


def tiny(data_root, run_dir, **kw):
    return dict(dict(
        name="test", num_layers=3, channels=16, compute_dtype="float32",
        batch_size=8, rate=0.05, validation_size=32, validation_interval=10,
        print_interval=10, data_root=data_root, train_split="validation",
        validation_split="test", test_split="test", loader_threads=0,
        data_parallel=1, cost_ledger=False, run_dir=str(run_dir)), **kw)


def port_exp(data_root, run_dir, tree=None, run_id="port", **kw):
    exp = Experiment(ExperimentConfig(**tiny(data_root, run_dir, **kw)),
                     run_id=run_id, device="cpu")
    if tree is not None:
        exp.model = convert.model_from_jax(tree, exp.config.model_config(),
                                           device="cpu")
    return exp


def jax_exp(data_root, run_dir, tree=None, run_id="jax", **kw):
    exp = JaxExperiment(JaxExperimentConfig(**tiny(data_root, run_dir, **kw)),
                        run_id=run_id)
    if tree is not None:
        exp.params = jax.tree.map(jax.numpy.asarray, tree)
    return exp


def port_leaves(exp):
    return (ckpt.tree_leaves(convert.params_to_jax(exp.model)),
            ckpt.tree_leaves(convert.opt_state_to_jax(exp.opt_state)))


def jax_leaves(exp):
    return ([np.asarray(x) for x in jax.tree.leaves(exp.params)],
            [np.asarray(x) for x in jax.tree.leaves(exp.opt_state)])


def assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


OPTS = {"sgd": {}, "momentum": {"momentum": 0.9},
        "adagrad": {"optimizer": "adagrad"}}


# ---- checkpoint write side ----


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_port_checkpoint_verifies_under_jax(data_root, tmp_path, opt):
    exp = port_exp(data_root, tmp_path, **OPTS[opt])
    exp.init()
    exp.step, exp.ewma = 7, 1.25
    path = exp.save(str(tmp_path / "c.npz"))
    meta, p, o = jax_ckpt.load_checkpoint(path, verify=True)
    assert meta["step"] == 7 and meta["ewma"] == 1.25
    # the JAX writer on the same trees and meta: the same arrays and digest
    params = convert.params_to_jax(exp.model)
    state = convert.opt_state_to_jax(exp.opt_state)
    jpath = str(tmp_path / "j.npz")
    jax_ckpt.save_checkpoint(jpath, params, state, {
        k: v for k, v in meta.items()
        if k not in ("format_version", "integrity")})
    jmeta = jax_ckpt.load_meta(jpath)
    assert meta["integrity"] == jmeta["integrity"]
    assert_bitwise(p, jax.tree.leaves(params))
    assert_bitwise(o, jax.tree.leaves(state))


@pytest.mark.parametrize("zero_opt", [True, False])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_manifest_is_jax_s_on_one_device(opt, zero_opt):
    cfg = JaxExperimentConfig(num_layers=3, channel_schedule="16,8",
                              **OPTS[opt]).model_config()
    tree = numpy_tree(cfg)
    jopt = (jax_opt.adagrad(0.1) if opt == "adagrad"
            else jax_opt.sgd(0.1, momentum=OPTS[opt].get("momentum", 0.0)))
    mesh = make_mesh(1, 1)
    params, _ = reshard.place_state(tree, None, mesh, tensor_parallel=1,
                                    zero_opt=zero_opt)
    _, state = reshard.place_state(params, jopt.init(params), mesh,
                                   tensor_parallel=1, zero_opt=zero_opt)
    want = reshard.manifest(mesh, params, state, zero_opt=zero_opt)
    np_state = jax.tree.map(np.asarray, state)
    assert ckpt.manifest(tree, np_state, zero_opt=zero_opt) == want


@pytest.mark.parametrize("opt", ["momentum", "adagrad"])
def test_jax_experiment_continues_a_port_checkpoint(data_root, tmp_path, opt):
    exp = port_exp(data_root, tmp_path, **OPTS[opt])
    exp.run(10)
    path = ckpt.find_latest_valid(exp.run_path)
    assert path.endswith("checkpoint-00000010.npz")
    jexp = JaxExperiment.load(path)
    assert jexp.step == 10 and jexp.ewma == exp.ewma
    assert jexp.validation_history == exp.validation_history
    got_p, got_o = jax_leaves(jexp)
    want_p, want_o = port_leaves(exp)
    assert_bitwise(got_p, want_p)
    assert_bitwise(got_o, want_o)
    jexp.run(2)
    assert jexp.step == 12 and np.isfinite(jexp.ewma)


def test_port_experiment_loads_a_jax_checkpoint(data_root, tmp_path):
    jexp = jax_exp(data_root, tmp_path, momentum=0.9)
    jexp.run(10)
    path = jax_ckpt.find_latest_valid(jexp.run_path)
    exp = Experiment.load(path, device="cpu")
    assert exp.step == 10 and exp.ewma == jexp.ewma and exp.id == jexp.id
    got_p, got_o = port_leaves(exp)
    want_p, want_o = jax_leaves(jexp)
    assert_bitwise(got_p, want_p)
    assert_bitwise(got_o, want_o)
    exp.run(2)
    assert exp.step == 12 and np.isfinite(exp.ewma)


# ---- training against JAX ----


def test_twenty_steps_match_jax(data_root, tmp_path):
    cfg = ExperimentConfig(**tiny(data_root, tmp_path)).model_config()
    tree = numpy_tree(cfg, seed=3, bias_scale=0.0)
    exp = port_exp(data_root, tmp_path / "port", tree, momentum=0.9)
    jexp = jax_exp(data_root, tmp_path / "jax", tree, momentum=0.9)
    summary = exp.run(20)
    jsummary = jexp.run(20)
    assert abs(exp.ewma - jexp.ewma) <= EWMA_RTOL * abs(jexp.ewma)
    got_p, got_o = port_leaves(exp)
    want_p, want_o = jax_leaves(jexp)
    assert max(np.abs(a - b).max() for a, b in zip(got_p, want_p)) \
        <= PARAM_TOL
    assert max(np.abs(a - b).max() for a, b in zip(got_o, want_o)) \
        <= PARAM_TOL
    val, jval = summary["last_validation"], jsummary["last_validation"]
    assert val["n"] == jval["n"] == 32
    assert abs(val["cost"] - jval["cost"]) <= EVAL_NLL_TOL

    # the JSONL stream carries the JAX records with the JAX keys
    def kinds(path):
        out = {}
        for r in read_jsonl(path):
            out.setdefault(r["kind"], set(r))
        return out

    got = kinds(os.path.join(exp.run_path, "metrics.jsonl"))
    want = kinds(os.path.join(jexp.run_path, "metrics.jsonl"))
    assert {k: got[k] for k in want} == want
    assert set(got) == {"train", "validation", "summary", "obs_snapshot"}
    reg = read_jsonl(os.path.join(exp.config.run_dir, "registry.jsonl"))
    assert set(reg[-1]) == set(read_jsonl(os.path.join(
        jexp.config.run_dir, "registry.jsonl"))[-1])


def test_evaluate_agrees_with_jax_on_one_checkpoint(data_root, tmp_path):
    exp = port_exp(data_root, tmp_path)
    exp.run(10)
    path = ckpt.find_latest_valid(exp.run_path)
    got = Experiment.load(path, device="cpu").evaluate()
    want = JaxExperiment.load(path).evaluate()
    assert got["n"] == want["n"] > 100
    assert abs(got["cost"] - want["cost"]) <= EVAL_NLL_TOL
    # rows whose top-1 is a near-tie may flip
    exp2 = Experiment.load(path, device="cpu")
    exp2.init()
    batches = exp2._deterministic_batches(exp2._dataset("test"), got["n"])
    close = 0
    from deepgo_tpu_torch.training.steps import _planes, _unwire

    for batch in batches:
        planes = _planes(batch, _unwire(batch["packed"], exp2.wire),
                         exp2.model_cfg)
        with torch.no_grad():
            top2 = exp2.model(planes).topk(2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) < TOP1_MARGIN
        close += int((near & (batch["mask"] > 0)).sum())
    assert abs(got["accuracy"] - want["accuracy"]) * got["n"] <= close + 1e-9


# ---- inside the port ----


def test_resume_equals_uninterrupted_bitwise(data_root, tmp_path):
    whole = port_exp(data_root, tmp_path / "a", momentum=0.9,
                     validation_interval=30)
    whole.run(30)
    first = port_exp(data_root, tmp_path / "b", momentum=0.9,
                     validation_interval=30, print_interval=5)
    first.run(13)  # ends mid-window: the resume realigns
    path = first.save()
    second = Experiment.load(path, device="cpu")
    assert second.step == 13 and second.ewma == first.ewma
    second.run(17)
    assert second.step == 30
    # the windows differ (print_interval), the EWMA fold does not
    assert second.ewma == whole.ewma
    assert_bitwise(port_leaves(second)[0], port_leaves(whole)[0])
    assert_bitwise(port_leaves(second)[1], port_leaves(whole)[1])


def test_auto_resume_skips_a_corrupt_newest(data_root, tmp_path):
    exp = port_exp(data_root, tmp_path, keep_checkpoints=0)
    exp.run(20)
    newest = os.path.join(exp.run_path, ckpt.checkpoint_name(20))
    data = bytearray(open(newest, "rb").read())
    open(newest, "wb").write(bytes(data[: len(data) // 2]))
    logged = []
    resumed = Experiment.auto_resume(exp.run_path, log=logged.append,
                                     device="cpu")
    assert resumed.step == 10 and len(logged) == 1 and newest in logged[0]
    fresh = Experiment.auto_resume(str(tmp_path / "new-run"),
                                   overrides={"num_layers": 2},
                                   device="cpu")
    assert fresh.id == "new-run" and fresh.step == 0
    assert fresh.config.run_dir == str(tmp_path)


def test_retention_keeps_newest_plus_best(data_root, tmp_path):
    exp = port_exp(data_root, tmp_path, keep_checkpoints=2,
                   validation_interval=10)
    exp.run(40)
    best = min(exp.validation_history, key=lambda r: r["cost"])["step"]
    kept = {s for s, _ in ckpt.list_checkpoints(exp.run_path)}
    assert kept == {30, 40} | {best}
    alias = os.path.join(exp.run_path, "checkpoint.npz")
    assert os.readlink(alias) == ckpt.checkpoint_name(40)


def test_periodic_save_survives_faults(data_root, tmp_path, capsys):
    exp = port_exp(data_root, tmp_path, faults="ckpt_write:transient@1")
    try:
        exp.run(10)
        assert ckpt.list_checkpoints(exp.run_path)[-1][0] == 10
        faults.install("ckpt_write:fail@1")
        exp.run(10)  # the failed save is logged, training goes on
    finally:
        faults.reset()
    assert exp.step == 20
    assert [s for s, _ in ckpt.list_checkpoints(exp.run_path)] == [10]
    assert "checkpoint save failed at step 20" in capsys.readouterr().err


def test_failing_step_dumps_its_batch(data_root, tmp_path):
    exp = port_exp(data_root, tmp_path)
    faults.install("train_step:fail@3")
    try:
        with pytest.raises(faults.InjectedFailure):
            exp.run(10)
    finally:
        faults.reset()
    assert exp.step == 2
    bad = np.load(os.path.join(exp.run_path, "bad_batch.npz"))
    assert bad["packed"].shape == (8, 9, 19, 19)


def test_warm_restart_keeps_weights_fresh_optimizer(data_root, tmp_path):
    exp = port_exp(data_root, tmp_path, momentum=0.9)
    exp.run(10)
    path = exp.save()
    warm = warm_restart(path, {"rate": 0.01}, num=2, device="cpu")
    assert warm.id != exp.id and warm.step == 10
    assert warm.config.seed == 2 and warm.config.rate == 0.01
    assert_bitwise(port_leaves(warm)[0], port_leaves(exp)[0])
    assert float(warm.opt_state["rate"]) == np.float32(0.01)
    assert all(not v.any() for v in warm.opt_state["velocity"].values())


@pytest.mark.parametrize("field,value,item", [
    ("data_parallel", 2, "A6"), ("tensor_parallel", 2, "A6"),
    ("elastic", True, "A6"), ("profile", True, "A7")])
def test_what_one_card_cannot_honour_raises(data_root, tmp_path, field,
                                            value, item):
    exp = port_exp(data_root, tmp_path, **{field: value})
    with pytest.raises(ValueError, match=item):
        exp.init()


def test_config_round_trips_through_jax(data_root, tmp_path):
    cfg = ExperimentConfig(**tiny(data_root, tmp_path, momentum=0.5,
                                  wire_format="nibble"))
    assert JaxExperimentConfig.from_dict(cfg.to_dict()).to_dict() == \
        cfg.to_dict()
    assert ExperimentConfig().to_dict() == JaxExperimentConfig().to_dict()
    assert json.loads(json.dumps(cfg.to_dict())) == cfg.to_dict()


def test_wire_auto_and_steps_per_call_on_the_cpu(data_root, tmp_path):
    exp = port_exp(data_root, tmp_path, print_interval=10)
    exp.init()
    assert exp.wire == "packed" and exp._steps_per_call() == 1
    exp = port_exp(data_root, tmp_path, steps_per_call=4, wire_format="nibble")
    exp.init()
    assert exp.wire == "nibble" and exp._steps_per_call() == 2
    exp.run(10)
    assert exp.step == 10 and np.isfinite(exp.ewma)


def test_experiment_on_cuda_raises_without_cuda(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is of a CPU-only host")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Experiment(ExperimentConfig(**tiny(data_root, tmp_path)))
