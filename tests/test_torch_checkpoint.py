"""The port reads checkpoints the JAX package writes.

A checkpoint saved by ``deepgo_tpu.experiments.checkpoint.save_checkpoint``
loads through the port's ``load_policy`` and serves the same log-probs as
the JAX ``load_policy`` (float32, max-abs <= 1e-4); corrupt or mis-shaped
files raise the port's ``CheckpointError``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepgo_tpu.experiments import checkpoint as jax_ckpt
from deepgo_tpu.experiments.experiment import ExperimentConfig
from deepgo_tpu.models.serving import load_policy as jax_load_policy

from deepgo_tpu_torch.experiments import checkpoint as ckpt
from deepgo_tpu_torch.experiments.checkpoint import CheckpointError
from deepgo_tpu_torch.models.serving import load_policy

from test_torch_policy import boards, numpy_tree

torch.set_num_threads(2)


def write(path, config: ExperimentConfig, tree=None, opt_state=None,
          seed=0, **meta):
    cfg = config.model_config()
    tree = numpy_tree(cfg, seed=seed) if tree is None else tree
    jax_ckpt.save_checkpoint(
        str(path), tree, {"rate": np.float32(0.01)} if opt_state is None
        else opt_state,
        {"id": "t", "step": 3, "config": config.to_dict(), **meta})
    return str(path), tree


@pytest.mark.parametrize("config", [
    ExperimentConfig(num_layers=3, channels=16, compute_dtype="float32"),
    ExperimentConfig(num_layers=4, channel_schedule="16,8,12",
                     final_relu=True, compute_dtype="float32"),
])
def test_jax_checkpoint_serves_same_log_probs(tmp_path, config):
    path, _ = write(tmp_path / "c.npz", config)
    predict, model, cfg = load_policy(path, top_k=4, device="cpu")
    jpredict, jparams, jcfg = jax_load_policy(path, top_k=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    packed, player, rank = boards(16, seed=1)
    got = predict(model, packed, player, rank)
    want = jpredict(jparams, jnp.asarray(packed), jnp.asarray(player),
                    jnp.asarray(rank))
    assert np.abs(got["log_probs"] - np.asarray(want["log_probs"])).max() \
        <= 1e-4
    assert np.array_equal(got["top_moves"], np.asarray(want["top_moves"]))


def test_leaves_map_onto_the_module_bitwise(tmp_path):
    config = ExperimentConfig(num_layers=3, channels=8)
    path, tree = write(tmp_path / "c.npz", config, seed=2)
    meta, leaves, opt = ckpt.load_checkpoint(path)
    assert meta["step"] == 3 and len(opt) == 1
    cfg = ckpt.model_config_from_meta(meta, path)
    state = ckpt.policy_state_dict(leaves, cfg, path)
    for i, layer in enumerate(tree["layers"]):
        assert np.array_equal(state[f"layers.{i}.weight"].numpy(),
                              layer["w"].transpose(3, 2, 0, 1))
        assert np.array_equal(state[f"layers.{i}.bias"].numpy(),
                              layer["b"].transpose(2, 0, 1))


@pytest.mark.parametrize("config", [
    ExperimentConfig(),
    ExperimentConfig(num_layers=12, channels=128, final_relu=True,
                     remat=True),
    ExperimentConfig(num_layers=3, channel_schedule="32, 16"),
])
def test_model_config_mirrors_experiment_config(config):
    meta = {"config": config.to_dict()}
    assert dataclasses.asdict(ckpt.model_config_from_meta(meta)) == \
        dataclasses.asdict(config.model_config())


def flip_weight_byte(path, tree):
    data = bytearray(open(path, "rb").read())
    at = data.find(tree["layers"][0]["w"].tobytes()[:64])
    assert at > 0, "weight payload not found uncompressed"
    data[at + 5] ^= 0xFF
    open(path, "wb").write(bytes(data))


def test_flipped_byte_raises(tmp_path):
    path, tree = write(tmp_path / "c.npz",
                       ExperimentConfig(num_layers=2, channels=4))
    flip_weight_byte(path, tree)
    with pytest.raises(CheckpointError, match="corrupt|CRC") as ei:
        load_policy(path, device="cpu")
    assert ei.value.path == path


@pytest.mark.parametrize("damage,reason", [
    ("zero_length", "zero-length"),
    ("truncate", "truncated or corrupt"),
    ("no_meta", "no meta entry"),
    ("missing", "unreadable"),
])
def test_unreadable_files_raise(tmp_path, damage, reason):
    path, _ = write(tmp_path / "c.npz",
                    ExperimentConfig(num_layers=2, channels=4))
    if damage == "zero_length":
        open(path, "wb").close()
    elif damage == "truncate":
        data = open(path, "rb").read()
        open(path, "wb").write(data[: len(data) // 2])
    elif damage == "no_meta":
        np.savez(path, params_0000=np.arange(4.0))
    else:
        path = str(tmp_path / "absent.npz")
    with pytest.raises(CheckpointError, match=reason):
        ckpt.load_checkpoint(path)


def test_leaf_count_mismatch_raises(tmp_path):
    # meta says 3 layers, the stored tree has 2
    tree = numpy_tree(ExperimentConfig(num_layers=2, channels=4)
                      .model_config())
    path, _ = write(tmp_path / "c.npz",
                    ExperimentConfig(num_layers=3, channels=4), tree=tree)
    with pytest.raises(CheckpointError, match="leaves"):
        load_policy(path, device="cpu")


def test_leaf_shape_mismatch_raises(tmp_path):
    tree = numpy_tree(ExperimentConfig(num_layers=2, channels=8)
                      .model_config())
    path, _ = write(tmp_path / "c.npz",
                    ExperimentConfig(num_layers=2, channels=4), tree=tree)
    with pytest.raises(CheckpointError, match="leaf 0"):
        load_policy(path, device="cpu")


def test_corrupt_mesh_manifest_raises(tmp_path):
    path, _ = write(tmp_path / "c.npz",
                    ExperimentConfig(num_layers=2, channels=4),
                    mesh={"data": 2, "model": 2, "devices": 3,
                          "params": [], "opt_state": []})
    with pytest.raises(CheckpointError, match="inconsistent"):
        ckpt.load_checkpoint(path)


def test_unsupported_compute_dtype_raises(tmp_path):
    path, _ = write(tmp_path / "c.npz",
                    ExperimentConfig(num_layers=2, channels=4,
                                     compute_dtype="float16"))
    with pytest.raises(CheckpointError, match="compute_dtype"):
        load_policy(path, device="cpu")
