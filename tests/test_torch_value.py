"""The port's value net (``models/value_cnn.py``) and its serving path.

Weights made with ``jax.random`` in the JAX package go through
``models/convert.value_from_jax`` into the port; the same boards (numpy,
seeded) go through the JAX ``make_value_fn`` and the port's. Tolerances:
float32 win-probs within 1e-5 of JAX's (the same arithmetic, summed in
another order on the CPU); the port's bfloat16 forward within 0.01 of
JAX's float32 one (JAX's own bfloat16-vs-float32 spread on these nets is
about 0.003); rows served by the engines bitwise equal to the port's
direct forward at the rung they dispatched on."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepgo_tpu.experiments.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from deepgo_tpu.models import value_cnn as jax_value
from deepgo_tpu.models.serving import load_value as jax_load_value
from deepgo_tpu.models.serving import make_value_fn as jax_make_value_fn

from deepgo_tpu_torch.experiments import checkpoint as ckpt
from deepgo_tpu_torch.models import convert, policy_cnn, value_cnn
from deepgo_tpu_torch.models.serving import load_value, make_value_fn
from deepgo_tpu_torch.serving import (BucketLadder, EngineConfig,
                                      fleet_value_engine, shared_value_engine,
                                      close_shared_engines,
                                      supervised_value_engine, value_engine)

from test_torch_policy import boards

torch.set_num_threads(2)

DEFAULT = value_cnn.ValueConfig()
NARROW = value_cnn.ValueConfig(num_layers=2, channels=8, head_hidden=16)
CONFIGS = {"default": DEFAULT, "narrow": NARROW}
F32_TOL = 1e-5
BF16_TOL = 0.01
ECFG = EngineConfig(buckets=(1, 8), max_wait_ms=5.0)


def jax_cfg(cfg, **changes):
    return jax_value.ValueConfig(**{**dataclasses.asdict(cfg), **changes})


def jax_tree(cfg, seed=0):
    """JAX-initialised value weights with non-zero biases, as numpy."""
    tree = jax.tree.map(np.asarray,
                        jax_value.init(jax.random.key(seed), jax_cfg(cfg)))
    rng = np.random.default_rng(seed)
    for leaf in (*tree["layers"], tree["head_conv"], tree["dense1"],
                 tree["dense2"]):
        leaf["b"] = (rng.standard_normal(leaf["b"].shape) * 0.1) \
            .astype(np.float32)
    return tree


def port_model(tree, cfg):
    model = value_cnn.ValueCNN(cfg)
    model.load_state_dict(convert.value_from_jax(tree))
    return model


def jax_win_probs(tree, cfg, packed, player, rank):
    fn = jax_make_value_fn(jax_cfg(cfg))
    return np.asarray(fn(jax.tree.map(jnp.asarray, tree), packed, player,
                         rank))


def test_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(value_cnn.ValueConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_value.ValueConfig)}
    assert ours == ref
    assert DEFAULT.layer_shapes() == jax_value.ValueConfig().layer_shapes()
    with pytest.raises(ValueError):
        value_cnn.ValueConfig(compute_dtype="float16")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_value_from_jax_round_trip_bitwise(name):
    tree = jax_tree(CONFIGS[name], seed=3)
    back = convert.value_to_jax(port_model(tree, CONFIGS[name]))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float32_win_probs_match_jax(name):
    cfg = dataclasses.replace(CONFIGS[name], compute_dtype="float32")
    tree = jax_tree(cfg, seed=1)
    packed, player, rank = boards(32, seed=5)
    want = jax_win_probs(tree, cfg, packed, player, rank)
    got = make_value_fn(cfg, device="cpu")(port_model(tree, cfg), packed,
                                           player, rank)
    assert got.shape == (32,) and got.dtype == np.float32
    assert np.abs(got - want).max() <= F32_TOL


def test_bfloat16_within_bar_of_jax_float32():
    tree = jax_tree(DEFAULT, seed=2)
    packed, player, rank = boards(256, seed=6)
    want = jax_win_probs(tree, dataclasses.replace(
        DEFAULT, compute_dtype="float32"), packed, player, rank)
    got = make_value_fn(DEFAULT, device="cpu")(port_model(tree, DEFAULT),
                                               packed, player, rank)
    assert np.isfinite(got).all() and ((got > 0) & (got < 1)).all()
    assert np.abs(got - want).max() <= BF16_TOL


def test_init_is_seeded_he_normal():
    a = value_cnn.init(torch.Generator().manual_seed(0), NARROW, device="cpu")
    b = value_cnn.init(torch.Generator().manual_seed(0), NARROW, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
        if na.endswith("bias"):
            assert not pa.any(), na
    big = value_cnn.init(torch.Generator().manual_seed(1), DEFAULT,
                         device="cpu")
    w = big.dense1.weight.detach()
    assert abs(float(w.std()) - (2.0 / 361) ** 0.5) < 0.01


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_jax_written_value_checkpoint_serves_the_same(tmp_path,
                                                       compute_dtype):
    cfg = dataclasses.replace(NARROW, compute_dtype=compute_dtype)
    tree = jax_tree(cfg, seed=4)
    path = str(tmp_path / "value_checkpoint.npz")
    jax_save_checkpoint(path, jax.tree.map(jnp.asarray, tree), {}, {
        "kind": "value", "step": 1,
        "config": {"num_layers": cfg.num_layers, "channels": cfg.channels,
                   "head_hidden": cfg.head_hidden,
                   "compute_dtype": compute_dtype}})
    fn, model, got_cfg = load_value(path, device="cpu")
    assert got_cfg == cfg
    for name, t in convert.value_from_jax(tree).items():
        assert torch.equal(model.state_dict()[name], t), name
    packed, player, rank = boards(16, seed=7)
    got = fn(model, packed, player, rank)
    assert np.array_equal(got, make_value_fn(cfg, device="cpu")(
        port_model(tree, cfg), packed, player, rank))
    jfn, jparams, _ = jax_load_value(path)
    want = np.asarray(jfn(jparams, packed, player, rank))
    assert np.abs(got - want).max() <= (F32_TOL if compute_dtype == "float32"
                                        else BF16_TOL)


def test_load_value_refuses_other_checkpoints(tmp_path):
    path = str(tmp_path / "policy.npz")
    cfg = policy_cnn.ModelConfig(num_layers=2, channels=8)
    ckpt.save_checkpoint(path, convert.params_to_jax(
        policy_cnn.PolicyCNN(cfg)), {}, {"config": {}})
    with pytest.raises(ckpt.CheckpointError, match="not a value"):
        load_value(path, device="cpu")


def _rows_at_rung(forward, model, ladder, packed, player, rank, futures):
    for i, f in enumerate(futures):
        row = f.result(timeout=60)  # the rung stamp lands with the row
        want = forward(model, *ladder.pad(packed[i:i + 1], player[i:i + 1],
                                          rank[i:i + 1], f.bucket))[0]
        assert np.array_equal(row, want), i


@pytest.mark.parametrize("kind", ["engine", "supervised", "fleet", "shared"])
def test_value_engines_serve_the_direct_forward_bitwise(kind):
    tree = jax_tree(NARROW, seed=8)
    model = port_model(tree, NARROW)
    packed, player, rank = boards(12, seed=9)
    if kind == "engine":
        eng = value_engine(model, NARROW, config=ECFG, device="cpu")
    elif kind == "supervised":
        eng = supervised_value_engine(model, NARROW, config=ECFG,
                                      device="cpu")
    elif kind == "fleet":
        eng = fleet_value_engine(model, NARROW, replicas=2, config=ECFG,
                                 device="cpu")
    else:
        eng = shared_value_engine(model, NARROW, config=ECFG, fleet=2,
                                  device="cpu")
        assert shared_value_engine(model, NARROW, config=ECFG, fleet=2,
                                   device="cpu") is eng
    try:
        assert eng.warmup() == 2
        futures = [eng.submit(packed[i], int(player[i]), int(rank[i]))
                   for i in range(12)]
        _rows_at_rung(make_value_fn(NARROW, device="cpu"), model,
                      BucketLadder(ECFG.buckets), packed, player, rank,
                      futures)
    finally:
        if kind == "shared":
            close_shared_engines()
        else:
            eng.close()


def test_value_fleet_reloads_from_a_checkpoint_path(tmp_path):
    old, new = jax_tree(NARROW, seed=10), jax_tree(NARROW, seed=11)
    path = str(tmp_path / "value.npz")
    ckpt.save_checkpoint(path, new, {}, {"kind": "value", "config": {}})
    fleet = fleet_value_engine(port_model(old, NARROW), NARROW, replicas=2,
                               config=ECFG, device="cpu")
    try:
        assert fleet.reload(path)["replicas"] == 2
        packed, player, rank = boards(6, seed=12)
        futures = [fleet.submit(packed[i], int(player[i]), int(rank[i]))
                   for i in range(6)]
        _rows_at_rung(make_value_fn(NARROW, device="cpu"),
                      port_model(new, NARROW), BucketLadder(ECFG.buckets),
                      packed, player, rank, futures)
    finally:
        fleet.close()


def test_value_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = value_cnn.ValueCNN(NARROW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_value_fn(NARROW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        value_cnn.init(torch.Generator(), NARROW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_value(str(tmp_path / "absent.npz"))
    for factory in (value_engine, supervised_value_engine,
                    fleet_value_engine):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory(model, NARROW)
