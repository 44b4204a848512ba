"""The port's policy CNN against the JAX package's, on shared weights.

Weights and boards are made with numpy and handed to both packages. Bars:

* float32: max-abs difference in log-probs <= 1e-4.
* bfloat16 against the JAX float32 reference: max-abs drift <= 0.5 over
  points the reference gives p >= 1e-3 (``quant.ToleranceConfig``'s cap),
  and top-1 agreement 1.0 on rows whose reference top-1 margin is >= 0.05
  in log-prob. With random weights the policy is nearly flat and most rows
  are near-ties that bf16 rounding may flip, also inside JAX itself, so
  top-1 is held only where the reference is decided; the test requires at
  least 32 such rows so it is never vacuous.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepgo_tpu.models import policy_cnn as jax_policy
from deepgo_tpu.models.serving import make_policy_fn as jax_make_policy_fn
from deepgo_tpu.ops.expand import expand_planes as jax_expand

from deepgo_tpu_torch.models import convert, policy_cnn
from deepgo_tpu_torch.models.serving import make_log_prob_fn, make_policy_fn

torch.set_num_threads(2)

F32_TOL = 1e-4
DRIFT_CAP, PROB_FLOOR = 0.5, 1e-3
MARGIN, MIN_DECIDED_ROWS = 0.05, 32


def numpy_tree(cfg, seed=0, bias_scale=0.1):
    """He-normal weights and non-zero per-position biases, JAX layout."""
    rng = np.random.default_rng(seed)
    layers = []
    for k, c_in, c_out in cfg.layer_shapes():
        w = rng.standard_normal((k, k, c_in, c_out)) * np.sqrt(
            2.0 / (k * k * c_in))
        b = rng.standard_normal((19, 19, c_out)) * bias_scale
        layers.append({"w": w.astype(np.float32), "b": b.astype(np.float32)})
    return {"layers": layers}


def boards(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, size=(n, 9, 19, 19), dtype=np.uint8),
            rng.integers(1, 3, size=n).astype(np.int32),
            rng.integers(1, 10, size=n).astype(np.int32))


def jax_log_probs(tree, cfg, packed, player, rank):
    params = jax.tree.map(jnp.asarray, tree)
    fn = jax.jit(lambda p, x, y, z: jax_policy.log_policy(
        p, jax_expand(x, y, z, dtype=jnp.dtype(cfg.compute_dtype)), cfg))
    return np.asarray(fn(params, packed, player, rank))


def port_log_probs(tree, cfg, packed, player, rank):
    model = convert.model_from_jax(tree, cfg, device="cpu")
    return make_log_prob_fn(cfg, device="cpu")(model, packed, player, rank)


def port_config(jax_cfg, **overrides):
    fields = {f.name: getattr(jax_cfg, f.name)
              for f in dataclasses.fields(jax_cfg)}
    return policy_cnn.ModelConfig(**{**fields, **overrides})


def test_configs_mirror_jax():
    assert set(policy_cnn.CONFIGS) == set(jax_policy.CONFIGS)
    for name, jcfg in jax_policy.CONFIGS.items():
        assert dataclasses.asdict(policy_cnn.CONFIGS[name]) == \
            dataclasses.asdict(jcfg), name
        assert policy_cnn.CONFIGS[name].layer_shapes() == jcfg.layer_shapes()


def test_config_rejects_unsupported_compute_dtype():
    with pytest.raises(ValueError, match="compute_dtype"):
        policy_cnn.ModelConfig(compute_dtype="float16")
    with pytest.raises(ValueError, match="channels tuple"):
        policy_cnn.ModelConfig(num_layers=3, channels=(8,)).layer_shapes()


@pytest.mark.parametrize("name", ["small", "full"])
def test_params_round_trip_bitwise(name):
    cfg = policy_cnn.CONFIGS[name]
    tree = numpy_tree(cfg, seed=3)
    model = convert.model_from_jax(tree, cfg, device="cpu")
    back = convert.params_to_jax(model)
    assert len(back["layers"]) == len(tree["layers"])
    for got, want in zip(back["layers"], tree["layers"]):
        for key in ("w", "b"):
            assert got[key].dtype == want[key].dtype
            assert np.array_equal(got[key], want[key])
    # OIHW / (C, 19, 19) inside the module
    k, c_in, c_out = cfg.layer_shapes()[0]
    assert tuple(model.layers[0].weight.shape) == (c_out, c_in, k, k)
    assert tuple(model.layers[0].bias.shape) == (c_out, 19, 19)


def test_mismatched_tree_is_refused():
    tree = numpy_tree(policy_cnn.CONFIGS["small"])
    with pytest.raises(RuntimeError):
        convert.model_from_jax(tree, policy_cnn.CONFIGS["medium"],
                               device="cpu")


@pytest.mark.parametrize("name,n", [("small", 32), ("full", 16)])
def test_float32_forward_matches_jax(name, n):
    jcfg = dataclasses.replace(jax_policy.CONFIGS[name],
                               compute_dtype="float32")
    tree = numpy_tree(jcfg, seed=1)
    packed, player, rank = boards(n, seed=2)
    want = jax_log_probs(tree, jcfg, packed, player, rank)
    got = port_log_probs(tree, port_config(jcfg), packed, player, rank)
    assert got.shape == (n, 361) and got.dtype == np.float32
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("variant", ["final_relu", "channel_schedule"])
def test_float32_forward_matches_jax_variants(variant):
    over = ({"final_relu": True} if variant == "final_relu"
            else {"num_layers": 4, "channels": (16, 8, 12)})
    jcfg = dataclasses.replace(jax_policy.ModelConfig(num_layers=3,
                                                      channels=16),
                               compute_dtype="float32", **over)
    tree = numpy_tree(jcfg, seed=4)
    packed, player, rank = boards(16, seed=5)
    want = jax_log_probs(tree, jcfg, packed, player, rank)
    got = port_log_probs(tree, port_config(jcfg), packed, player, rank)
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("name", ["small", "full"])
def test_bfloat16_forward_meets_the_bar(name):
    jcfg = jax_policy.CONFIGS[name]
    tree = numpy_tree(jcfg, seed=1)
    packed, player, rank = boards(256, seed=6)
    ref = jax_log_probs(tree, dataclasses.replace(jcfg,
                                                  compute_dtype="float32"),
                        packed, player, rank)
    cfg = port_config(jcfg)
    assert cfg.compute_dtype == "bfloat16"
    got = port_log_probs(tree, cfg, packed, player, rank)
    assert np.isfinite(got).all()
    drift = np.abs(got - ref)[np.exp(ref) >= PROB_FLOOR].max()
    assert drift <= DRIFT_CAP
    top2 = np.sort(ref, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] >= MARGIN
    assert decided.sum() >= MIN_DECIDED_ROWS
    assert np.array_equal(got.argmax(1)[decided], ref.argmax(1)[decided])


def test_policy_fn_ranks_moves_like_jax():
    jcfg = dataclasses.replace(jax_policy.CONFIGS["small"],
                               compute_dtype="float32")
    tree = numpy_tree(jcfg, seed=7)
    packed, player, rank = boards(8, seed=8)
    want = jax_make_policy_fn(jcfg, top_k=3)(
        jax.tree.map(jnp.asarray, tree), packed, player, rank)
    cfg = port_config(jcfg)
    model = convert.model_from_jax(tree, cfg, device="cpu")
    got = make_policy_fn(cfg, top_k=3, device="cpu")(model, packed, player,
                                                     rank)
    assert np.array_equal(got["top_moves"], np.asarray(want["top_moves"]))
    assert np.abs(got["top_probs"] - np.asarray(want["top_probs"])).max() \
        <= F32_TOL
    assert np.abs(got["log_probs"] - np.asarray(want["log_probs"])).max() \
        <= F32_TOL


def test_init_is_he_normal_and_seeded():
    cfg = policy_cnn.CONFIGS["small"]
    a = policy_cnn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = policy_cnn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for la, lb in zip(a.layers, b.layers):
        assert torch.equal(la.weight, lb.weight)
        assert not la.bias.any()
    w = a.layers[1].weight
    k, c_in = w.shape[-1], w.shape[1]
    assert abs(w.std().item() - np.sqrt(2.0 / (k * k * c_in))) < 0.01
    assert sum(p.numel() for p in a.parameters()) == sum(
        k * k * ci * co + 361 * co for k, ci, co in cfg.layer_shapes())


def test_forward_refuses_a_model_of_another_config():
    cfg = policy_cnn.CONFIGS["small"]
    model = policy_cnn.init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    other = dataclasses.replace(cfg, compute_dtype="float32")
    packed, player, rank = boards(1)
    with pytest.raises(ValueError, match="config"):
        make_log_prob_fn(other, device="cpu")(model, packed, player, rank)
