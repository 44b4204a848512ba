"""The plain reference against the program, at tiny sizes on the CPU.

The reference must agree with the program's float32 paths to rounding, so
that on the card the only gap left is the program's bfloat16 compute."""

import numpy as np
import pytest
import torch

from benchmark import cost, data, weights
from benchmark.reference import compare, policy

from deepgo_tpu_torch.models import policy_cnn
from deepgo_tpu_torch.ops import expand as port_expand
from deepgo_tpu_torch.ops.wire import nibble_pack_np
from deepgo_tpu_torch.training import optimizers, steps

torch.set_num_threads(2)
TINY = {"num_layers": 3, "channels": 16, "first_kernel": 5, "kernel": 3,
        "input_planes": 37, "final_relu": False, "bias_std": 0.05}


def _model(dtype="float32", seed=7):
    cfg = policy_cnn.ModelConfig(num_layers=3, channels=16,
                                 compute_dtype=dtype)
    w = weights.make(TINY, seed, "cpu")
    model = policy_cnn.PolicyCNN(cfg)
    weights.load_into(model, w)
    return cfg, model, w


def _records(n, seed=3, top=15):
    return data.records(np.random.default_rng(seed), n, [top] * 9)


def test_planes_equal_the_port_expansion():
    packed, player, rank = _records(64)
    ref = policy.planes(*map(torch.from_numpy, (packed, player, rank)))
    port = port_expand.expand_planes(
        *map(torch.from_numpy, (packed, player, rank)), dtype=torch.float32)
    assert torch.equal(ref, port.permute(0, 3, 1, 2))


def test_unpack_nibbles_inverts_the_wire():
    packed, _, _ = _records(32)
    wire = torch.from_numpy(nibble_pack_np(packed))
    assert np.array_equal(policy.unpack_nibbles(wire).numpy(), packed)


def test_log_probs_match_the_port_float32_forward():
    cfg, model, w = _model()
    packed, player, rank = _records(48)
    args = list(map(torch.from_numpy, (packed, player, rank)))
    ref = policy.log_probs(w, *args)
    planes = port_expand.expand_planes(*args, dtype=torch.float32)
    with torch.no_grad():
        port = policy_cnn.log_policy(model, planes)
    assert torch.allclose(ref, port, atol=1e-5)


def test_sgd_steps_match_the_port_train_step():
    cfg, model, w = _model()
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        packed, player, rank = _records(16, seed=int(rng.integers(1 << 30)))
        target = rng.integers(0, 361, size=16).astype(np.int32)
        batches.append({k: torch.from_numpy(v) for k, v in zip(
            ("packed", "player", "rank", "target"),
            (packed, player, rank, target))})
    losses, first, after = policy.sgd_steps(w, batches, 0.005)
    opt = optimizers.sgd(0.005)
    state = opt.init(model)
    step = steps.make_train_step(model.cfg, opt)
    for i, batch in enumerate(batches):
        model, state, loss = step(model, state, batch)
        assert abs(float(loss) - losses[i]) < 1e-5
    for (rw, rb), layer in zip(after[-1], model.layers):
        assert torch.allclose(layer.weight, rw, atol=1e-6)
        assert torch.allclose(layer.bias, rb, atol=1e-6)


def test_fp8_control_reads_well_above_bfloat16():
    """At a test's size the control's drift is at least three times the
    program's bfloat16 drift, as it is on the card at the cells' sizes."""
    _, model16, w = _model("bfloat16")
    packed, player, rank = _records(64, top=8)
    args = list(map(torch.from_numpy, (packed, player, rank)))
    ref = policy.log_probs(w, *args).numpy()
    with torch.no_grad():
        run = policy_cnn.log_policy(model16, port_expand.expand_planes(
            *args, dtype=torch.bfloat16)).numpy()
    low = policy.log_probs(w, *args, precision="fp8").numpy()
    assert compare.logp_drift(low, ref, 1e-3) >= \
        3 * compare.logp_drift(run, ref, 1e-3)


def test_logp_drift_reads_the_widest_gap_over_likely_points():
    ref = np.log(np.array([[0.5, 0.4999, 0.0001]]))
    run = ref + np.array([[0.01, -0.02, 5.0]])
    assert compare.logp_drift(run, ref, 1e-3) == pytest.approx(0.02)
    assert compare.logp_drift(run * np.nan, ref, 1e-3) == float("inf")


def test_train_gaps_by_leaf():
    g = [np.ones(4), np.ones(9) * 2, np.ones(1) * 1e-9]
    ref = {"losses": [2.0, 2.0, 2.0], "grads": g, "changes": g}
    run = {"losses": [2.0, 2.2, 2.0], "grads": [x * 1.1 for x in g],
           "changes": [np.zeros_like(x) for x in g]}
    out = compare.train_gaps(run, ref)
    assert out["loss_gap"] == pytest.approx(0.1)
    assert out["grad_gap"] == pytest.approx(0.1)
    assert out["change_gap"] == pytest.approx(1.0)
    assert out["grad_diff"] == pytest.approx(0.1)


def test_cost_of_the_published_networks():
    full = {"num_layers": 12, "channels": 128, "first_kernel": 5,
            "kernel": 3, "input_planes": 37}
    assert cost.num_params(full) == 2_102_761
    assert cost.forward_flops(full) == pytest.approx(1.067e9, rel=1e-3)
    per = [cost.layer_flops(*s) for s in cost.layer_shapes(full)]
    assert cost.train_flops(full) == pytest.approx(3 * sum(per) - per[0])
    assert cost.expand_bytes(1) == 3249 + 8 + 26714
