"""AlphaGo Zero's dual-head network in the port (``models/resnet.py``, the
joint loss of ``training/steps.py``, the loader's outcome column) against
the plain float32 reference ``reference/agz_resnet.py``, on the CPU.

Weights are seeded random, BN scales and shifts and dense biases drawn
away from their initial 1 and 0 so that the comparison covers them. The
float32 network is held to the reference within float32 round-off; the
bfloat16 network within a tolerance that bfloat16 meets and float8
rounding of the activations does not.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from deepgo_tpu_torch.data import dataset, loader
from deepgo_tpu_torch.models import resnet
from deepgo_tpu_torch.ops import expand_planes
from deepgo_tpu_torch.training import optimizers, steps
from reference import agz_resnet as ref

torch.set_num_threads(2)

SMALL = dict(blocks=3, channels=16)
B = 32


def leaves_for(cfg: resnet.ResNetConfig, seed: int) -> dict:
    """Seeded leaves named as the reference names them: He-normal weights,
    BN scale 1 + N(0, 0.1^2), BN shift and dense bias N(0, 0.1^2)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in ref.leaf_shapes(cfg.blocks, cfg.channels,
                                       cfg.input_planes, cfg.value_hidden):
        t = torch.randn(shape, generator=gen)
        if name.endswith(".bn.weight"):
            t = 1.0 + 0.1 * t
        elif name.endswith(".weight"):
            t = t * math.sqrt(2.0 / math.prod(shape[1:]))
        else:
            t = 0.1 * t
        out[name] = t
    return out


def port_model(cfg: resnet.ResNetConfig, leaves: dict) -> resnet.DualResNet:
    model = resnet.DualResNet(cfg)
    named = dict(model.named_parameters())
    assert list(named) == list(leaves)
    with torch.no_grad():
        for n, t in leaves.items():
            named[n].copy_(t)
    return model


def records(seed: int, n: int):
    """Random packed records (every plane fires), players, ranks, targets
    and decided outcomes."""
    rng = np.random.default_rng(seed)
    hi = np.array([2, 6, 8, 8, 8, 8, 6, 2, 2]).reshape(1, -1, 1, 1) + 1
    packed = rng.integers(0, hi, size=(n, 9, 19, 19)).astype(np.uint8)
    return {"packed": torch.from_numpy(packed),
            "player": torch.from_numpy(rng.integers(1, 3, n).astype(np.int32)),
            "rank": torch.from_numpy(rng.integers(1, 10, n).astype(np.int32)),
            "target": torch.from_numpy(
                rng.integers(0, 361, n).astype(np.int32)),
            "z": torch.from_numpy(
                rng.choice([-1.0, 1.0], n).astype(np.float32))}


def planes_nhwc(batch: dict) -> torch.Tensor:
    return expand_planes(batch["packed"], batch["player"], batch["rank"],
                         dtype=torch.float32)


def port_readings(model, batch):
    """(logits, value, joint loss, gradient by leaf) of one train-mode
    forward and backward of the port."""
    model.train()
    params = list(model.parameters())
    logits, value = model(planes_nhwc(batch))
    loss = steps.joint_loss(logits, value, batch["target"], batch["z"])
    grads = list(torch.autograd.grad(loss, params))
    loss = steps.add_l2(grads, params, model.l2_weights(), loss.detach())
    return logits, value, loss, grads


def ref_readings(leaves, batch, precision="float32"):
    stats = ref.fresh_stats(leaves)
    params = {n: t.clone().requires_grad_(True) for n, t in leaves.items()}
    x = planes_nhwc(batch).permute(0, 3, 1, 2).contiguous()
    logits, value = ref.forward(params, stats, x, precision=precision)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, batch["target"].long().view(-1, 1)).mean()
    l2 = sum((params[n] ** 2).sum() for n in ref.l2_names(params))
    loss = ((batch["z"] - value) ** 2).mean() + nll + resnet.L2_WEIGHT * l2
    grads = torch.autograd.grad(loss, list(params.values()))
    return logits, value, loss.detach(), grads, stats


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| over |b|, as norms."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# The gradients' float32 limit. The port runs channels-last; on the CPU,
# BN's channels-last backward kernel loses bits where a channel's mean is
# large against its spread, as it is after a ReLU: through this trunk the
# input gradients come out within 3.2e-3 of a float64 reference, where the
# same network in NCHW comes within 6e-7 (and the reference within 1.4e-6).
# 1e-2 still lies ten times under the bfloat16 gaps below.
GRAD_F32 = 1e-2


def test_float32_forward_loss_gradients_and_stats_match_the_reference():
    """Float32 both sides: the same mathematics in another summation order
    (oneDNN's convolutions, BN's fused statistics), so the forward, the
    loss and the running statistics agree to a few float32 ulps of their
    scale, 1e-5 relative on norms; the gradients within ``GRAD_F32``."""
    cfg = resnet.ResNetConfig(**SMALL, compute_dtype="float32")
    leaves = leaves_for(cfg, 1)
    batch = records(11, B)
    model = port_model(cfg, leaves)
    logits, value, loss, grads = port_readings(model, batch)
    r_logits, r_value, r_loss, r_grads, r_stats = ref_readings(leaves, batch)
    assert rel(logits, r_logits) < 1e-5
    assert rel(value, r_value) < 1e-5
    assert abs(float(loss) - float(r_loss)) < 1e-5 * abs(float(r_loss))
    for name, g, rg in zip(leaves, grads, r_grads):
        assert rel(g, rg) < GRAD_F32, name
    for name, s in r_stats.items():
        bn = model.get_submodule(name)
        assert rel(bn.running_mean, s["mean"]) < 1e-5, name
        assert rel(bn.running_var, s["var"]) < 1e-5, name


def bf16_gaps(precision):
    """Relative gaps of the logits, the value and the median leaf's
    gradient between the bfloat16 port (or, with ``precision="fp8"``, the
    reference rounded to float8) and the float32 reference."""
    cfg = resnet.ResNetConfig(**SMALL, compute_dtype="bfloat16")
    leaves = leaves_for(cfg, 2)
    batch = records(12, 64)
    r_logits, r_value, _, r_grads, _ = ref_readings(leaves, batch)
    if precision == "bfloat16":
        logits, value, _, grads = port_readings(port_model(cfg, leaves),
                                                batch)
    else:
        logits, value, _, grads, _ = ref_readings(leaves, batch, "fp8")
    grad_gap = float(np.median([rel(g, rg) for g, rg in zip(grads, r_grads)]))
    return rel(logits, r_logits), rel(value, r_value), grad_gap


# bfloat16 keeps 8 significant bits (relative rounding 2^-9 a value), and
# each of the 5 convolutions and 3 dense layers adds its rounding to the
# tensors that flow through: here the logits come within 1.1 % of float32,
# the value within 1.6 % and the median leaf's gradient within 9.7 %.
# Float8 e4m3 keeps 4 bits, 16 times coarser: 16 %, 23 % and 72 %. The
# limits leave bfloat16 two and a half times its reading or more, and
# float8 fails every one of them.
BF16_LIMITS = {"logits": 0.04, "value": 0.06, "grad": 0.25}


def test_bfloat16_matches_the_reference_where_float8_does_not():
    got = dict(zip(BF16_LIMITS, bf16_gaps("bfloat16")))
    fp8 = dict(zip(BF16_LIMITS, bf16_gaps("fp8")))
    for k, limit in BF16_LIMITS.items():
        assert got[k] < limit < fp8[k], (k, got, fp8)


def test_three_momentum_steps_match_the_reference():
    """``make_train_step`` on a ResNetConfig (SGD 0.01, momentum 0.9) for
    three steps against the reference's three: each loss, each leaf after
    the third step, the running statistics. Float32 both sides; parameters
    after the steps agree to 1e-5 relative (a parameter moves by about
    rate x gradient a step, so the gradients' round-off reaches it scaled
    down)."""
    cfg = resnet.ResNetConfig(**SMALL, compute_dtype="float32")
    leaves = leaves_for(cfg, 3)
    model = port_model(cfg, leaves)
    optimizer = optimizers.sgd(0.01, momentum=0.9)
    state = optimizer.init(model)
    step = steps.make_train_step(cfg, optimizer)
    batches = [records(20 + i, B) for i in range(3)]
    losses = []
    for b in batches:
        model, state, loss = step(model, state, b)
        losses.append(float(loss))
    r_batches = [{"x": planes_nhwc(b).permute(0, 3, 1, 2).contiguous(),
                  "target": b["target"], "z": b["z"]} for b in batches]
    r_losses, _, after, r_stats = ref.sgd_steps(
        leaves, ref.fresh_stats(leaves), r_batches, 0.01, 0.9,
        resnet.L2_WEIGHT)
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    for name, p in model.named_parameters():
        assert rel(p.detach() - leaves[name], after[2][name] - leaves[name]) \
            < 1e-4, name  # the change itself, a tighter view than p
        assert rel(p.detach(), after[2][name]) < 1e-5, name
    for name, s in r_stats.items():
        bn = model.get_submodule(name)
        assert rel(bn.running_mean, s["mean"]) < 1e-5, name
        assert rel(bn.running_var, s["var"]) < 1e-5, name


def test_many_steps_equal_single_steps_and_anchor_is_refused():
    cfg = resnet.ResNetConfig(**SMALL, compute_dtype="float32")
    leaves = leaves_for(cfg, 4)
    batches = [records(30 + i, 8) for i in range(2)]
    optimizer = optimizers.sgd(0.01, momentum=0.9)
    one = port_model(cfg, leaves)
    state = optimizer.init(one)
    step = steps.make_train_step(cfg, optimizer)
    singles = []
    for b in batches:
        one, state, loss = step(one, state, b)
        singles.append(loss)
    many = port_model(cfg, leaves)
    super_batch = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    many, _, losses = steps.make_train_step_many(cfg, optimizer)(
        many, optimizer.init(many), super_batch)
    assert torch.equal(losses, torch.stack(singles))
    for p, q in zip(one.parameters(), many.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="anchor"):
        steps.make_train_step(cfg, optimizer, anchor=(one, cfg, 0.5))


def test_eval_step_runs_the_policy_in_eval_mode():
    """Eval mode normalises by the running statistics: after one train
    step they are no longer (0, 1), and the eval step's NLL is the
    reference's eval-mode forward's. The model's mode is restored."""
    cfg = resnet.ResNetConfig(**SMALL, compute_dtype="float32")
    leaves = leaves_for(cfg, 5)
    model = port_model(cfg, leaves)
    optimizer = optimizers.sgd(0.0)
    state = optimizer.init(model)
    model, state, _ = steps.make_train_step(cfg, optimizer)(
        model, state, records(40, B))
    batch = records(41, 16)
    assert model.training
    sum_nll, correct = steps.make_eval_step(cfg)(model, batch)
    assert model.training
    stats = {name: {"mean": model.get_submodule(name).running_mean.clone(),
                    "var": model.get_submodule(name).running_var.clone()}
             for name in ref.fresh_stats(leaves)}
    x = planes_nhwc(batch).permute(0, 3, 1, 2).contiguous()
    logits, _ = ref.forward(leaves, stats, x, training=False)
    logp = torch.log_softmax(logits, dim=-1)
    want = -logp.gather(1, batch["target"].long().view(-1, 1)).sum()
    assert float(sum_nll) == pytest.approx(float(want), rel=1e-5)
    assert int(correct) == int((logits.argmax(-1) == batch["target"]).sum())


def write_split(root: str, games: int = 6, positions: int = 9,
                winner=True) -> dict:
    """A split of unique random records; ``winner.npy`` holds a winner per
    game (0 for the undecided last game)."""
    n = games * positions
    batch = records(50, n)
    rng = np.random.default_rng(51)
    meta = np.stack([batch["player"].numpy(), rng.integers(0, 19, n),
                     rng.integers(0, 19, n), rng.integers(1, 10, n),
                     rng.integers(1, 10, n),
                     np.repeat(np.arange(games), positions)],
                    axis=1).astype(np.int32)
    split = os.path.join(root, "train")
    os.makedirs(split)
    batch["packed"].numpy().tofile(os.path.join(split, "planes.bin"))
    np.save(os.path.join(split, "meta.npy"), meta)
    with open(os.path.join(split, "games.json"), "w") as f:
        json.dump([{"name": f"g{g}", "start": g * positions,
                    "count": positions} for g in range(games)], f)
    won = np.repeat(np.r_[rng.integers(1, 3, games - 1), 0], positions)
    if winner:
        np.save(os.path.join(split, "winner.npy"), won.astype(np.int8))
    return {"packed": batch["packed"].numpy().reshape(n, -1),
            "player": meta[:, 0], "winner": won}


@pytest.mark.parametrize("threads,stack", [(0, 0), (2, 0), (2, 2)])
def test_loader_outcome_column_matches_the_sidecar(tmp_path, threads, stack):
    raw = write_split(str(tmp_path))
    index = {row.tobytes(): i for i, row in enumerate(raw["packed"])}
    ds = dataset.GoDataset(str(tmp_path), "train")
    with loader.AsyncLoader(ds, 16, seed=7, num_threads=threads, stack=stack,
                            device="cpu", outcome=True) as ld:
        seen = set()
        for _ in range(4):
            batch = ld.get()
            packed = batch["packed"].reshape(-1, 9 * 361).numpy()
            z = batch["z"].reshape(-1).numpy()
            assert batch["z"].dtype == torch.float32
            for row, got in zip(packed, z):
                i = index[row.tobytes()]
                w, me = raw["winner"][i], raw["player"][i]
                assert got == (0.0 if w == 0 else 1.0 if w == me else -1.0)
                seen.add(float(got))
    assert seen == {-1.0, 0.0, 1.0}
    with loader.AsyncLoader(ds, 16, seed=7, num_threads=threads, stack=stack,
                            device="cpu") as ld:
        assert "z" not in ld.get()


def test_loader_outcome_needs_the_sidecar(tmp_path):
    write_split(str(tmp_path), winner=False)
    ds = dataset.GoDataset(str(tmp_path), "train")
    with pytest.raises(FileNotFoundError, match="winner.npy"):
        loader.AsyncLoader(ds, 4, num_threads=0, device="cpu", outcome=True)


def test_agz_sizes():
    counts = {name: sum(p.numel() for p in resnet.DualResNet(cfg).parameters())
              for name, cfg in resnet.CONFIGS.items()}
    assert counts == {"agz20": 22_873_234, "agz40": 46_486_674}
    assert resnet.CONFIGS["agz40"].torch_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        resnet.ResNetConfig(compute_dtype="float16")


def test_the_reference_imports_neither_package_and_turns_tf32_off():
    """In a fresh process: importing the reference loads nothing of either
    package nor JAX, and stepping turns TF32 off for convolutions and
    matrix products."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "from reference import agz_resnet as ref\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'deepgo_tpu', 'deepgo_tpu_torch'})\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "leaves = {n: torch.randn(s) * 0.1 + (1.0 if n.endswith('.bn.weight')"
        " else 0.0) for n, s in ref.leaf_shapes(1, 4)}\n"
        "batch = {'x': torch.randn(2, 37, 19, 19), 'target': "
        "torch.tensor([3, 5]), 'z': torch.tensor([1.0, -1.0])}\n"
        "ref.sgd_steps(leaves, ref.fresh_stats(leaves), [batch], 0.01)\n"
        "print(bad, torch.backends.cudnn.allow_tf32, "
        "torch.backends.cuda.matmul.allow_tf32)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["[]", "False", "False"]
