"""AlphaGo Zero's dual-head residual network, its loss and momentum SGD, in
plain float32 PyTorch: the one plain reference of the network. The
benchmark's ``agz40`` cells judge the program by it, and the port's tests
(through ``reference/agz_resnet.py``) hold ``models/resnet.py`` and
``training/steps.py`` to it.

Written from Silver et al. 2017, "Mastering the game of Go without human
knowledge" (Nature 550:354), Methods, "Neural network architecture" and
"Optimization", not from the program: it imports nothing of
``deepgo_tpu_torch``, ``deepgo_tpu`` or ``jax``, and takes from a run only
the inputs and the weights that the caller made.

The network, on NCHW float32 planes:

- a convolutional block: conv 3x3 (no bias), BN, ReLU;
- ``blocks - 1`` residual blocks: conv 3x3, BN, ReLU, conv 3x3, BN, the
  block's input added, ReLU;
- a policy head: conv 1x1 of 2 filters, BN, ReLU, a dense layer to the
  logits;
- a value head: conv 1x1 of 1 filter, BN, ReLU, a dense layer of
  ``value_hidden``, ReLU, a dense layer to 1, tanh.

The loss: l = (z - v)^2 - pi^T log p + c ||theta||^2, each term a mean
over the batch, pi the one-hot move played, theta every convolution and
dense weight. The optimiser: SGD with momentum, v = m v + g, theta -=
rate v.

Departures from the paper, each of the repository's format or a size the
paper does not give:

- 37 input planes (the repository's features) where the paper has 17;
- 361 policy outputs where the paper has 362: the data has no pass move;
- BN's epsilon and momentum are PyTorch's (1e-5, 0.1) and its running
  variance is the unbiased one, as ``F.batch_norm`` keeps it: the paper
  gives none of them;
- the L2 term covers convolution and dense weights, not BN's scale and
  shift nor the dense biases (the paper says "parameters");
- the paper's batch is spread over 64 workers, each with its own BN
  statistics; here one batch is one BN batch.

Leaves are a dict of named float32 tensors, named as a module tree would
name them (``stem.weight``, ``stem.bn.weight``, ``blocks.{i}.conv1...``,
``policy_conv...``, ``policy_fc.weight``, ``value_fc2.bias``); running
statistics a dict of BN name -> {"mean", "var"}, updated in place by a
forward in training mode.

``precision`` rounds every tensor the program holds in bfloat16
(convolution and dense weights and biases, each convolution's, BN +
ReLU's, residual sum's and dense layer's output) and each gradient on its
way back: ``"fp8"`` is the control, as ``policy.py``'s (float8 e4m3 under
one scale a tensor, gradients e5m2), which the comparison of a bfloat16
run must call wrong; ``"bfloat16"`` is bfloat16 itself, the reference's own
reading of what bfloat16 costs at a depth. Every entry point turns TF32
off first, so that float32 is float32 on a card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .policy import _fp8, _strict_float32

POINTS = 361
POLICY_FILTERS = 2
VALUE_FILTERS = 1


def leaf_shapes(blocks: int, channels: int, input_planes: int = 37,
                value_hidden: int = 256) -> list[tuple[str, tuple]]:
    """[(name, shape)] of every trained leaf, in the order a module tree
    of the network lists its parameters."""
    out = []

    def conv_bn(name, k, c_in, c_out):
        out.extend([(f"{name}.weight", (c_out, c_in, k, k)),
                    (f"{name}.bn.weight", (c_out,)),
                    (f"{name}.bn.bias", (c_out,))])

    def dense(name, c_in, c_out):
        out.extend([(f"{name}.weight", (c_out, c_in)),
                    (f"{name}.bias", (c_out,))])

    conv_bn("stem", 3, input_planes, channels)
    for i in range(blocks - 1):
        conv_bn(f"blocks.{i}.conv1", 3, channels, channels)
        conv_bn(f"blocks.{i}.conv2", 3, channels, channels)
    conv_bn("policy_conv", 1, channels, POLICY_FILTERS)
    dense("policy_fc", POLICY_FILTERS * POINTS, POINTS)
    conv_bn("value_conv", 1, channels, VALUE_FILTERS)
    dense("value_fc1", VALUE_FILTERS * POINTS, value_hidden)
    dense("value_fc2", value_hidden, 1)
    return out


def fresh_stats(leaves: dict) -> dict:
    """Running statistics before any step: mean 0, variance 1."""
    return {name[:-len(".weight")]: {"mean": torch.zeros_like(t),
                                     "var": torch.ones_like(t)}
            for name, t in leaves.items() if name.endswith(".bn.weight")}


def l2_names(leaves: dict) -> list[str]:
    """The leaves the L2 term covers: convolution and dense weights."""
    return [n for n in leaves
            if n.endswith(".weight") and not n.endswith(".bn.weight")]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Bf16(torch.autograd.Function):
    """Rounds to bfloat16 on the way forward and the gradient on the way
    back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).float()


def _rounding(precision: str):
    if precision == "fp8":
        return _fp8
    if precision == "bfloat16":
        return _Bf16.apply
    if precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return _identity


def forward(leaves: dict, stats: dict, x: torch.Tensor,
            training: bool = True, bn_eps: float = 1e-5,
            bn_momentum: float = 0.1, precision: str = "float32"):
    """x: (B, 37, 19, 19) float32 planes -> (logits (B, 361), value (B,)).
    In training mode BN normalises by the batch's statistics and updates
    ``stats``; otherwise it normalises by ``stats``."""
    q = _rounding(precision)

    def conv_bn_relu(name, h):
        w = leaves[f"{name}.weight"]
        h = q(F.conv2d(h, q(w), padding=w.shape[-1] // 2))
        s = stats[f"{name}.bn"]
        return F.relu(F.batch_norm(h, s["mean"], s["var"],
                                   leaves[f"{name}.bn.weight"],
                                   leaves[f"{name}.bn.bias"], training,
                                   bn_momentum, bn_eps))

    def bn_add_relu(name, h, skip):
        w = leaves[f"{name}.weight"]
        h = q(F.conv2d(h, q(w), padding=w.shape[-1] // 2))
        s = stats[f"{name}.bn"]
        return F.relu(F.batch_norm(h, s["mean"], s["var"],
                                   leaves[f"{name}.bn.weight"],
                                   leaves[f"{name}.bn.bias"], training,
                                   bn_momentum, bn_eps) + skip)

    def dense(name, h):
        return q(F.linear(h, q(leaves[f"{name}.weight"]),
                          q(leaves[f"{name}.bias"])))

    h = q(conv_bn_relu("stem", x))
    i = 0
    while f"blocks.{i}.conv1.weight" in leaves:
        y = q(conv_bn_relu(f"blocks.{i}.conv1", h))
        h = q(bn_add_relu(f"blocks.{i}.conv2", y, h))
        i += 1
    p = q(conv_bn_relu("policy_conv", h)).flatten(1)
    logits = dense("policy_fc", p)
    v = q(conv_bn_relu("value_conv", h)).flatten(1)
    v = F.relu(dense("value_fc1", v))
    value = torch.tanh(dense("value_fc2", v))[:, 0]
    return logits, value


def loss(leaves: dict, stats: dict, x: torch.Tensor, target: torch.Tensor,
         z: torch.Tensor, l2: float = 1e-4, **kw) -> torch.Tensor:
    """The joint loss of a batch: mean (z - v)^2 + mean NLL of the moves
    played + ``l2`` * sum of ||w||^2; a forward in training mode."""
    logits, value = forward(leaves, stats, x, **kw)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, target.long().view(-1, 1)).mean()
    reg = sum((leaves[n] ** 2).sum() for n in l2_names(leaves))
    return ((z - value) ** 2).mean() + nll + l2 * reg


def sgd_steps(leaves: dict, stats: dict, batches, rate: float,
              momentum: float = 0.9, l2: float = 1e-4, **kw):
    """Momentum SGD from ``leaves`` and ``stats`` over ``batches`` (each a
    dict of ``x`` NCHW float32 planes, ``target`` and ``z`` on the leaves'
    device). Returns (losses, the first step's gradients by leaf, the
    leaves after each step, the running statistics after the last); the
    arguments are left as they were."""
    _strict_float32()
    params = {n: t.detach().clone() for n, t in leaves.items()}
    stats = {n: {k: t.clone() for k, t in s.items()}
             for n, s in stats.items()}
    velocity = {n: torch.zeros_like(t) for n, t in params.items()}
    losses, first_grads, after = [], None, []
    for batch in batches:
        for t in params.values():
            t.requires_grad_(True)
        value = loss(params, stats, batch["x"], batch["target"], batch["z"],
                     l2, **kw)
        grads = torch.autograd.grad(value, list(params.values()))
        if first_grads is None:
            first_grads = [g.detach().clone() for g in grads]
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                velocity[n] = momentum * velocity[n] + g
                params[n] = (p - rate * velocity[n]).detach()
        losses.append(float(value.detach()))
        after.append({n: t.clone() for n, t in params.items()})
    return losses, first_grads, after, stats
