"""The plain reference of the policy network, in float32 PyTorch.

Written from the network's description (Maddison et al. 2014,
arXiv:1412.6564, as the repository's Torch7 reference encodes it), not from
the program: it imports nothing of ``deepgo_tpu_torch``, ``deepgo_tpu`` or
``jax``, and takes from a run only the inputs and the weights that the
benchmark made.

- ``unpack_nibbles``: the 1,625-byte wire form back to a (9, 19, 19) record
  (even cell in the low nibble, one pad cell at the end).
- ``planes``: a packed record, the player to move and their rank to the 37
  binary input planes, NCHW.
- ``log_probs``: SAME convolutions (5 x 5, then 3 x 3), each with a bias per
  channel and board point and a ReLU but for the last; log-softmax over the
  361 points.
- ``sgd_steps``: mean negative log-likelihood, gradients by autograd,
  ``p -= rate * g``.

``precision="fp8"`` is the control: every tensor that the program holds in
bfloat16 (weights, biases, each layer's output) is rounded to float8 e4m3
instead, and each gradient on its way back to e5m2. It is the
step below bfloat16 that a later change could be tempted to take, and the
comparison must call it wrong.

On the card every call turns TF32 off first, so that float32 is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BOARD = 19
POINTS = BOARD * BOARD
RECORD_CELLS = 9 * POINTS


def _strict_float32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def unpack_nibbles(wire: torch.Tensor) -> torch.Tensor:
    """(B, 1625) uint8 -> (B, 9, 19, 19) uint8."""
    lo = wire & 0x0F
    hi = wire >> 4
    cells = torch.stack([lo, hi], dim=-1).reshape(wire.shape[0], -1)
    return cells[:, :RECORD_CELLS].reshape(-1, 9, BOARD, BOARD)


def planes(packed: torch.Tensor, player: torch.Tensor, rank: torch.Tensor
           ) -> torch.Tensor:
    """(B, 9, 19, 19) uint8, (B,) player 1/2, (B,) rank -> (B, 37, 19, 19)
    float32 planes seen from the player to move."""
    p = packed.long()
    me = player.long().view(-1, 1, 1)
    black = me == 1
    stones, libs, age = p[:, 0], p[:, 1], p[:, 6]
    lib_after = torch.where(black, p[:, 2], p[:, 3])
    kills = torch.where(black, p[:, 4], p[:, 5])
    ladder = torch.where(black, p[:, 7], p[:, 8])
    empty = stones == 0
    out = [empty, stones == me, stones == 3 - me]
    out += [libs == 1, libs == 2, libs == 3, libs >= 4]
    out += [empty & (lib_after == 0)]
    out += [lib_after == v for v in range(1, 6)] + [lib_after >= 6]
    out += [kills == v for v in range(1, 7)] + [kills >= 7]
    out += [age == v for v in range(1, 6)]
    out += [ladder >= 1, torch.zeros_like(empty)]
    r = rank.long().view(-1, 1, 1)
    out += [(r == v).expand_as(empty) for v in range(1, 10)]
    return torch.stack(out, dim=1).float()


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an fp8 type under one scale for the whole tensor (its
    largest magnitude maps to the type's largest finite value, ``top``), as
    fp8 training and inference scale each tensor."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """Rounds to float8 e4m3 on the way forward and the gradient to e5m2 on
    the way back: the usual split of fp8 training (e5m2's range for
    gradients, e4m3's precision for weights and activations)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, 57344.0)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def logits(weights, x: torch.Tensor, precision: str = "float32"
           ) -> torch.Tensor:
    """``weights``: [(w (c_out, c_in, k, k), b (c_out, 19, 19))] float32;
    ``x``: (B, 37, 19, 19) -> (B, 361) float32."""
    q = _fp8 if precision == "fp8" else (lambda t: t)
    last = len(weights) - 1
    for i, (w, b) in enumerate(weights):
        x = F.conv2d(x, q(w), padding=w.shape[-1] // 2) + q(b)[None]
        if i < last:
            x = F.relu(x)
        x = q(x)
    return x.reshape(x.shape[0], POINTS)


def log_probs(weights, packed, player, rank, precision: str = "float32",
              block: int = 1024) -> torch.Tensor:
    """Log-probabilities over the 361 points, computed in blocks of
    ``block`` boards on the weights' device."""
    _strict_float32()
    device = weights[0][0].device
    out = []
    with torch.no_grad():
        for i in range(0, packed.shape[0], block):
            x = planes(packed[i:i + block].to(device),
                       player[i:i + block].to(device),
                       rank[i:i + block].to(device))
            out.append(F.log_softmax(logits(weights, x, precision), dim=-1))
    return torch.cat(out)


def nll(weights, batch: dict, precision: str = "float32") -> torch.Tensor:
    """Mean negative log-likelihood of a batch of raw records
    (``packed``, ``player``, ``rank``, ``target``)."""
    x = planes(batch["packed"], batch["player"], batch["rank"])
    logp = F.log_softmax(logits(weights, x, precision), dim=-1)
    return -logp.gather(1, batch["target"].long().view(-1, 1)).mean()


def sgd_steps(weights, batches, rate: float, precision: str = "float32"):
    """Plain SGD from ``weights`` over ``batches`` (each on the weights'
    device). Returns (losses, grads of the first step, weights after each
    step): the first gradient and the weights as lists of (w, b) float32."""
    _strict_float32()
    params = [(w.detach().clone(), b.detach().clone()) for w, b in weights]
    losses, first_grads, after = [], None, []
    for batch in batches:
        leaves = [t.requires_grad_(True) for wb in params for t in wb]
        loss = nll(params, batch, precision)
        grads = torch.autograd.grad(loss, leaves)
        if first_grads is None:
            first_grads = [g.detach().clone() for g in grads]
        with torch.no_grad():
            new = [(t - rate * g).detach() for t, g in zip(leaves, grads)]
        params = list(zip(new[0::2], new[1::2]))
        losses.append(float(loss.detach()))
        after.append([(w.clone(), b.clone()) for w, b in params])
    return losses, first_grads, after
