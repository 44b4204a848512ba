"""Train and eval steps.

The port of ``deepgo_tpu/training/steps.py``. One training step is: decode
the wire encoding, apply the dihedral augmentation, expand the packed
records into planes (the hand-written CUDA kernel on the card, the plain
version on the CPU), forward, NLL in float32, backward, optimizer update.
Each step does exactly one forward and one backward.

The JAX step donates its params and optimizer state; here the step updates
the model's parameters in place and returns ``(model, opt_state, loss)``
with the new state. Losses stay on the device: nothing in a step reads a
value back to the host, so a run of steps queues on the card without a
host round trip between them.

Data parallelism: given a ``mesh`` (``parallel/mesh.py``), each data rank
steps on its rows of the global batch, and between the backward and the
optimizer update the step averages every gradient and the loss over the
mesh's "data" group: one all-reduce of one flat float32 buffer a step
(``make_train_step_many``: one per inner step). DDP does not fit here: its
reducer hooks fire under ``.backward()``, and the step takes its gradients
with ``torch.autograd.grad``. Tensor parallelism lives in the network
(``parallel/tensor.py``), ZeRO in the optimizer (``parallel/zero.py``).

Each part of a step runs under a ``torch.profiler.record_function`` label
(``train.unwire``, ``train.augment``, ``train.expand``, ``train.forward``,
``train.loss``, ``train.backward``, ``train.allreduce``,
``train.optimizer``), so a profile attributes the card's kernels to the
parts; a label costs a few microseconds on the host when no profiler
runs. The parts sit inside one ``train.step`` range (``obs.hot_range``,
opened only while a capture runs), which marks each step's bounds in a
capture.

Both network families run one step body. What differs between them is
chosen once, when the step is made (``_family``): AlphaGo Zero's dual-head
network (``models/resnet.ResNetConfig``) trains on the paper's joint loss,
mean (z - v)^2, plus the mean NLL, plus ``resnet.L2_WEIGHT`` times the
squared norm of every convolution and dense weight, under the same labels,
the model in train mode so that BN uses and updates batch statistics; the
L2 term's gradient is added to the backward's by ``add_l2`` after the
reduce. Its batches carry the outcome ``z`` (``AsyncLoader(outcome=True)``).

Batches are dicts of tensors on the model's device:
  packed  (B, 9, 19, 19) uint8, or (B, 1625) uint8 under wire="nibble"
  player  (B,) int32      rank (B,) int32      target (B,) int32
  sym     (B,) int32 with augment=True         mask (B,) float32 (eval only)
  z       (B,) float32 for a ``ResNetConfig``: +1 the side to move won,
          -1 lost, 0 undecided
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from ..models import policy_cnn, resnet
from ..obs.spans import hot_range
from ..ops import expand_planes
from ..ops.augment import augment_batch
from ..ops.wire import nibble_unpack
from ..utils import faults
from .optimizers import Optimizer


def _with_collective_site(step, site: str | None):
    """Host-side fault point checked before every call (elastic runs name
    ``dist_collective``); ``site=None`` returns the step untouched."""
    if site is None:
        return step

    def checked(*args):
        faults.check(site)
        return step(*args)

    return checked


def nll_from_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Mean negative log-likelihood over 361 classes, in float32.

    ``F.nll_loss`` on the log-softmax rather than a gather: its backward
    writes one element per row and has a deterministic CUDA kernel, where
    the gather's backward (a scatter-add) does not."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return F.nll_loss(logp, targets.long())


def _unwire(packed: torch.Tensor, wire: str) -> torch.Tensor:
    """Decode the transfer encoding of the batch's "packed" entry:
    "packed" = raw (B, 9, 19, 19) records, "nibble" = (B, 1625)."""
    if wire == "nibble":
        return nibble_unpack(packed)
    if wire != "packed":
        raise ValueError(f"unknown wire format {wire!r}")
    return packed


def _planes(batch: dict, packed: torch.Tensor, cfg) -> torch.Tensor:
    return expand_planes(packed.contiguous(), batch["player"].contiguous(),
                         batch["rank"].contiguous(), dtype=cfg.torch_dtype)


def average_gradients(grads, loss, group):
    """Every gradient and the loss averaged over ``group`` by one
    all-reduce of one flat float32 buffer; returns (grads, loss), the
    grads as views of the buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
    dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
    parts = flat.split([g.numel() for g in grads] + [1])
    return ([p.view(g.shape) for p, g in zip(parts, grads)],
            parts[-1].view(()))


def joint_loss(logits: torch.Tensor, value: torch.Tensor,
               targets: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The data terms of AlphaGo Zero's loss, in float32: mean (z - v)^2
    + mean NLL."""
    return F.mse_loss(value, z) + nll_from_logits(logits, targets)


@torch.no_grad()
def add_l2(grads: list, params: list, weights: list, loss: torch.Tensor
           ) -> torch.Tensor:
    """The loss's L2 term, ``resnet.L2_WEIGHT`` * sum of ||w||^2 over
    ``weights``: its gradient 2 c w added in place to those weights' entries
    of ``grads`` (in ``params`` order) in one multi-tensor pass, and its
    value to ``loss``, which is returned. Autograd would take some 500
    launches a step of a 40-block network for the same sums."""
    at = {id(p): i for i, p in enumerate(params)}
    torch._foreach_add_([grads[at[id(w)]] for w in weights], weights,
                        alpha=2.0 * resnet.L2_WEIGHT)
    norms = torch.stack(torch._foreach_norm(weights))
    return loss + resnet.L2_WEIGHT * norms.square().sum()




def _check_cfg(model, cfg) -> None:
    if model.cfg != cfg:
        raise ValueError(f"model config {model.cfg} != step config {cfg}")


class _Family(NamedTuple):
    """The parts of a step that differ by network family (``_family``)."""

    train_mode: bool  # put the model in train mode before the forward (BN)
    loss: Callable  # (forward's outputs, target, batch, planes) -> loss
    # (model, grads, params, loss) -> loss, after the reduce; or None
    after_reduce: Callable | None
    logits: Callable  # (model, planes) -> policy logits, for the eval step


def _eval_mode_logits(model, planes):
    was = model.training
    model.eval()
    try:
        return model(planes)[0]
    finally:
        model.train(was)


def _family(cfg, anchor) -> _Family:
    """A config's family, chosen once when a step is made. A policy network
    steps on ``nll_from_logits`` plus the optional KL-anchor term. A
    ``ResNetConfig``'s ``DualResNet``, which takes no anchor, steps on
    ``joint_loss`` in train mode, adds ``add_l2``'s term after the reduce,
    and is judged on its policy logits in eval mode (BN on its running
    statistics, its mode restored after). The parts look the public loss
    functions up in this module when they run."""
    if isinstance(cfg, resnet.ResNetConfig):
        if anchor is not None:
            raise ValueError("the KL anchor is a policy network's fine-tune; "
                             f"{type(cfg).__name__} takes none")
        return _Family(
            True, lambda out, target, batch, planes: joint_loss(
                *out, target, batch["z"]),
            lambda model, grads, params, loss: add_l2(
                grads, params, model.l2_weights(), loss),
            _eval_mode_logits)
    if anchor is not None:  # (anchor_model, anchor_cfg, weight), frozen
        a_model, a_cfg, weight = anchor
        _check_cfg(a_model, a_cfg)
        a_model.requires_grad_(False)
        anchor = a_model, float(weight)

    def policy_loss(logits, target, batch, planes):
        loss = nll_from_logits(logits, target)
        if anchor is not None:
            # KL-anchored fine-tune: add weight * CE(anchor_probs, model),
            # whose gradients are KL(anchor || model)'s. The reported loss
            # includes the anchor term.
            a_model, weight = anchor
            with torch.no_grad():
                a_prob = F.softmax(a_model(planes).float(), dim=-1)
            logp = F.log_softmax(logits.float(), dim=-1)
            loss = loss + weight * (-(a_prob * logp).sum(dim=-1).mean())
        return loss

    return _Family(False, policy_loss, None,
                   lambda model, planes: model(planes))


def _one_step(cfg, optimizer, augment, anchor, wire, mesh):
    """one_step(model, opt_state, batch) -> (opt_state, loss): the step
    both factories run, its family's parts and data group chosen here."""
    train_mode, family_loss, after_reduce, _ = _family(cfg, anchor)
    # None for no mesh or a 1 x 1 mesh without a process group
    group = None if mesh is None else mesh.group("data")

    def one_step(model, opt_state, batch):
        with hot_range("train.step"):
            with record_function("train.unwire"):
                packed = _unwire(batch["packed"], wire)
            target = batch["target"]
            if augment:
                with record_function("train.augment"):
                    packed, target = augment_batch(packed, target,
                                                   batch["sym"])
            with record_function("train.expand"):
                planes = _planes(batch, packed, cfg)
            if train_mode and not model.training:
                model.train()
            params = list(model.parameters())
            with torch.enable_grad():
                with record_function("train.forward"):
                    outputs = model(planes)
                with record_function("train.loss"):
                    loss = family_loss(outputs, target, batch, planes)
                with record_function("train.backward"):
                    grads = list(torch.autograd.grad(loss, params))
            loss = loss.detach()
            if group is not None:
                with record_function("train.allreduce"):
                    grads, loss = average_gradients(grads, loss, group)
            if after_reduce is not None:
                with record_function("train.loss"):
                    loss = after_reduce(model, grads, params, loss)
            with record_function("train.optimizer"):
                opt_state = optimizer.update(model, grads, opt_state)
            return opt_state, loss

    return one_step


def make_train_step(cfg: policy_cnn.ModelConfig | resnet.ResNetConfig,
                    optimizer: Optimizer, augment: bool = False,
                    anchor=None, wire: str = "packed",
                    collective_site: str | None = None, mesh=None):
    """Returns step(model, opt_state, batch) -> (model, opt_state, loss).

    The step updates ``model``'s parameters in place (the JAX step donates
    them) and returns the same model, the new optimizer state and the
    loss, a 0-d float32 tensor on the model's device.

    With ``augment=True`` the batch carries a per-sample "sym" entry, and
    the packed records and targets are transformed on the device before
    the expansion. ``anchor=(anchor_model, anchor_cfg, weight)`` adds the
    KL-to-anchor term (the anchor is frozen). ``collective_site`` names a
    fault point checked on the host before each call. With ``mesh`` the
    batch is this data rank's rows and the gradients and loss are averaged
    over "data" (the returned loss is the global batch's). The tensors'
    device picks the expansion (the CUDA kernel on the card, the plain
    version on the CPU). A ``ResNetConfig`` steps on the joint loss
    (module docstring) and raises for an ``anchor``."""
    one_step = _one_step(cfg, optimizer, augment, anchor, wire, mesh)

    def step(model, opt_state, batch):
        _check_cfg(model, cfg)
        opt_state, loss = one_step(model, opt_state, batch)
        return model, opt_state, loss

    return _with_collective_site(step, collective_site)


def make_train_step_many(cfg: policy_cnn.ModelConfig | resnet.ResNetConfig,
                         optimizer: Optimizer, augment: bool = False,
                         anchor=None, wire: str = "packed",
                         collective_site: str | None = None, mesh=None):
    """Returns step(model, opt_state, batches) -> (model, opt_state,
    losses).

    ``batches`` is a superbatch: the batch dict of ``make_train_step``
    with a leading steps dimension (K, B, ...) on every entry. One call
    runs K chained steps, equal to K single steps, and returns the K
    losses as one (K,) float32 tensor on the device; no value goes back to
    the host between the steps. The other arguments are
    ``make_train_step``'s."""
    one_step = _one_step(cfg, optimizer, augment, anchor, wire, mesh)

    def step(model, opt_state, batches):
        _check_cfg(model, cfg)
        losses = []
        for i in range(batches["target"].shape[0]):
            opt_state, loss = one_step(model, opt_state,
                                       {n: v[i] for n, v in batches.items()})
            losses.append(loss)
        return model, opt_state, torch.stack(losses)

    return _with_collective_site(step, collective_site)


def make_eval_step(cfg: policy_cnn.ModelConfig | resnet.ResNetConfig,
                   wire: str = "packed"):
    """Returns eval(model, batch) -> (sum_nll, num_correct) over the batch,
    0-d float32 tensors on the device. An optional float "mask" entry
    (1 = real example) lets partial batches be padded to a fixed shape.
    A ``ResNetConfig``'s network is judged on its policy logits in eval
    mode."""
    forward = _family(cfg, None).logits

    @torch.no_grad()
    def step(model, batch):
        planes = _planes(batch, _unwire(batch["packed"], wire), cfg)
        target = batch["target"].long()
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(target.shape, dtype=torch.float32,
                              device=target.device)
        logits = forward(model, planes)
        logp = F.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(1, target[:, None])[:, 0]
        correct = ((logits.argmax(dim=-1) == target) * mask).sum()
        return -(picked * mask).sum(), correct

    return step
