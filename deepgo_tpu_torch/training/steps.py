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
``train.optimizer``), so a profile
attributes the card's kernels to the parts; a label costs a few
microseconds on the host when no profiler runs.

Batches are dicts of tensors on the model's device:
  packed  (B, 9, 19, 19) uint8, or (B, 1625) uint8 under wire="nibble"
  player  (B,) int32      rank (B,) int32      target (B,) int32
  sym     (B,) int32 with augment=True         mask (B,) float32 (eval only)
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from ..models import policy_cnn
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


def _data_group(mesh):
    """The group a step averages its gradients over; None for no mesh or
    a 1 x 1 mesh without a process group."""
    return None if mesh is None else mesh.group("data")


def average_gradients(grads, loss, group):
    """Every gradient and the loss averaged over ``group`` by one
    all-reduce of one flat float32 buffer; returns (grads, loss), the
    grads as views of the buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
    dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
    parts = flat.split([g.numel() for g in grads] + [1])
    return ([p.view(g.shape) for p, g in zip(parts, grads)],
            parts[-1].view(()))


def _one_step(model, opt_state, batch, cfg, optimizer, augment, anchor,
              wire, group):
    with record_function("train.unwire"):
        packed = _unwire(batch["packed"], wire)
    target = batch["target"]
    if augment:
        with record_function("train.augment"):
            packed, target = augment_batch(packed, target, batch["sym"])
    with record_function("train.expand"):
        planes = _planes(batch, packed, cfg)
    params = list(model.parameters())
    with torch.enable_grad():
        with record_function("train.forward"):
            logits = model(planes)
        with record_function("train.loss"):
            loss = nll_from_logits(logits, target)
            if anchor is not None:
                # KL-anchored fine-tune: add weight * CE(anchor_probs,
                # model), whose gradients are KL(anchor || model)'s. The
                # reported loss includes the anchor term.
                a_model, weight = anchor
                with torch.no_grad():
                    a_prob = F.softmax(a_model(planes).float(), dim=-1)
                logp = F.log_softmax(logits.float(), dim=-1)
                loss = loss + weight * (-(a_prob * logp).sum(dim=-1).mean())
        with record_function("train.backward"):
            grads = list(torch.autograd.grad(loss, params))
    loss = loss.detach()
    if group is not None:
        with record_function("train.allreduce"):
            grads, loss = average_gradients(grads, loss, group)
    with record_function("train.optimizer"):
        opt_state = optimizer.update(model, grads, opt_state)
    return opt_state, loss


def _check_cfg(model, cfg) -> None:
    if model.cfg != cfg:
        raise ValueError(f"model config {model.cfg} != step config {cfg}")


def _anchor(anchor):
    """``(anchor_model, anchor_cfg, weight)`` -> (model, weight); the
    anchor model is frozen."""
    if anchor is None:
        return None
    a_model, a_cfg, weight = anchor
    _check_cfg(a_model, a_cfg)
    a_model.requires_grad_(False)
    return a_model, float(weight)


def make_train_step(cfg: policy_cnn.ModelConfig, optimizer: Optimizer,
                    expand_backend: str = "xla", augment: bool = False,
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
    over "data" (the returned loss is the global batch's). ``expand_backend``
    is accepted so configs carry over: the tensors' device picks the
    expansion (the CUDA kernel on the card, the plain version on the
    CPU)."""
    del expand_backend
    anchor = _anchor(anchor)
    group = _data_group(mesh)

    def step(model, opt_state, batch):
        _check_cfg(model, cfg)
        opt_state, loss = _one_step(model, opt_state, batch, cfg, optimizer,
                                    augment, anchor, wire, group)
        return model, opt_state, loss

    return _with_collective_site(step, collective_site)


def make_train_step_many(cfg: policy_cnn.ModelConfig, optimizer: Optimizer,
                         expand_backend: str = "xla", augment: bool = False,
                         anchor=None, wire: str = "packed",
                         collective_site: str | None = None, mesh=None):
    """Returns step(model, opt_state, batches) -> (model, opt_state,
    losses).

    ``batches`` is a superbatch: the batch dict of ``make_train_step``
    with a leading steps dimension (K, B, ...) on every entry. One call
    runs K chained steps, equal to K single steps, and returns the K
    losses as one (K,) float32 tensor on the device; no value goes back to
    the host between the steps. ``mesh`` as for ``make_train_step``."""
    del expand_backend
    anchor = _anchor(anchor)
    group = _data_group(mesh)

    def step(model, opt_state, batches):
        _check_cfg(model, cfg)
        k = batches["target"].shape[0]
        losses = []
        for i in range(k):
            opt_state, loss = _one_step(
                model, opt_state, {n: v[i] for n, v in batches.items()},
                cfg, optimizer, augment, anchor, wire, group)
            losses.append(loss)
        return model, opt_state, torch.stack(losses)

    return _with_collective_site(step, collective_site)


def make_eval_step(cfg: policy_cnn.ModelConfig, expand_backend: str = "xla",
                   wire: str = "packed"):
    """Returns eval(model, batch) -> (sum_nll, num_correct) over the batch,
    0-d float32 tensors on the device. An optional float "mask" entry
    (1 = real example) lets partial batches be padded to a fixed shape."""
    del expand_backend

    @torch.no_grad()
    def step(model, batch):
        planes = _planes(batch, _unwire(batch["packed"], wire), cfg)
        target = batch["target"].long()
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(target.shape, dtype=torch.float32,
                              device=target.device)
        logits = model(planes)
        logp = F.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(1, target[:, None])[:, 0]
        correct = ((logits.argmax(dim=-1) == target) * mask).sum()
        return -(picked * mask).sum(), correct

    return step
