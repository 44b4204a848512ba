"""Batched policy and value inference (the serving path), in PyTorch.

The port of ``deepgo_tpu/models/serving.py``: forwards from packed records
to move log-probabilities and ranked moves, loadable straight from a
checkpoint, the unfused dihedral ensemble ``make_sym_policy_fn``, and the
value net's win-probability forward ``make_value_fn`` / ``load_value``.
Numpy in, numpy out, like the JAX forwards, so the serving engine
(``deepgo_tpu_torch.serving``) drives them unchanged.

One forward is: host arrays -> device -> expansion (the CUDA kernel on the
card, the plain version on the CPU) -> conv stack in ``cfg.compute_dtype``
-> float32 log-softmax -> host. The copy back to the host
(``cudacheck.stage_d2h``) is the forward's one synchronisation point. Each
forward carries its ``device``; inputs already staged there as tensors
pass straight through (the engine stages them under ``DEEPGO_XLACHECK=1``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import NUM_POINTS, resolve_device
from ..analysis.cudacheck import place, stage_d2h
from ..experiments import checkpoint as ckpt
from ..ops import expand_planes, expand_planes_sym
from ..ops.augment import _TARGET_MAP_NP, NUM_SYMMETRIES, table
from . import convert, policy_cnn, value_cnn


def _on(device: torch.device, value, dtype) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.ascontiguousarray(value, dtype=dtype)).to(
        device)


def inputs_on(device: torch.device, packed, player, rank
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host arrays (packed (B, 9, 19, 19) uint8, player / rank (B,) int32),
    or tensors staged on ``device`` already, -> tensors on ``device``."""
    return (_on(device, packed, np.uint8), _on(device, player, np.int32),
            _on(device, rank, np.int32))


def check_model(params, cfg) -> None:
    if params.cfg != cfg:
        raise ValueError(f"model config {params.cfg} != forward config "
                         f"{cfg}")


# On the card cuDNN picks its convolution algorithm by the batch size, and
# below some size it picks another that rounds a bf16 row differently: on
# an NVIDIA H100 (torch 2.11, CUDA 12.8) at 4-32 rows for ``small`` and
# 1-16 for ``full``, by up to 1e-3 and 6e-3 in a log-probability. From 64
# rows up a row's result depends on that row alone, as XLA's does on every
# rung. So a card forward runs its convolutions over at least this many
# rows (zero planes below the real ones): a board gets the same answer on
# every rung of the ladder, which a position cache and the chaos
# campaigns' answer check hold it to.
CARD_MIN_ROWS = 64


def conv_rows(batch: int, device) -> int:
    """The rows a serving forward of ``batch`` boards convolves on
    ``device``."""
    if torch.device(device).type == "cuda":
        return max(batch, CARD_MIN_ROWS)
    return batch


def log_policy_rows(params: policy_cnn.PolicyCNN, planes: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """``policy_cnn.log_policy`` of ``planes``, the convolutions run over
    ``rows`` >= ``len(planes)`` rows (zero planes below the real ones)."""
    b = planes.shape[0]
    if rows <= b:
        return policy_cnn.log_policy(params, planes)
    pad = planes.new_zeros((rows - b, *planes.shape[1:]))
    return policy_cnn.log_policy(params, torch.cat([planes, pad]))[:b]


def _forward_log_probs(cfg, device):
    def log_probs(params: policy_cnn.PolicyCNN, packed, player, rank
                  ) -> torch.Tensor:
        check_model(params, cfg)
        planes = expand_planes(*inputs_on(device, packed, player, rank),
                               dtype=cfg.torch_dtype)
        return log_policy_rows(params, planes,
                               conv_rows(planes.shape[0], device))

    return log_probs


def make_log_prob_fn(cfg: policy_cnn.ModelConfig, device="cuda"):
    """predict(params, packed, player, rank) -> (B, 361) float32 log-probs.

    ``params`` is a ``PolicyCNN`` of ``cfg`` on ``device``; ``packed`` is
    (B, 9, 19, 19) uint8 and ``player`` / ``rank`` (B,) int32 numpy arrays.
    This is the raw row-independent forward the serving engine batches:
    it must never grow a cross-batch term."""
    device = resolve_device(device)
    forward = _forward_log_probs(cfg, device)

    @torch.inference_mode()
    def log_probs(params, packed, player, rank) -> np.ndarray:
        return stage_d2h(forward(params, packed, player, rank))

    log_probs.device = device
    return log_probs


def make_policy_fn(cfg: policy_cnn.ModelConfig, top_k: int = 5,
                   device="cuda"):
    """predict(params, packed, player, rank) ->
    {"log_probs": (B, 361), "top_moves": (B, k), "top_probs": (B, k)}.

    Moves are flat 0-based indices (19*x + y), matching the training
    target; ``top_probs`` are descending."""
    device = resolve_device(device)
    forward = _forward_log_probs(cfg, device)

    @torch.inference_mode()
    def predict(params, packed, player, rank) -> dict:
        logp = forward(params, packed, player, rank)
        top_probs, top_moves = torch.topk(logp.exp(), top_k, dim=-1)
        return {"log_probs": stage_d2h(logp),
                "top_moves": stage_d2h(top_moves.to(torch.int32)),
                "top_probs": stage_d2h(top_probs)}

    predict.device = device
    return predict


def make_sym_policy_fn(cfg: policy_cnn.ModelConfig, device="cuda"):
    """predict(params, packed, player, rank) -> (B, 361) log-probs averaged
    over the 8 dihedral board symmetries.

    Each view is transformed with the permutation table, pushed through one
    8B-board forward, softmaxed, mapped back to original coordinates with
    the inverse table, and the PROBABILITIES are averaged (a proper
    mixture). The averaged predictor is exactly equivariant by
    construction. The serving path runs the fused form instead
    (``models/quant.make_fused_sym_policy_fn``), which averages in log
    space; this is the reference it is tested against."""
    device = resolve_device(device)
    tmap = table(_TARGET_MAP_NP, device)  # (8, 361) inverse tables

    @torch.inference_mode()
    def predict(params, packed, player, rank) -> np.ndarray:
        check_model(params, cfg)
        packed, player, rank = inputs_on(device, packed, player, rank)
        b = packed.shape[0]
        planes = expand_planes_sym(packed, player, rank,
                                   symmetries=NUM_SYMMETRIES,
                                   dtype=cfg.torch_dtype)
        probs = F.softmax(params(planes).float(), dim=-1)
        probs = probs.reshape(NUM_SYMMETRIES, b, NUM_POINTS)
        # map view k's distribution back: orig point p sits at tmap[k, p]
        back = torch.gather(probs, 2, tmap[:, None, :].expand_as(probs))
        return stage_d2h(torch.log(back.mean(dim=0) + 1e-30))

    predict.device = device
    return predict


def make_value_fn(cfg: value_cnn.ValueConfig, device="cuda"):
    """win_prob(params, packed, player, rank) -> (B,) float32 P(side to
    move wins), the value-net twin of ``make_log_prob_fn``: the expansion
    (the CUDA kernel on the card, the plain version on the CPU), the
    ``ValueCNN`` of ``cfg`` on ``device``, a float32 sigmoid. Row-
    independent, so the serving engine batches it unchanged."""
    device = resolve_device(device)

    @torch.inference_mode()
    def win_prob(params: value_cnn.ValueCNN, packed, player, rank
                 ) -> np.ndarray:
        check_model(params, cfg)
        planes = expand_planes(*inputs_on(device, packed, player, rank),
                               dtype=cfg.torch_dtype)
        return stage_d2h(torch.sigmoid(params(planes)))

    win_prob.device = device
    return win_prob


def load_value(checkpoint_path: str, device="cuda"):
    """(win_prob_fn, model, value_cfg) from a value checkpoint
    (``kind="value"``, as the JAX package's ``tools/train_value.py`` writes
    it), with the model on ``device``. Raises ``CheckpointError`` for a
    corrupt file, another kind of checkpoint, or weights that do not fit
    the config."""
    device = resolve_device(device)
    meta, p_leaves, _ = ckpt.load_checkpoint(checkpoint_path)
    if meta.get("kind") != "value":
        raise ckpt.CheckpointError(
            checkpoint_path, f"not a value checkpoint: kind "
                             f"{meta.get('kind')!r}")
    try:
        cfg = value_cnn.ValueConfig(**meta["config"])
    except (KeyError, TypeError, ValueError) as e:
        raise ckpt.CheckpointError(
            checkpoint_path, f"config does not build a value net: {e}"
        ) from e
    model = value_cnn.ValueCNN(cfg)
    model.load_state_dict(convert.value_from_jax(ckpt.unflatten_like(
        convert.value_to_jax(model), p_leaves, checkpoint_path)))
    return make_value_fn(cfg, device=device), model.to(device), cfg


def load_policy(checkpoint_path: str, top_k: int = 5, device="cuda"):
    """(predict_fn, model, model_cfg) from a training checkpoint written by
    the JAX package, with the model on ``device``. Raises
    ``CheckpointError`` for a corrupt file or one whose weights do not fit
    its config."""
    device = resolve_device(device)
    meta, p_leaves, _ = ckpt.load_checkpoint(checkpoint_path)
    cfg = ckpt.model_config_from_meta(meta, checkpoint_path)
    model = policy_cnn.PolicyCNN(cfg)
    model.load_state_dict(ckpt.policy_state_dict(p_leaves, cfg,
                                                 checkpoint_path))
    return make_policy_fn(cfg, top_k=top_k, device=device), \
        place(model, device), cfg
