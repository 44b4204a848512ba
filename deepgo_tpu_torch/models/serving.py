"""Batched policy inference (the serving path), in PyTorch.

The port of ``deepgo_tpu/models/serving.py``: forwards from packed records
to move log-probabilities and ranked moves, loadable straight from a
checkpoint, and the unfused dihedral ensemble ``make_sym_policy_fn``.
Numpy in, numpy out, like the JAX forwards, so the serving engine
(``deepgo_tpu_torch.serving``) drives them unchanged.

One forward is: host arrays -> device -> expansion (the CUDA kernel on the
card, the plain version on the CPU) -> conv stack in ``cfg.compute_dtype``
-> float32 log-softmax -> host. ``.cpu()`` at the end is the forward's one
synchronisation point.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import NUM_POINTS, resolve_device
from ..experiments import checkpoint as ckpt
from ..ops import expand_planes, expand_planes_sym
from ..ops.augment import _TARGET_MAP_NP, NUM_SYMMETRIES, table
from . import policy_cnn


def inputs_on(device: torch.device, packed, player, rank
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host arrays (packed (B, 9, 19, 19) uint8, player / rank (B,) int32)
    -> contiguous tensors on ``device``."""
    return (torch.from_numpy(
                np.ascontiguousarray(packed, dtype=np.uint8)).to(device),
            torch.from_numpy(
                np.ascontiguousarray(player, dtype=np.int32)).to(device),
            torch.from_numpy(
                np.ascontiguousarray(rank, dtype=np.int32)).to(device))


def check_model(params, cfg) -> None:
    if params.cfg != cfg:
        raise ValueError(f"model config {params.cfg} != forward config "
                         f"{cfg}")


def _forward_log_probs(cfg, device):
    def log_probs(params: policy_cnn.PolicyCNN, packed, player, rank
                  ) -> torch.Tensor:
        check_model(params, cfg)
        planes = expand_planes(*inputs_on(device, packed, player, rank),
                               dtype=cfg.torch_dtype)
        return policy_cnn.log_policy(params, planes)

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
        return forward(params, packed, player, rank).cpu().numpy()

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
        return {"log_probs": logp.cpu().numpy(),
                "top_moves": top_moves.to(torch.int32).cpu().numpy(),
                "top_probs": top_probs.cpu().numpy()}

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
        return torch.log(back.mean(dim=0) + 1e-30).cpu().numpy()

    return predict


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
        model.to(device), cfg
