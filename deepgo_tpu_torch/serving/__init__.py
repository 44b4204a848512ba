"""Inference serving: bucket ladder + micro-batch engine.

The port of ``deepgo_tpu/serving``'s engine core:

  * buckets.py — the shape ladder: any request count pads onto a fixed set
    of batch sizes.
  * engine.py — micro-batching queue: callers submit single boards and get
    futures; a dispatcher coalesces, pads, runs one forward, scatters rows
    back.

``policy_engine`` wires the engine to the policy forward.
"""

from __future__ import annotations

from ..models.serving import make_log_prob_fn
from .buckets import (DEFAULT_BUCKETS, BucketLadder,  # noqa: F401
                      bucketed_forward)
from .engine import (BatchDispatchError, EngineBusy,  # noqa: F401
                     EngineClosed, EngineConfig, EngineError,
                     InferenceEngine)


def policy_engine(params, cfg, config: EngineConfig | None = None,
                  device="cuda", name: str = "policy") -> InferenceEngine:
    """Engine over the policy forward on ``device``: rows are (361,)
    float32 log-probs. ``params`` is a ``PolicyCNN`` of ``cfg`` on that
    device. Raises without CUDA unless ``device="cpu"``."""
    return InferenceEngine(make_log_prob_fn(cfg, device=device), params,
                           config=config, name=name)
