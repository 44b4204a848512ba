"""Inference serving: bucket ladder, micro-batch engine, serving variants.

The port of ``deepgo_tpu/serving``'s engine core:

  * buckets.py — the shape ladder: any request count pads onto a fixed set
    of batch sizes.
  * engine.py — micro-batching queue: callers submit single boards and get
    futures; a dispatcher coalesces, pads, runs one forward, scatters rows
    back.
  * variants.py — the named serving programs f32 | int8 | sym | int8+sym
    and the tolerance gate a lossy one must pass before it serves.

``policy_engine`` wires the engine to the policy forward of one variant.
"""

from __future__ import annotations

from ..models.serving import make_log_prob_fn
from .buckets import (DEFAULT_BUCKETS, BucketLadder,  # noqa: F401
                      bucketed_forward)
from .engine import (BatchDispatchError, EngineBusy,  # noqa: F401
                     EngineClosed, EngineConfig, EngineError,
                     InferenceEngine)
from .variants import (VARIANTS, ToleranceConfig,  # noqa: F401
                       VariantToleranceError, variant_spec, verify_variant)


def _resolve_variant(params, cfg, variant: str, device, verify: bool,
                     tolerance=None, sample=None):
    """(spec, prepared_params) for one serving variant, gated: a lossy
    variant must pass the tolerance harness against its exact reference
    before any engine is built over it; failure raises
    ``VariantToleranceError`` and the variant never serves."""
    from . import variants as variants_mod

    spec = variants_mod.variant_spec(cfg, variant, device)
    if verify and spec.lossy:
        variants_mod.verify_variant(cfg, params, variant,
                                    tolerance=tolerance, device=device,
                                    sample=sample)
    return spec, spec.prepare(params)


def _stamp_variant(engine, spec):
    """Mark an engine with its variant identity: ``variant`` names its
    program, ``prepare_params`` turns a base float32 model into the params
    that program takes."""
    engine.variant = spec.name
    engine.prepare_params = spec.prepare
    return engine


def policy_engine(params, cfg, config: EngineConfig | None = None,
                  device="cuda", name: str = "policy", variant: str = "f32",
                  verify: bool = True, tolerance=None,
                  sample=None) -> InferenceEngine:
    """Engine over the policy forward on ``device``: rows are (361,)
    float32 log-probs. ``params`` is a float32 ``PolicyCNN`` of ``cfg`` on
    that device. ``variant`` selects the serving program
    (serving/variants.py: f32 | int8 | sym | int8+sym); a lossy variant is
    tolerance-gated before the engine exists (``tolerance`` a
    ``ToleranceConfig``, ``sample(n)`` the measurement boards). The f32
    engine gets a forward of its own; variant forwards are memoized per
    (cfg, variant, device). Raises without CUDA unless ``device="cpu"``."""
    if variant == "f32":
        return InferenceEngine(make_log_prob_fn(cfg, device=device), params,
                               config=config, name=name)
    from . import variants as variants_mod

    spec, prepared = _resolve_variant(params, cfg, variant, device, verify,
                                      tolerance, sample)
    variants_mod._note_serving(variant, 1)
    return _stamp_variant(
        InferenceEngine(spec.forward, prepared, config=config, name=name),
        spec)
