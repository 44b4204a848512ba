"""Named serving variants: f32 | int8 | sym | int8+sym.

The port of ``deepgo_tpu/serving/variants.py``. A *variant* is a (forward,
params preparation) pair sharing the engine-facing signature
``forward(params, packed, player, rank) -> (B, 361)``, so the bucket ladder
and the engine run it unchanged:

  f32        the reference ``make_log_prob_fn`` forward (identity prep)
  int8       per-output-channel symmetric int8 weights with power-of-two
             scales, dequant in the conv epilogue (models/quant.py); prep
             quantizes the float32 ``PolicyCNN``
  sym        the fused 8-fold dihedral ensemble over float32 weights
             (``make_fused_sym_policy_fn``): all eight views stacked on the
             batch axis, gathered and expanded by one CUDA kernel on the card
  int8+sym   the ensemble over int8 weights: both savings compose

Lossy variants are gated: :func:`verify_variant` runs the tolerance harness
(``models/quant.check_tolerance``: per-rung top-1 agreement and max-abs
log-prob drift against the exact reference of the same program shape) and a
failure raises the typed ``VariantToleranceError``: the variant refuses to
serve. The JAX package's ``expand_backend`` choice has no counterpart here:
the device decides which expansion runs.
"""

from __future__ import annotations

import dataclasses

from ..models.quant import (ToleranceConfig,  # noqa: F401
                            VariantToleranceError, check_tolerance,
                            make_fused_sym_policy_fn, make_quant_log_prob_fn,
                            quantize_params)
from ..models.serving import make_log_prob_fn
from .buckets import DEFAULT_BUCKETS

VARIANTS = ("f32", "int8", "sym", "int8+sym")

# gauge: which variants this process is serving, how many replicas each
_g_serving = None


def _note_serving(variant: str, replicas: int) -> None:
    global _g_serving
    if _g_serving is None:
        from ..obs import get_registry

        _g_serving = get_registry().gauge(
            "deepgo_quant_variants_serving",
            "replicas currently built per serving variant")
    _g_serving.set(replicas, variant=variant)


def variant_fn_name(variant: str) -> str:
    """The entrypoint name of one variant's forward, as the JAX package's
    cost ledger names it."""
    return {"f32": "policy_forward", "int8": "quant_forward",
            "sym": "fused_sym_forward",
            "int8+sym": "fused_sym_int8_forward"}[variant]


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One variant, resolved for a model config and device: the forward
    (one per process per (cfg, variant, device), shared by every engine of
    the variant), the base->serving params preparation, and the reference
    pair the tolerance harness compares against (None for exact variants:
    nothing to gate)."""

    name: str
    forward: object
    prepare: object                  # base float32 model -> serving params
    reference: object | None         # exact forward of the SAME shape
    reference_prepare: object | None

    @property
    def lossy(self) -> bool:
        return self.reference is not None


_SPECS: dict[tuple, VariantSpec] = {}


def variant_spec(cfg, variant: str, device="cuda") -> VariantSpec:
    """Resolve (and memoize) one variant for a model config on ``device``;
    raises without CUDA unless ``device="cpu"``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; valid: {VARIANTS}")
    key = (cfg, variant, str(device))
    spec = _SPECS.get(key)
    if spec is not None:
        return spec

    ident = lambda p: p  # noqa: E731
    if variant == "f32":
        spec = VariantSpec(variant, make_log_prob_fn(cfg, device), ident,
                           None, None)
    elif variant == "int8":
        spec = VariantSpec(variant, make_quant_log_prob_fn(cfg, device),
                           quantize_params, make_log_prob_fn(cfg, device),
                           ident)
    elif variant == "sym":
        spec = VariantSpec(variant,
                           make_fused_sym_policy_fn(cfg, device=device),
                           ident, None, None)
    else:  # int8+sym
        spec = VariantSpec(variant,
                           make_fused_sym_policy_fn(cfg, quant=True,
                                                    device=device),
                           quantize_params,
                           make_fused_sym_policy_fn(cfg, device=device),
                           ident)
    _SPECS[key] = spec
    return spec


def verify_variant(cfg, params, variant: str, buckets=DEFAULT_BUCKETS,
                   tolerance=None, device="cuda", sample=None) -> dict:
    """The serve gate for one variant over one float32 model: exact
    variants pass trivially (``{"verdict": "pass", "exact": True}``); lossy
    ones run the tolerance harness against their exact reference and raise
    ``VariantToleranceError`` below the floors. ``sample(n)`` supplies the
    measurement boards (see ``models/quant.tolerance_report``)."""
    spec = variant_spec(cfg, variant, device)
    if not spec.lossy:
        return {"variant": variant, "verdict": "pass", "exact": True}
    return check_tolerance(
        spec.reference, spec.reference_prepare(params),
        spec.forward, spec.prepare(params),
        buckets=buckets, config=tolerance, variant=variant, sample=sample)
