"""Int8 quantized inference + the fused dihedral symmetry ensemble, in PyTorch.

The port of ``deepgo_tpu/models/quant.py``. Two ideas, composable:

  * **per-output-channel symmetric int8 weights with power-of-two scales**
    (``quantize_params``): each conv weight ``w[c_out, c_in, k, k]`` is
    kept as int8 ``w_q`` with one float32 scale per output channel,
    ``w ~ w_q * w_scale[c_out]``. ``QuantPolicyCNN`` runs the convolution
    over ``w_q`` cast to the compute dtype (integers <= 127 are exact in
    bf16) and multiplies the scale in the epilogue, before the bias add and
    ReLU. A power-of-two scale is an exponent shift, exact through the
    accumulation and the bf16 rounding, so the int8 forward equals the
    forward over the dequantized weights bit for bit: quantization error
    is the only numerics change.
  * **the fused dihedral ensemble** (``make_fused_sym_policy_fn``): the S
    views stacked on the batch axis in one forward: gather + expansion
    (one CUDA kernel on the card, ``ops/csrc/expand.cu``), conv stack over
    S*B boards, float32 log-softmax, inverse gather, and the mixture
    average ``log((1/S) sum_k p_k)`` as a log-sum-exp. ``quant=True`` runs
    the stack over int8 weights: the ``int8+sym`` serving variant.

The **tolerance harness** (``tolerance_report`` / ``check_tolerance``) is
the gate a lossy variant must pass before it serves: per bucket-ladder
rung, top-1 agreement and max-abs log-prob drift against the exact
reference forward of the same program shape, published as
``deepgo_quant_*`` gauges in the port's registry; below the floors
``check_tolerance`` raises :class:`VariantToleranceError`.

Where the two packages differ: the JAX package computes the scale as
``exp2(ceil(log2(amax / 127)))``, and on XLA:CPU neither function is exact
everywhere: ``exp2`` misses at -13 and at -15 and below (a few ulps off the
power of two), and ``log2`` at 2**-13 and 2**-15 (just above the integer,
so ``ceil`` picks the next power of two). A channel with
``amax <= 127 * 2**-13`` can get a JAX scale that is not the power of two
the formula asks for. The port computes the exponent exactly
(``torch.frexp``) and builds the power of two from its bits;
``tests/test_torch_variants.py`` pins where the two differ.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .. import BOARD_SIZE, NUM_POINTS, resolve_device
from ..ops import expand_planes_sym
from ..ops.augment import _TARGET_MAP_NP, NUM_SYMMETRIES, table
from . import policy_cnn
from .serving import _log_probs_net, check_model, serve, serve_laps

# symmetric int8: the full signed range minus the asymmetric -128, so the
# codebook is symmetric around zero and dequant is one multiply
QUANT_MAX = 127.0


class VariantToleranceError(RuntimeError):
    """A lossy serving variant fell below its tolerance floors vs the exact
    reference forward; the variant must refuse to serve. Carries the
    offending ``report`` (the full per-rung measurement)."""

    def __init__(self, message: str, report: dict):
        super().__init__(message)
        self.report = report


class QuantConv(nn.Module):
    """``PositionBiasConv`` over int8 weights: buffers ``w_q`` (c_out, c_in,
    k, k) int8, ``w_scale`` (c_out,) float32 powers of two, ``bias`` (c_out,
    19, 19) float32."""

    def __init__(self, k: int, c_in: int, c_out: int):
        super().__init__()
        self.register_buffer(
            "w_q", torch.zeros((c_out, c_in, k, k), dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(c_out))
        self.register_buffer("bias",
                             torch.zeros(c_out, BOARD_SIZE, BOARD_SIZE))

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        y = F.conv2d(x, self.w_q.to(x.dtype), padding=self.w_q.shape[-1] // 2)
        # the dequant epilogue: an exact power-of-two shift per output
        # channel. The conv has already rounded to x.dtype (the JAX conv
        # returns float32 and scales before its downcast); scaling by a
        # power of two commutes with that rounding, barring subnormals.
        y = y * self.w_scale.to(x.dtype)[None, :, None, None]
        y = y + self.bias.to(x.dtype)[None]
        return F.relu(y) if relu else y


class QuantPolicyCNN(policy_cnn.PolicyCNN):
    """The policy network over int8 weights (``quantize_params``); the same
    forward as ``PolicyCNN``: NHWC planes in, float32 logits (B, 361) out."""

    layer_type = QuantConv


def _po2_scale(amax: torch.Tensor) -> torch.Tensor:
    """``2 ** ceil(log2(amax / QUANT_MAX))`` for float32 ``amax > 0``,
    exactly: ``frexp`` gives ``x = m * 2**e`` with m in [0.5, 1), so
    ``ceil(log2 x)`` is ``e - 1`` when m is 0.5 and ``e`` otherwise; the
    power of two is built from its float32 bits (a subnormal below
    2**-126), with no ``log2`` or ``exp2`` rounding anywhere."""
    mantissa, exponent = torch.frexp(amax / QUANT_MAX)
    e = exponent - (mantissa == 0.5).to(exponent.dtype)
    normal = (e + 127).clamp(min=1) << 23
    subnormal = torch.bitwise_left_shift(torch.ones_like(e),
                                         (e + 149).clamp(min=0, max=22))
    return torch.where(e >= -126, normal, subnormal).view(torch.float32)


@torch.no_grad()
def quantize_params(model: policy_cnn.PolicyCNN) -> QuantPolicyCNN:
    """A float32 ``PolicyCNN`` -> its int8 ``QuantPolicyCNN`` on the same
    device. Per output channel, ``w_scale = 2**ceil(log2(max|w| / 127))``
    over the channel's taps (1.0 for an all-zero channel) and ``w_q =
    round(w / w_scale)`` (half to even, as ``jnp.round``), clipped to
    +-127. Biases stay float32. Weights already on this grid round-trip
    bit for bit."""
    device = model.layers[0].weight.device
    qmodel = QuantPolicyCNN(model.cfg).to(device)
    for layer, qlayer in zip(model.layers, qmodel.layers):
        w = layer.weight.float()
        amax = w.abs().amax(dim=(1, 2, 3))
        scale = torch.where(amax > 0, _po2_scale(amax), torch.ones_like(amax))
        w_q = torch.clamp(torch.round(w / scale[:, None, None, None]),
                          -QUANT_MAX, QUANT_MAX)
        qlayer.w_q.copy_(w_q.to(torch.int8))
        qlayer.w_scale.copy_(scale)
        qlayer.bias.copy_(layer.bias)
    return qmodel


@torch.no_grad()
def dequantize_params(qmodel: QuantPolicyCNN) -> policy_cnn.PolicyCNN:
    """The float32 ``PolicyCNN`` the int8 one rounds to (tests; bounds)."""
    device = qmodel.layers[0].w_q.device
    model = policy_cnn.PolicyCNN(qmodel.cfg).to(device)
    for qlayer, layer in zip(qmodel.layers, model.layers):
        layer.weight.copy_(qlayer.w_q.float()
                           * qlayer.w_scale[:, None, None, None])
        layer.bias.copy_(qlayer.bias)
    return model


def _check_kind(params, quant: bool) -> None:
    if isinstance(params, QuantPolicyCNN) != quant:
        want = "QuantPolicyCNN" if quant else "float PolicyCNN"
        raise TypeError(f"this forward takes a {want}, got "
                        f"{type(params).__name__}")


def make_quant_log_prob_fn(cfg: policy_cnn.ModelConfig, device="cuda"):
    """predict(qparams, packed, player, rank) -> (B, 361) float32 log-probs:
    the int8 twin of ``serving.make_log_prob_fn``, with the same
    engine-facing signature (``qparams`` is a ``QuantPolicyCNN``)."""
    device = resolve_device(device)
    laps = serve_laps()
    net = _log_probs_net(cfg, device)

    @torch.inference_mode()
    def log_probs(qparams, packed, player, rank) -> np.ndarray:
        _check_kind(qparams, True)
        check_model(qparams, cfg)
        return serve(laps, device, net, qparams, packed, player, rank)

    log_probs.device = device
    return log_probs


def make_fused_sym_policy_fn(cfg: policy_cnn.ModelConfig,
                             quant: bool = False,
                             symmetries: int | None = None, device="cuda"):
    """predict(params, packed, player, rank) -> (B, 361) float32 log-probs
    averaged over the first ``symmetries`` (default 8) dihedral views, in
    one forward.

    The views are stacked on the batch axis symmetry-major (one gather +
    expansion kernel on the card), pushed through one conv-stack call,
    log-softmaxed in float32, mapped back with the inverse tables, and
    averaged as a mixture via log-sum-exp: ``log((1/S) sum_k p_k)`` in log
    space. ``quant=True`` runs the stack over int8 weights (``params`` is
    then a ``QuantPolicyCNN``). ``symmetries=1`` is the identity view
    alone: its output equals the plain forward bit for bit."""
    s = NUM_SYMMETRIES if symmetries is None else int(symmetries)
    if not 1 <= s <= NUM_SYMMETRIES:
        raise ValueError(f"symmetries must be in [1, {NUM_SYMMETRIES}], "
                         f"got {symmetries!r}")
    device = resolve_device(device)
    laps = serve_laps()
    tmap = table(_TARGET_MAP_NP[:s], device)  # (S, 361) inverse tables
    log_s = math.log(s)

    def net(params, staged: list) -> torch.Tensor:
        planes = expand_planes_sym(*staged.pop(), symmetries=s,
                                   dtype=cfg.torch_dtype)
        b = planes.shape[0] // s
        logp = policy_cnn.log_policy(params, planes).reshape(s, b,
                                                             NUM_POINTS)
        # view k's distribution mapped back: orig point p sits at
        # tmap[k, p]; then the mixture average in log space
        back = torch.gather(logp, 2, tmap[:, None, :].expand_as(logp))
        return torch.logsumexp(back, dim=0) - log_s

    @torch.inference_mode()
    def predict(params, packed, player, rank) -> np.ndarray:
        check_model(params, cfg)
        _check_kind(params, quant)
        return serve(laps, device, net, params, packed, player, rank)

    predict.device = device
    return predict


# ---------------------------------------------------------------------------
# the tolerance harness


@dataclasses.dataclass(frozen=True)
class ToleranceConfig:
    """The floors a lossy variant must clear on EVERY rung before it may
    serve: top-1 agreement vs the exact reference forward, and max-abs
    log-prob drift over the points the reference puts at least
    ``prob_floor`` on. ``boards`` bounds the harness's cost; every rung
    measures at least that many boards."""

    top1_floor: float = 0.99
    drift_cap: float = 0.5
    prob_floor: float = 1e-3
    boards: int = 256
    seed: int = 0


def _random_boards(rng: np.random.Generator, n: int):
    return (rng.integers(0, 3, size=(n, 9, 19, 19), dtype=np.uint8),
            rng.integers(1, 3, size=n).astype(np.int32),
            rng.integers(1, 10, size=n).astype(np.int32))


def tolerance_report(reference, ref_params, variant_forward, var_params,
                     buckets=(1, 8, 32, 128, 512),
                     config: ToleranceConfig | None = None,
                     variant: str = "int8", registry=None,
                     sample=None) -> dict:
    """Measure a lossy variant against its exact reference, per rung.

    ``reference`` / ``variant_forward`` are engine-facing forwards of the
    same program shape (plain int8 vs plain f32; fused-sym int8 vs
    fused-sym f32). Every rung dispatches at its own batch size and pools
    at least ``config.boards`` boards. ``sample(n) -> (packed, player,
    rank)`` supplies them; the default is uniform random stones from
    ``config.seed``, a deliberately hostile probe (pass real positions for
    production gating).

    Returns the per-rung table and a ``verdict`` ("pass"/"fail"), and sets
    the ``deepgo_quant_top1_agreement{variant,bucket}`` /
    ``deepgo_quant_logprob_drift{variant,bucket}`` gauges of ``registry``
    (default: the port's process-wide registry)."""
    cfg = config or ToleranceConfig()
    rng = np.random.default_rng(cfg.seed)
    if sample is None:
        sample = lambda n: _random_boards(rng, n)  # noqa: E731
    if registry is None:
        from ..obs import get_registry

        registry = get_registry()
    g_top1 = registry.gauge(
        "deepgo_quant_top1_agreement",
        "variant-vs-reference top-1 move agreement per ladder rung")
    g_drift = registry.gauge(
        "deepgo_quant_logprob_drift",
        "variant-vs-reference max-abs log-prob drift over "
        "above-floor probability mass, per ladder rung")
    rungs = {}
    worst_top1, worst_drift = 1.0, 0.0
    for b in sorted({int(x) for x in buckets}):
        agree = total = 0
        drift = 0.0
        while total < cfg.boards:
            n = min(b, cfg.boards - total)
            packed, player, rank = sample(n)
            if n < b:  # pad to the rung so the batch shape is the rung's
                pad = b - n
                packed = np.concatenate(
                    [packed, np.zeros((pad, 9, 19, 19), np.uint8)])
                player = np.concatenate([player, np.ones(pad, np.int32)])
                rank = np.concatenate([rank, np.ones(pad, np.int32)])
            ref = np.asarray(reference(ref_params, packed, player,
                                       rank))[:n]
            var = np.asarray(variant_forward(var_params, packed, player,
                                             rank))[:n]
            agree += int(np.sum(ref.argmax(-1) == var.argmax(-1)))
            total += n
            mass = np.exp(ref) >= cfg.prob_floor
            drift = max(drift, float(
                np.max(np.where(mass, np.abs(var - ref), 0.0))))
        top1 = agree / total
        rungs[b] = {"boards": total, "top1_agreement": round(top1, 4),
                    "max_abs_logprob_drift": round(drift, 5),
                    "ok": top1 >= cfg.top1_floor and drift <= cfg.drift_cap}
        g_top1.set(top1, variant=variant, bucket=b)
        g_drift.set(drift, variant=variant, bucket=b)
        worst_top1 = min(worst_top1, top1)
        worst_drift = max(worst_drift, drift)
    ok = all(r["ok"] for r in rungs.values())
    return {
        "variant": variant,
        "verdict": "pass" if ok else "fail",
        "top1_floor": cfg.top1_floor,
        "drift_cap": cfg.drift_cap,
        "worst_top1": round(worst_top1, 4),
        "worst_drift": round(worst_drift, 5),
        "rungs": {str(b): r for b, r in sorted(rungs.items())},
    }


def check_tolerance(reference, ref_params, variant_forward, var_params,
                    buckets=(1, 8, 32, 128, 512),
                    config: ToleranceConfig | None = None,
                    variant: str = "int8", registry=None,
                    sample=None) -> dict:
    """``tolerance_report`` that refuses: a failing report raises
    :class:`VariantToleranceError` carrying the full measurement. Returns
    the passing report otherwise."""
    report = tolerance_report(reference, ref_params, variant_forward,
                              var_params, buckets=buckets, config=config,
                              variant=variant, registry=registry,
                              sample=sample)
    if report["verdict"] != "pass":
        bad = {b: r for b, r in report["rungs"].items() if not r["ok"]}
        raise VariantToleranceError(
            f"variant {variant!r} refused to serve: tolerance floors "
            f"(top1 >= {report['top1_floor']}, drift <= "
            f"{report['drift_cap']}) failed on rung(s) {sorted(bad)} "
            f"(worst top1 {report['worst_top1']}, worst drift "
            f"{report['worst_drift']})", report)
    return report
