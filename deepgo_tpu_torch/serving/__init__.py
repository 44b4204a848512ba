"""Inference serving: the engine and the resilience layers behind it.

The port of ``deepgo_tpu/serving``:

  * buckets.py — the shape ladder: any request count pads onto a fixed set
    of batch sizes.
  * engine.py — micro-batching queue: callers submit single boards and get
    futures; a dispatcher coalesces, pads, runs one forward, scatters rows
    back.
  * variants.py — the named serving programs f32 | int8 | sym | int8+sym
    and the tolerance gate a lossy one must pass before it serves.
  * resilience.py / supervisor.py — ``SupervisedEngine`` wraps an engine
    factory with dispatcher-death restart (bounded exponential backoff and
    full jitter, requests in flight replayed), batch-poison isolation
    (solo-lane bisection and an atomic quarantine dump), a closed / open /
    half-open circuit breaker, and deadline-aware admission.
  * cache.py — the content-addressed position cache in front of a fleet:
    exact or dihedral-canonical keys, coalescing of requests in flight,
    invalidation on reload.
  * fleet.py — N supervised replicas behind one ``FleetRouter``: placement
    by least estimated wait, failover with exclusion, respawn, rolling
    weight reload, priority tiers (interactive > selfplay > batch) shed
    cheapest first, hedging, outlier ejection, integrity checks, and the
    CUDA + CPU surge tier.
  * replay.py — a captured or synthetic opening-heavy trace re-served
    open-loop against an engine or fleet, with its fidelity report.

The factories below wire the engines to the models. Each builds its
forward ONCE and closes over it, so restarts, respawns and reloads reuse
it. Every factory runs on ``cuda`` unless asked for the CPU, and raises
without CUDA. ``shared_policy_engine`` / ``shared_value_engine`` memoize
per (params, config) so several callers share one saturated engine.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..models.serving import make_log_prob_fn, make_value_fn
from .buckets import (DEFAULT_BUCKETS, BucketLadder,  # noqa: F401
                      bucketed_forward)
from .engine import (BatchDispatchError, EngineBusy,  # noqa: F401
                     EngineClosed, EngineConfig, EngineError,
                     InferenceEngine)
from .resilience import (CircuitBreaker, CircuitOpen,  # noqa: F401
                         EngineOverloaded, PoisonedRequest,
                         RestartsExhausted, full_jitter_delay)
from .cache import (CacheConfig, CacheKeyingError,  # noqa: F401
                    PositionCache)
from .cache import simulate as simulate_cache  # noqa: F401
from .replay import (WorkloadReplayer, build_synthetic_requests,  # noqa: F401
                     load_trace, write_synthetic_capture)
from .supervisor import SupervisedEngine, SupervisorConfig  # noqa: F401
from .fleet import (TIERS, FailoverExhausted, FleetConfig,  # noqa: F401
                    FleetReloadError, FleetRouter, FleetUnavailable,
                    IntegrityViolation)
from .variants import (VARIANTS, ToleranceConfig,  # noqa: F401
                       VariantToleranceError, variant_spec, verify_variant)


def ladder_for(n_games: int, buckets=DEFAULT_BUCKETS) -> BucketLadder:
    """The default ladder trimmed to a known fleet size: rungs above the
    smallest one covering ``n_games`` are dead weight (warmup forwards
    nobody dispatches), so a 32-game selfplay run warms (1, 8, 32). A
    fleet larger than the top rung keeps the full ladder — oversize
    batches dispatch as top-rung chunks (BucketLadder.plan)."""
    keep = [b for b in sorted(buckets) if b < n_games]
    ceil = [b for b in sorted(buckets) if b >= n_games]
    return BucketLadder(tuple(keep + ceil[:1]))


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
    """Mark an engine (or supervised engine) with its variant identity:
    ``variant`` surfaces in fleet stats and health, ``prepare_params``
    turns a base float32 model into the params that program takes — the
    hook FleetRouter.reload / respawn apply before every swap."""
    engine.variant = spec.name
    engine.prepare_params = spec.prepare
    return engine


def policy_engine(params, cfg, config: EngineConfig | None = None,
                  device="cuda", metrics=None, name: str = "policy",
                  variant: str = "f32", verify: bool = True, tolerance=None,
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
                               config=config, name=name, metrics=metrics)
    from . import variants as variants_mod

    spec, prepared = _resolve_variant(params, cfg, variant, device, verify,
                                      tolerance, sample)
    variants_mod._note_serving(variant, 1)
    return _stamp_variant(
        InferenceEngine(spec.forward, prepared, config=config, name=name,
                        metrics=metrics), spec)


def value_engine(params, cfg, config: EngineConfig | None = None,
                 device="cuda", metrics=None,
                 name: str = "value") -> InferenceEngine:
    """Engine over the value forward: rows are scalar float32 win-probs.
    ``params`` is a ``ValueCNN`` of ``cfg`` on ``device``."""
    return InferenceEngine(make_value_fn(cfg, device=device), params,
                           config=config, name=name, metrics=metrics)


def supervised_policy_engine(params, cfg,
                             config: EngineConfig | None = None,
                             supervisor: SupervisorConfig | None = None,
                             device="cuda", metrics=None,
                             name: str = "policy", variant: str = "f32",
                             verify: bool = True, tolerance=None,
                             sample=None) -> SupervisedEngine:
    """Resilient engine over the policy forward: an InferenceEngine
    factory under a SupervisedEngine (restart, poison isolation, breaker,
    deadline shedding). The forward is built ONCE and closed over, so a
    restart reuses it. ``variant`` as in ``policy_engine``."""
    if variant == "f32":
        forward = make_log_prob_fn(cfg, device=device)
        return SupervisedEngine(
            lambda: InferenceEngine(forward, params, config=config,
                                    name=name, metrics=metrics),
            config=supervisor, name=name, metrics=metrics)
    spec, prepared = _resolve_variant(params, cfg, variant, device, verify,
                                      tolerance, sample)
    return _stamp_variant(SupervisedEngine(
        lambda: InferenceEngine(spec.forward, prepared, config=config,
                                name=name, metrics=metrics),
        config=supervisor, name=name, metrics=metrics), spec)


def supervised_value_engine(params, cfg,
                            config: EngineConfig | None = None,
                            supervisor: SupervisorConfig | None = None,
                            device="cuda", metrics=None,
                            name: str = "value") -> SupervisedEngine:
    """Resilient engine over the value forward (see
    supervised_policy_engine)."""
    forward = make_value_fn(cfg, device=device)
    return SupervisedEngine(
        lambda: InferenceEngine(forward, params, config=config, name=name,
                                metrics=metrics),
        config=supervisor, name=name, metrics=metrics)


def fleet_policy_engine(params, cfg, replicas: int = 2,
                        config: EngineConfig | None = None,
                        fleet: FleetConfig | None = None,
                        supervisor: SupervisorConfig | None = None,
                        device="cuda", metrics=None,
                        name: str = "policy-fleet",
                        variants=None, verify: bool = True,
                        tolerance=None, sample=None,
                        platforms=None, cache=None) -> FleetRouter:
    """A FleetRouter of N supervised policy replicas on ``device`` sharing
    ONE forward per variant, through restarts, respawns and ``reload``
    weight swaps.

    ``variants`` (a name or a list — serving/variants.py) assigns a
    serving variant to each replica round-robin: ``("f32", "int8+sym")``
    over 2 replicas serves one full-precision replica (the expansion
    kernel) and one int8 ensemble replica (the sym kernel) behind one
    router, hot-swappable via ``reload`` (each replica's
    ``prepare_params`` hook re-prepares the new BASE model for its own
    program). Lossy variants are tolerance-gated ONCE here, before any
    replica exists — a failing variant refuses to serve.

    ``platforms`` (a tuple of device names, round-robin like variants)
    builds a HETEROGENEOUS fleet — ``("cuda", "cpu")`` serves a card
    replica and a CPU surge replica behind one router, with batch-tier
    traffic preferring the surge platform (``FleetConfig.surge_platforms``)
    and failover across platforms. ``device`` is then unused. Every named
    platform must exist: ``"cuda"`` without CUDA raises, it never becomes
    a CPU replica. Mutually exclusive with lossy ``variants``: each
    feature owns the replica's ``prepare_params`` hook.

    ``cache`` (a CacheConfig or PositionCache) arms the router's
    content-addressed position cache (serving/cache.py)."""
    from . import variants as variants_mod

    if variants is None:
        variants = ("f32",)
    elif isinstance(variants, str):
        variants = (variants,)
    if platforms is not None and set(variants) != {"f32"}:
        raise ValueError(
            "platforms= cannot combine with non-f32 variants: platform "
            "placement and variant preparation both own the replica's "
            "prepare_params hook")
    if platforms is not None:
        return _platform_fleet(params, cfg, replicas, config, fleet,
                               supervisor, metrics, name, tuple(platforms),
                               cache)
    if set(variants) == {"f32"}:
        forward = make_log_prob_fn(cfg, device=device)

        def make_f32_replica(i: int) -> SupervisedEngine:
            return SupervisedEngine(
                lambda: InferenceEngine(forward, params, config=config,
                                        name=f"{name}-{i}",
                                        metrics=metrics),
                config=supervisor, name=f"{name}-{i}", metrics=metrics)

        return FleetRouter(make_f32_replica, replicas, config=fleet,
                           name=name, metrics=metrics, params=params,
                           cache=cache)
    specs = {}
    for v in dict.fromkeys(variants):  # verify each distinct variant once
        specs[v] = _resolve_variant(params, cfg, v, device, verify,
                                    tolerance, sample)
    assignment = [variants[i % len(variants)] for i in range(replicas)]
    for v in specs:
        variants_mod._note_serving(v, assignment.count(v))

    def make_replica(i: int) -> SupervisedEngine:
        spec, prepared = specs[assignment[i]]
        return _stamp_variant(SupervisedEngine(
            lambda: InferenceEngine(spec.forward, prepared, config=config,
                                    name=f"{name}-{i}", metrics=metrics),
            config=supervisor, name=f"{name}-{i}", metrics=metrics), spec)

    return FleetRouter(make_replica, replicas, config=fleet, name=name,
                       metrics=metrics, params=params, cache=cache)


def _platform_device(name: str) -> torch.device:
    """The device a platform name places a replica on; ``"cuda"`` means
    the current card. Raises where the platform is absent."""
    device = resolve_device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _placed(model, device: torch.device):
    """``model`` itself when it lies on ``device``, else a copy there (the
    caller's module is never moved)."""
    if next(model.parameters()).device == device:
        return model
    out = type(model)(model.cfg)
    out.load_state_dict(model.state_dict())
    return out.to(device)


def _platform_fleet(params, cfg, replicas, config, fleet, supervisor,
                    metrics, name, platforms, cache) -> FleetRouter:
    """The heterogeneous-platform fleet: platform assignment is
    round-robin (mirroring variants), each DISTINCT platform gets its own
    forward and one copy of the params on its device, and each replica's
    ``prepare_params`` hook places every new base model (reload, respawn)
    on the replica's own device. ``platform_realized`` is always true
    here: an absent platform raises instead of falling back."""
    if not platforms:
        raise ValueError("platforms must name at least one device")
    forwards, devices, placed = {}, {}, {}
    for p in dict.fromkeys(platforms):
        devices[p] = _platform_device(p)
        forwards[p] = make_log_prob_fn(cfg, device=devices[p])
        placed[p] = _placed(params, devices[p])
    assignment = [platforms[i % len(platforms)] for i in range(replicas)]

    def make_replica(i: int) -> SupervisedEngine:
        p = assignment[i]
        forward, weights = forwards[p], placed[p]
        eng = SupervisedEngine(
            lambda: InferenceEngine(forward, weights, config=config,
                                    name=f"{name}-{i}", metrics=metrics),
            config=supervisor, name=f"{name}-{i}", metrics=metrics)
        eng.platform = p
        eng.platform_realized = True
        eng.prepare_params = lambda base, d=devices[p]: _placed(base, d)
        return eng

    return FleetRouter(make_replica, replicas, config=fleet, name=name,
                       metrics=metrics, params=params, cache=cache)


def fleet_value_engine(params, cfg, replicas: int = 2,
                       config: EngineConfig | None = None,
                       fleet: FleetConfig | None = None,
                       supervisor: SupervisorConfig | None = None,
                       device="cuda", metrics=None,
                       name: str = "value-fleet") -> FleetRouter:
    """FleetRouter over the value forward (see fleet_policy_engine)."""
    forward = make_value_fn(cfg, device=device)

    def make_replica(i: int) -> SupervisedEngine:
        return SupervisedEngine(
            lambda: InferenceEngine(forward, params, config=config,
                                    name=f"{name}-{i}", metrics=metrics),
            config=supervisor, name=f"{name}-{i}", metrics=metrics)

    return FleetRouter(make_replica, replicas, config=fleet, name=name,
                       metrics=metrics)


# One engine per live (params, model config, engine config, device):
# callers serving the same model coalesce into the same dispatches.
_SHARED: dict[tuple, InferenceEngine] = {}


def _shared(kind: str, factory, params, cfg, config: EngineConfig | None,
            supervised: bool, fleet: int = 1, variant: str = "f32",
            device="cuda"):
    key = (kind, supervised, fleet, id(params), cfg, config, variant,
           str(device))
    engine = _SHARED.get(key)
    if (engine is None or engine._closing.is_set()
            or getattr(engine, "_failed", None) is not None):
        kw = {} if kind == "value" else {"variant": variant}
        # variant engines get distinct names so their metrics series
        # never merge with f32's
        suffix = "" if variant == "f32" else f"-{variant}"
        if fleet > 1:
            fleet_factory = (fleet_policy_engine if kind == "policy"
                             else fleet_value_engine)
            if kind == "policy":
                kw = {"variants": variant}
            engine = _SHARED[key] = fleet_factory(
                params, cfg, replicas=fleet, config=config, device=device,
                name=f"shared-{kind}-fleet{suffix}", **kw)
        else:
            engine = _SHARED[key] = factory(params, cfg, config=config,
                                            device=device,
                                            name=f"shared-{kind}{suffix}",
                                            **kw)
    return engine


def shared_policy_engine(params, cfg, config: EngineConfig | None = None,
                         supervised: bool = False, fleet: int = 1,
                         variant: str = "f32", device="cuda"):
    """``fleet > 1`` returns a FleetRouter of that many supervised
    replicas; otherwise the single shared engine (supervised or not).
    ``variant`` selects the serving program (serving/variants.py) —
    memoized per (model, variant), so an int8 engine and the f32 one of
    the same model coexist as distinct shared engines."""
    return _shared("policy",
                   supervised_policy_engine if supervised else policy_engine,
                   params, cfg, config, supervised, fleet, variant, device)


def shared_value_engine(params, cfg, config: EngineConfig | None = None,
                        supervised: bool = False, fleet: int = 1,
                        device="cuda"):
    return _shared("value",
                   supervised_value_engine if supervised else value_engine,
                   params, cfg, config, supervised, fleet, device=device)


def close_shared_engines() -> None:
    """Drain and drop every shared engine."""
    while _SHARED:
        _, engine = _SHARED.popitem()
        engine.close()
