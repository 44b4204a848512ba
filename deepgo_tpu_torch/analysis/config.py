"""Lint policy of the port: which rules bind where.

The port's copy of ``deepgo_tpu/analysis/config.py`` with its roots and
scopes pointed at ``deepgo_tpu_torch/``. The scopes below are a checked-in
policy, not a per-run flag:

  * **strict roots** (the port and its ``chip_smoke.py``) fail ``cli lint``
    (exit 1) on any finding. There are no warn roots: ``tools/`` belongs
    to the JAX package;
  * the **determinism** and **assert** scopes name the module families
    whose guarantees depend on those rules: step-indexed / replay /
    serving-dispatch code for determinism, the service layers for asserts.
    Numeric kernels (``go/``, ``ops/``, ``models/``, transcription) keep
    their inline shape asserts.

The JAX package's XLA contract rules (``jit-boundary``, ``donation``,
``constant-upload``) have no meaning in eager PyTorch and are not rules
here; ``hot-sync`` is, with torch's synchronizing calls.
"""

from __future__ import annotations

import dataclasses
import re

# pragma grammar: `# lint: allow[RULE] reason` — on the offending line
# or alone on the line above. The reason is mandatory; an allow without
# one is itself a finding (the allowlist stays narrow and auditable).
PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\[([a-z-]+)\]\s*(.*?)\s*$")

RULES = ("atomic-write", "determinism", "thread-discipline",
         "typed-error", "grammar-drift", "pragma", "bare-sleep",
         "hot-sync")

# np.random entry points that create explicitly-seeded, owned streams —
# everything else on np.random is hidden global state
NP_RANDOM_OK = frozenset({
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "Philox",
})


@dataclasses.dataclass(frozen=True)
class LintConfig:
    # path classes (repo-root-relative, posix)
    strict_roots: tuple = ("deepgo_tpu_torch", "chip_smoke.py")
    warn_roots: tuple = ()
    skip_parts: tuple = ("__pycache__",)

    # atomic-write: raw write-mode open()/np.save-to-path is only legal
    # inside the atomic writer itself
    atomic_exempt: tuple = ("deepgo_tpu_torch/utils/atomicio.py",)

    # determinism: modules whose behavior must be a pure function of
    # (seed, step) — the bit-exact-resume and replay surfaces
    determinism_scope: tuple = (
        "deepgo_tpu_torch/data/loader.py",
        "deepgo_tpu_torch/data/dataset.py",
        "deepgo_tpu_torch/experiments/checkpoint.py",
        "deepgo_tpu_torch/loop/",
        "deepgo_tpu_torch/serving/",
    )

    # bare-sleep: serving code never calls time.sleep directly (an
    # invisible stall with no span and no fault site); delays go through
    # an injected sleep= hook, a waitable event, or utils/faults.maybe_slow
    sleep_scope: tuple = (
        "deepgo_tpu_torch/serving/",
        "deepgo_tpu_torch/sessions/",
    )

    # typed-error: service layers raise typed errors that survive
    # `python -O`; asserts there are findings
    assert_scope: tuple = (
        "deepgo_tpu_torch/serving/",
        "deepgo_tpu_torch/sessions/",
        "deepgo_tpu_torch/loop/",
        "deepgo_tpu_torch/obs/",
        "deepgo_tpu_torch/parallel/",
        "deepgo_tpu_torch/utils/",
        "deepgo_tpu_torch/experiments/",
        "deepgo_tpu_torch/analysis/",
        "deepgo_tpu_torch/data/loader.py",
    )

    # hot-sync: (file, top-level function) scopes where a host<->device
    # sync (.item() / .tolist() / .cpu() / .numpy() / synchronize() /
    # float(<call>)) stalls a dispatcher thread, a train-step loop, or a
    # per-request path. Syncs there are legal only at the DECLARED
    # materialization points, pragma'd with a reason. Explicit-path mode
    # treats every function as hot (fixture testing).
    hot_sync_scope: tuple = (
        ("deepgo_tpu_torch/serving/engine.py", "_dispatch"),
        ("deepgo_tpu_torch/serving/engine.py", "_dispatch_loop"),
        ("deepgo_tpu_torch/serving/engine.py", "_collect"),
        ("deepgo_tpu_torch/serving/fleet.py", "_dispatch"),
        ("deepgo_tpu_torch/serving/fleet.py", "_router_loop"),
        ("deepgo_tpu_torch/loop/learner.py", "train_window"),
        ("deepgo_tpu_torch/experiments/experiment.py", "_train"),
    )

    # grammar drift: the repo's docs that hold the authoritative metric/
    # event/fault-site tables. The port emits the JAX package's names, so
    # it is held to the same docs (read only here).
    grammar_docs: tuple = ("docs/observability.md", "docs/robustness.md",
                           "docs/loop.md")
    # event/metric prefixes the drift checker enforces bidirectionally;
    # the first entry MUST stay "deepgo_" (the metric namespace — the
    # rest are JSONL event-kind namespaces)
    grammar_prefixes: tuple = ("deepgo_", "obs_", "loop_", "fleet_",
                               "trace_", "lineage_", "cost_", "ts_",
                               "anomaly_", "workload_", "cache_",
                               "reshard_", "session_", "search_")
    # doc tokens that share a grammar prefix but are not metrics/events:
    # bench JSON keys and similar
    grammar_ignore: frozenset = frozenset({
        "obs_registry", "loop_games_per_hour", "trace_id",
        # the bench --mode search headline metric key (a BENCH json
        # field, not a JSONL event kind), and search_id (a record field
        # inside search_request, same shape as trace_id)
        "search_simulations_per_sec", "search_id",
        # flight-dump section / JSON keys that share the trace_ prefix
        # but are not JSONL event kinds
        "trace_exemplars",
        # position-cache marks on the trace_request timeline — event
        # names INSIDE an exemplar's `events` list, not JSONL kinds
        "cache_hit", "cache_miss", "cache_coalesced", "cache_promoted",
    })
    # files whose emissions feed the grammar check
    grammar_code_roots: tuple = ("deepgo_tpu_torch",)

    # explicit-path mode (`cli lint FILE...` and the fixture tests):
    # scope gates open up — every rule applies to every named file
    all_scopes: bool = False

    def in_scope(self, rel: str, scope: tuple) -> bool:
        if self.all_scopes:
            return True
        return any(rel == p or rel.startswith(p) for p in scope)
