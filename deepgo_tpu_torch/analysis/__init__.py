"""Machine-checked invariants: the linter, and sanitizers at run time.

The port's counterpart of ``deepgo_tpu/analysis``:

  * :mod:`lockcheck` — the opt-in (``DEEPGO_LOCKCHECK=1``) runtime
    lock-order sanitizer: instrumented locks record the per-thread
    acquisition graph across the dispatcher/supervisor/fleet/replay/obs
    threads and report order-inversion cycles and long-hold hazards
    through the flight recorder (a copy of the JAX module).
  * :mod:`cudacheck` — the opt-in (``DEEPGO_XLACHECK=1``) runtime
    performance-contract sanitizer, the counterpart of ``xlacheck``: the
    signature sentinel (zero post-warm-up new forward signatures), the
    implicit-transfer guard over ``torch.cuda.set_sync_debug_mode``, and
    the sharding-claim checker over ``parallel/reshard.check_placement``.
  * :mod:`linter` / :mod:`grammar` — the AST invariant linter behind
    ``cli lint``, with the port's policy in :mod:`config`: per-rule
    checkers with file:line findings, a reasoned inline-pragma allowlist,
    and JSON for CI. They load on demand from the CLI and tests.

Only :mod:`lockcheck` and :mod:`cudacheck` are imported eagerly: they sit
on production construction paths and stay import-light.
"""

from . import cudacheck  # noqa: F401
from .lockcheck import enabled as lockcheck_enabled  # noqa: F401
from .lockcheck import make_lock, make_rlock  # noqa: F401
