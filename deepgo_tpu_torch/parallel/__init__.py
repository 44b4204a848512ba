"""Meshes, shardings, distributed helpers, and elastic resilience over
``torch.distributed``: the port of ``deepgo_tpu/parallel``.

``elastic`` (the recovery orchestrator) is imported lazily by its callers
rather than re-exported here: it pulls in the experiment layer, which
itself imports this package.
"""

from .mesh import (  # noqa: F401
    data_sharding,
    make_mesh,
    replicated_sharding,
    superbatch_sharding,
)
from .liveness import (  # noqa: F401
    ConfigError,
    CoordinatorUnreachable,
    DistributedError,
    HeartbeatLedger,
    HeartbeatWriter,
    HostLost,
    StragglerDetected,
)
from .deadlines import (  # noqa: F401
    deadline,
    guard_first_call,
    initialize_with_deadline,
)
from .zero import shard_opt_state, sharded_fraction, zero_sharding  # noqa: F401
