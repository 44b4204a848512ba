"""The always-on expert-iteration service (the port of ``deepgo_tpu/loop``).

Selfplay actors → replay buffer → continuous learner → arena gatekeeper,
every component supervised, every artifact crash-safe, the whole cycle
running forever under chaos:

  * ``actors``     — selfplay over the serving fleet's selfplay tier,
    finished games durably ingested;
  * ``replay``     — bounded on-disk replay buffer with window-versioned
    index segments; a frozen extent is an immutable dataset, which is
    what keeps the step-indexed stream bit-exact while the corpus grows;
  * ``learner``    — windowed training with a checkpointed read cursor
    and atomic per-window challenger publishes; ``--auto-resume`` after
    any kill replays the interrupted window bit-identically;
  * ``gatekeeper`` — challengers reach serving only by beating the
    incumbent at >= 55% under the pinned arena protocol
    (``match.standard_gate``); a pass atomically publishes the champion
    and hot-reloads the fleet in place (``FleetRouter.reload``);
  * ``service``    — the supervisor wiring it together with bounded
    component restarts, stall detection, ``loop_*`` events and
    ``deepgo_loop_*`` metrics.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA it raises.
"""

from .replay import (ReplayBuffer, ReplayError, ReplayView,  # noqa: F401
                     count_durable_games)
from .learner import (ContinuousLearner, LoopError,  # noqa: F401
                      LoopStalled, params_digest, read_windows,
                      replay_window)
from .actors import SelfplayActor, game_records  # noqa: F401
from .gatekeeper import (ArenaGatekeeper, GateRejected,  # noqa: F401
                         publish_checkpoint)
from .service import ExpertIterationLoop, LoopConfig  # noqa: F401
