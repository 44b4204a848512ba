"""The arena API in one module: the port's twin of ``deepgo_tpu/arena.py``.

Re-exports the player zoo (``agents.py``), the match harness and its CLI
(``match.py``) and the serving-engine surface, the same names as the JAX
package's shim, from the port; ``python -m deepgo_tpu_torch.arena`` runs
the match CLI.
"""

from .agents import (  # noqa: F401
    Agent, HeuristicAgent, OnePlyAgent, PolicyAgent, PolicySearchAgent,
    RandomAgent, SearchAgent, TwoPlyAgent, Value2PlyAgent,
    ValueSearchAgent, W_KILL, W_LADDER, W_LIB,
    W_OPP_LIB, W_SAVE, W_SELF_ATARI, _apply_and_summarize,
    _argmax_random_tiebreak, _make_agent, _no_own_eyes, _oneply_scores,
    _play_candidates, _policy_engine_for, _tactical_grids, _topk_mask,
    _veto_select,
)
from .match import main, play_match  # noqa: F401
from .selfplay import GameState  # noqa: F401
# serving-engine surface, so arena-level tools can opt their agents into
# the shared micro-batching evaluator (and its resilience supervisor)
# without a second import path
from .serving import (  # noqa: F401
    EngineConfig, InferenceEngine, SupervisedEngine, SupervisorConfig,
    close_shared_engines, shared_policy_engine, shared_value_engine,
)

if __name__ == "__main__":
    main()
