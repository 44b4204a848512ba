"""Deep search as a service: batched PUCT MCTS over the serving fleet.

The tree search the source paper points at (arXiv:1412.6564
§Conclusion: the policy net as a search prior), built as a serving
workload — wave-batched leaf futures through the fleet router, a
transposition table keyed on the content-addressed canonical digests,
anytime deadline QoS on the priority tiers. The port's copy of
``deepgo_tpu/search``.
"""

from .mcts import (NUM_EDGES, PASS_EDGE, LeafEvaluator, Node,  # noqa: F401
                   Search, SearchConfig, SearchResult,
                   TranspositionTable, game_from_packed,
                   make_move_selector)
