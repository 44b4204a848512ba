"""Go rules engine: board replay, liberties, captures, ladders, features."""

from .board import (  # noqa: F401
    BLACK,
    EMPTY,
    SIZE,
    WHITE,
    IllegalMoveError,
    find_groups,
    group_and_liberties,
    neighbors,
    new_board,
    play,
    simulate_play,
)
from .ladders import ladder_moves  # noqa: F401
from .summarize import ladders_and_liberties, summarize  # noqa: F401
from .replay import replay_positions  # noqa: F401
