"""Game replay: SGF game -> per-move training positions.

The port's copy of ``deepgo_tpu/go/replay.py``.

Equivalent of the reference's all_boards iterator (makedata.lua:156-186):
handicap stones are placed first (through the same aging placement path),
then for every move the *pre-move* board is summarized and yielded together
with the move that was actually played (the training target).
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from ..sgf import Game, Move
from .board import new_board, play
from .summarize import summarize


def replay_positions(game: Game) -> Iterator[tuple[np.ndarray, Move]]:
    """Yield (packed_planes, move) for each move of the game.

    ``packed_planes`` is the (9, 19, 19) uint8 record of the board *before*
    the move. Passes never reach here (the SGF parser drops them), so the
    board — including the age channel — evolves only on real moves, matching
    the reference.
    """
    stones, age = new_board()
    for h in game.handicaps:
        play(stones, age, h.x, h.y, h.player)
    for move in game.moves:
        yield summarize(stones, age), move
        play(stones, age, move.x, move.y, move.player)
