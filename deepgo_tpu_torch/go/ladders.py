"""Ladder reading: the one lookahead feature.

The port's copy of ``deepgo_tpu/go/ladders.py``.

Decides, for a chain with exactly two liberties, which of those liberties the
opponent can play to capture the chain in a ladder. This is a recursive
search with play-and-undo, matching the reference's decision procedure
(reference ladder_moves, makedata.lua:393-439) exactly:

  for each liberty L (the candidate chasing move), other liberty O:
    opponent plays L (with capture resolution);
    if the chasing stone's chain now has > 2 liberties (the chase is not
    self-defeating):
      the chased player escapes at O;
      if the escaped chain has exactly 1 liberty -> ladder works (atari);
      if it has exactly 2 liberties -> recurse, provided the chasing chain
      itself retains > 1 liberty after the escape.

The chased chain is identified by a representative point (x, y) which keeps
its stone throughout the search (escape moves only extend the chain).
"""

from __future__ import annotations

import numpy as np

from .board import group_and_liberties, play_with_undo, undo_moves


def ladder_moves(
    stones: np.ndarray, x: int, y: int, liberties: set[tuple[int, int]]
) -> list[tuple[int, int]]:
    """Return the liberties of the 2-liberty chain at (x, y) from which the
    opponent can launch a capturing ladder. ``stones`` is temporarily mutated
    and restored before returning."""
    player = int(stones[x, y])
    opponent = 3 - player
    libs = sorted(liberties)
    assert len(libs) == 2, "ladder reading requires exactly two liberties"

    result: list[tuple[int, int]] = []
    for i in (0, 1):
        chase, escape = libs[i], libs[1 - i]
        undo: list = []
        play_with_undo(stones, chase[0], chase[1], opponent, undo)
        _, chaser_libs = group_and_liberties(stones, *chase)
        if len(chaser_libs) > 2:
            play_with_undo(stones, escape[0], escape[1], player, undo)
            _, escaped_libs = group_and_liberties(stones, *escape)
            if len(escaped_libs) == 1:
                result.append(chase)
            elif len(escaped_libs) == 2:
                _, chaser_libs = group_and_liberties(stones, *chase)
                if len(chaser_libs) > 1 and ladder_moves(stones, x, y, escaped_libs):
                    result.append(chase)
        undo_moves(stones, undo)
    return result
