"""Per-position feature summary: everything the model sees about a board.

The port's copy of ``deepgo_tpu/go/summarize.py``.

Produces the packed 9-channel record for one position (the write-side schema
of reference dataloader.lua:20-39 / summarize_board makedata.lua:143-153):

  channel 0   stones            0 empty, 1 black, 2 white
  channel 1   liberties         chain liberty count at each stone
  channels 2-3 liberties-after  per player: liberties of the chain formed by
                                playing at each empty point (0 on stones,
                                0 for suicide)
  channels 4-5 kills            per player: opposing stones captured by
                                playing at each empty point
  channel 6   age               moves the point has been in its current state
  channels 7-8 ladders          per player: points from which that player can
                                launch a working ladder capture, valued with
                                the size of the chased chain

Unlike the reference — which re-flood-fills the whole board for each of the
up-to-722 hypothetical plays (makedata.lua:122-141) — this computes chain
labels and liberty sets once and answers the no-capture (common) case with
set unions, simulating only when a capture is involved.
"""

from __future__ import annotations

import numpy as np

from .board import EMPTY, SIZE, _NEIGHBORS, find_groups, simulate_play
from .ladders import ladder_moves


def _clip255(n: int) -> int:
    # Packed channels are uint8; real games never reach the cap (the
    # reference's ByteTensor would wrap instead, which never triggers either).
    return min(n, 255)


def ladders_and_liberties(stones: np.ndarray, labels=None, groups=None):
    """(ladders, liberties): ladders is (2, 19, 19) per chasing player with
    chased-chain size at working ladder points; liberties is (19, 19) chain
    liberty counts (reference all_ladder_moves_and_liberties,
    makedata.lua:441-479)."""
    if groups is None:
        labels, groups = find_groups(stones)
    ladders = np.zeros((2, SIZE, SIZE), dtype=np.uint8)
    liberties = np.zeros((SIZE, SIZE), dtype=np.uint8)
    for group in groups:
        n_libs = _clip255(len(group["liberties"]))
        for p in group["points"]:
            liberties[p] = n_libs
        if len(group["liberties"]) == 2:
            x, y = next(iter(group["points"]))
            chaser = 3 - group["player"]
            for move in ladder_moves(stones, x, y, group["liberties"]):
                ladders[chaser - 1][move] = _clip255(len(group["points"]))
    return ladders, liberties


def kills_and_liberties_after(stones: np.ndarray, labels, groups):
    """(kills, liberties_after), each (2, 19, 19) uint8 indexed by player-1,
    defined at empty points only (reference all_kills_and_liberties_after,
    makedata.lua:122-141)."""
    kills = np.zeros((2, SIZE, SIZE), dtype=np.uint8)
    liberties_after = np.zeros((2, SIZE, SIZE), dtype=np.uint8)
    for x in range(SIZE):
        for y in range(SIZE):
            if stones[x, y] != EMPTY:
                continue
            for player in (1, 2):
                opponent = 3 - player
                captures = False
                own_groups = set()
                lib_union = {(x, y)}
                for n in _NEIGHBORS[x][y]:
                    v = stones[n]
                    if v == EMPTY:
                        lib_union.add(n)
                    else:
                        g = labels[n]
                        if v == opponent:
                            if len(groups[g]["liberties"]) == 1:
                                captures = True
                        else:
                            own_groups.add(g)
                if captures:
                    # A capture frees points whose adjacency to the new chain
                    # needs real resolution: simulate.
                    k, la = simulate_play(stones, x, y, player)
                else:
                    # No capture: the new chain's liberties are the union of
                    # the merged own chains' liberties and the empty
                    # neighbors, minus the played point itself.
                    k = 0
                    for g in own_groups:
                        lib_union |= groups[g]["liberties"]
                    la = len(lib_union) - 1
                kills[player - 1, x, y] = _clip255(k)
                liberties_after[player - 1, x, y] = _clip255(la)
    return kills, liberties_after


def summarize(stones: np.ndarray, age: np.ndarray) -> np.ndarray:
    """Full packed 9-channel record, (9, 19, 19) uint8."""
    labels, groups = find_groups(stones)
    ladders, liberties = ladders_and_liberties(stones, labels, groups)
    kills, liberties_after = kills_and_liberties_after(stones, labels, groups)
    packed = np.empty((9, SIZE, SIZE), dtype=np.uint8)
    packed[0] = stones
    packed[1] = liberties
    packed[2:4] = liberties_after
    packed[4:6] = kills
    packed[6] = np.minimum(age, 255)
    packed[7:9] = ladders
    return packed
