"""Core Go board rules: placement, capture, liberties, hypothetical play.

The port's copy of ``deepgo_tpu/go/board.py``.

Semantics mirror the reference engine (reference makedata.lua:188-354) but the
implementation is different: a single connected-components pass labels every
chain once per position (``find_groups``), and hypothetical-play queries use
set unions over precomputed group liberty sets, falling back to a real
play-and-undo simulation only when a capture occurs. The reference instead
re-flood-fills from scratch for every query (makedata.lua:245-282,304-327).

Board representation: ``stones`` is a (19, 19) uint8 array with 0 empty,
1 black, 2 white; axis 0 is the SGF x coordinate. ``age`` is a (19, 19) int32
array counting how many moves each point has been in its current state
(0 = never occupied, capped at 255; reference makedata.lua:329-339).

Deliberately no ko/superko tracking, matching the reference: both engines
replay *recorded* games, where move legality is guaranteed by the source;
only occupied-point plays are rejected (reference makedata.lua:352).
"""

from __future__ import annotations

import numpy as np

SIZE = 19
EMPTY, BLACK, WHITE = 0, 1, 2
MAX_AGE = 255

# Flat neighbor adjacency, precomputed once: _NEIGHBORS[x][y] is a tuple of
# (nx, ny) pairs orthogonally adjacent to (x, y) and on the board.
_NEIGHBORS: list[list[tuple[tuple[int, int], ...]]] = [
    [
        tuple(
            (nx, ny)
            for nx, ny in ((x - 1, y), (x + 1, y), (x, y - 1), (x, y + 1))
            if 0 <= nx < SIZE and 0 <= ny < SIZE
        )
        for y in range(SIZE)
    ]
    for x in range(SIZE)
]


def neighbors(x: int, y: int) -> tuple[tuple[int, int], ...]:
    """On-board orthogonal neighbors of (x, y)."""
    return _NEIGHBORS[x][y]


class IllegalMoveError(Exception):
    pass


def new_board() -> tuple[np.ndarray, np.ndarray]:
    """Fresh empty (stones, age) pair."""
    return (
        np.zeros((SIZE, SIZE), dtype=np.uint8),
        np.zeros((SIZE, SIZE), dtype=np.int32),
    )


def group_and_liberties(stones: np.ndarray, x: int, y: int):
    """Flood-fill the chain containing (x, y).

    Returns (group, liberties) as sets of (x, y) points; both empty if the
    point is unoccupied (the reference's count_liberties returns 0 liberties
    for empty points, makedata.lua:254).
    """
    player = stones[x, y]
    if player == EMPTY:
        return set(), set()
    group = {(x, y)}
    liberties = set()
    stack = [(x, y)]
    while stack:
        a, b = stack.pop()
        for n in _NEIGHBORS[a][b]:
            v = stones[n]
            if v == player:
                if n not in group:
                    group.add(n)
                    stack.append(n)
            elif v == EMPTY:
                liberties.add(n)
    return group, liberties


def find_groups(stones: np.ndarray):
    """Label every chain on the board in one pass.

    Returns (labels, groups): ``labels`` is a (19, 19) int32 array mapping
    each stone to its group index (-1 for empty points); ``groups`` is a list
    of dicts with keys ``player``, ``points`` (set), ``liberties`` (set).
    """
    labels = np.full((SIZE, SIZE), -1, dtype=np.int32)
    groups = []
    for x in range(SIZE):
        for y in range(SIZE):
            if stones[x, y] != EMPTY and labels[x, y] < 0:
                group, liberties = group_and_liberties(stones, x, y)
                idx = len(groups)
                for p in group:
                    labels[p] = idx
                groups.append(
                    {"player": int(stones[x, y]), "points": group, "liberties": liberties}
                )
    return labels, groups


def _remove_dead_neighbors(stones, age, x, y, undo=None):
    """Remove dead opposing chains around (x, y), then (x, y)'s own chain if
    dead (suicide). Returns the number of *opposing* stones removed.

    Mirrors play_with_f/apply_f_to_dead_neighbors (reference
    makedata.lua:224-241,388-391): removed points get age 1, and a killed own
    chain does not count toward the kill total.
    """
    player = stones[x, y]
    opponent = 3 - player
    kills = 0
    checked: set[tuple[int, int]] = set()
    for n in _NEIGHBORS[x][y]:
        if stones[n] == opponent and n not in checked:
            group, liberties = group_and_liberties(stones, *n)
            checked |= group
            if not liberties:
                kills += len(group)
                for p in group:
                    if undo is not None:
                        undo.append((p, opponent))
                    stones[p] = EMPTY
                    if age is not None:
                        age[p] = 1
    own_group, own_liberties = group_and_liberties(stones, x, y)
    if not own_liberties:
        for p in own_group:
            if undo is not None:
                undo.append((p, player))
            stones[p] = EMPTY
            if age is not None:
                age[p] = 1
    return kills


def play(stones: np.ndarray, age: np.ndarray | None, x: int, y: int, player: int) -> int:
    """Apply a real move in place with full capture resolution.

    Ages every occupied point first, places the stone (age 1), removes dead
    opposing chains and then a dead own chain (suicide), stamping removed
    points with age 1 (reference update_board, makedata.lua:329-354).
    Returns the number of opposing stones captured.
    """
    if stones[x, y] != EMPTY:
        raise IllegalMoveError(f"point ({x}, {y}) is already occupied")
    if age is not None:
        np.minimum(age + (age > 0), MAX_AGE, out=age)
    stones[x, y] = player
    if age is not None:
        age[x, y] = 1
    return _remove_dead_neighbors(stones, age, x, y)


def simulate_play(stones: np.ndarray, x: int, y: int, player: int):
    """Hypothetically play at empty (x, y): returns (kills, liberties_after).

    ``kills`` counts opposing stones that would be captured;
    ``liberties_after`` is the liberty count of the newly formed chain (0 for
    suicide). The board is restored before returning (reference
    count_kills_and_liberties, makedata.lua:304-327).
    """
    if stones[x, y] != EMPTY:
        raise IllegalMoveError(f"simulating a play on occupied ({x}, {y})")
    undo: list[tuple[tuple[int, int], int]] = [((x, y), EMPTY)]
    stones[x, y] = player
    kills = _remove_dead_neighbors(stones, None, x, y, undo)
    _, liberties = group_and_liberties(stones, x, y)
    for point, value in reversed(undo):
        stones[point] = value
    return kills, len(liberties)


def play_with_undo(stones: np.ndarray, x: int, y: int, player: int, undo: list) -> None:
    """Play with capture resolution, recording every change into ``undo``
    (a list of ((x, y), previous_value)); used by the ladder reader's
    temp-play search (reference ladder_moves' temp_play, makedata.lua:393-407).
    """
    if stones[x, y] != EMPTY:
        raise IllegalMoveError(f"temp-playing on occupied ({x}, {y})")
    undo.append(((x, y), EMPTY))
    stones[x, y] = player
    _remove_dead_neighbors(stones, None, x, y, undo)


def undo_moves(stones: np.ndarray, undo: list) -> None:
    """Restore a board mutated through ``play_with_undo``."""
    for point, value in reversed(undo):
        stones[point] = value
    undo.clear()
