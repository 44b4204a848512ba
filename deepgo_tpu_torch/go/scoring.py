"""Tromp-Taylor area scoring for finished games.

The port's copy of ``deepgo_tpu/go/scoring.py``.

The reference's paper evaluation (README.md:5, arXiv:1412.6564) reports win
rate against GnuGo, which requires scoring finished boards; the reference
repo itself never scores a game. This module supplies the missing half:
area scoring per the Tromp-Taylor rules — a player's score is the number of
their stones plus the number of empty points that reach only their color.
Empty regions touching both colors (dame, seki gaps) count for neither.

Pure host-side NumPy over a 361-point board; one BFS pass over empty
regions per call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .board import BLACK, EMPTY, SIZE, WHITE, _NEIGHBORS


@dataclass(frozen=True)
class Score:
    black: float
    white: float
    komi: float

    @property
    def margin(self) -> float:
        """Black's winning margin (negative = white wins)."""
        return self.black - self.white - self.komi

    @property
    def winner(self) -> int:
        """BLACK, WHITE, or EMPTY (0) for a drawn game."""
        if self.margin > 0:
            return BLACK
        if self.margin < 0:
            return WHITE
        return EMPTY

    def result_string(self) -> str:
        """SGF RE[] value, e.g. ``B+12.5`` / ``W+3.5`` / ``0`` (draw)."""
        if self.margin > 0:
            return f"B+{self.margin:g}"
        if self.margin < 0:
            return f"W+{-self.margin:g}"
        return "0"


def area_score(stones: np.ndarray, komi: float = 7.5) -> Score:
    """Tromp-Taylor area count of a (19, 19) board.

    Each empty region is flood-filled once; it scores for a color iff every
    stone adjacent to the region is that color. Stones score for themselves.
    """
    black = int(np.count_nonzero(stones == BLACK))
    white = int(np.count_nonzero(stones == WHITE))

    seen = np.zeros((SIZE, SIZE), dtype=bool)
    for x in range(SIZE):
        for y in range(SIZE):
            if stones[x, y] != EMPTY or seen[x, y]:
                continue
            # BFS one empty region, recording which colors border it
            region = [(x, y)]
            seen[x, y] = True
            borders = 0  # bitmask: 1 = black, 2 = white
            size = 0
            while region:
                a, b = region.pop()
                size += 1
                for n in _NEIGHBORS[a][b]:
                    v = stones[n]
                    if v == EMPTY:
                        if not seen[n]:
                            seen[n] = True
                            region.append(n)
                    else:
                        borders |= 1 << (v - 1)
            if borders == 1:
                black += size
            elif borders == 2:
                white += size

    return Score(black=float(black), white=float(white), komi=komi)
