"""SGF (Smart Game Format) parsing for 19x19 Go game records.

The port's copy of ``deepgo_tpu/sgf.py``.

Replaces the reference's line-oriented tokenizer (reference makedata.lua:24-120:
``split_sgf``/``all_moves``/``handicaps``/``get_ranks``) with a real SGF
property scanner: properties may span lines, carry multiple bracketed values,
and escape ``]`` inside values. Behavioral parity points:

  * moves: B/W properties in order; passes (empty value or ``tt``) are
    dropped, exactly like the reference's ``to_move`` returning nil for
    values it cannot map (makedata.lua:60-67).
  * handicap/setup stones: AB/AW values in order of appearance
    (makedata.lua:24-38); order matters because stone placement order
    determines the age feature plane.
  * ranks: BR/WR must both parse as dan ranks ``<n>d`` with n in 1..9,
    otherwise the game is rejected (makedata.lua:92-120; the 1..9 bound is
    implied there by the 9 rank feature planes, dataloader.lua:12).

Coordinates are 0-based: 'a'..'s' -> 0..18, x = first letter, y = second.
Players are 1 (black) and 2 (white).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from . import BOARD_SIZE

BLACK, WHITE = 1, 2

_COORD_OF_CHAR = {c: i for i, c in enumerate("abcdefghijklmnopqrs")}


@dataclass(frozen=True)
class Move:
    player: int  # 1 black, 2 white
    x: int  # 0..18
    y: int  # 0..18


@dataclass
class Game:
    moves: list[Move] = field(default_factory=list)  # passes excluded
    handicaps: list[Move] = field(default_factory=list)  # AB/AW setup stones
    ranks: tuple[int, int] | None = None  # (black dan, white dan) or None
    properties: dict[str, list[str]] = field(default_factory=dict)


# PropIdent then one-or-more bracketed values; values may escape ']' as '\]'.
_PROP_RE = re.compile(r"([A-Za-z]+)((?:\s*\[(?:[^\\\]]|\\.)*\])+)", re.S)
_VALUE_RE = re.compile(r"\[((?:[^\\\]]|\\.)*)\]", re.S)


def _to_point(value: str) -> tuple[int, int] | None:
    """SGF move value -> (x, y), or None for a pass.

    Empty value and the conventional 19x19 pass value 'tt' both map to None,
    matching the reference dropping any value it cannot convert
    (makedata.lua:60-67 via the a..s char table).
    """
    if len(value) != 2:
        return None
    x = _COORD_OF_CHAR.get(value[0])
    y = _COORD_OF_CHAR.get(value[1])
    if x is None or y is None:
        return None
    return x, y


def _to_rank(value: str) -> int | None:
    """Dan-rank string '<n>d' -> n, else None (reference to_rank, makedata.lua:92-100)."""
    m = re.fullmatch(r"(\d+)d", value.strip())
    if not m:
        return None
    return int(m.group(1))


def parse(text: str) -> Game:
    """Parse one SGF game record into a Game."""
    game = Game()
    for m in _PROP_RE.finditer(text):
        ident = m.group(1)
        values = [v.group(1).replace("\\]", "]") for v in _VALUE_RE.finditer(m.group(2))]
        game.properties.setdefault(ident, []).extend(values)
        if ident in ("B", "W"):
            player = BLACK if ident == "B" else WHITE
            for value in values:
                pt = _to_point(value)
                if pt is not None:
                    game.moves.append(Move(player, *pt))
        elif ident in ("AB", "AW"):
            player = BLACK if ident == "AB" else WHITE
            for value in values:
                pt = _to_point(value)
                if pt is not None:
                    game.handicaps.append(Move(player, *pt))

    br = game.properties.get("BR", [])
    wr = game.properties.get("WR", [])
    black_rank = _to_rank(br[0]) if br else None
    white_rank = _to_rank(wr[0]) if wr else None
    if (black_rank is not None and white_rank is not None
            and 1 <= black_rank <= 9 and 1 <= white_rank <= 9):
        game.ranks = (black_rank, white_rank)
    return game


def parse_file(path: str) -> Game:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse(f.read())


def coord_to_sgf(x: int, y: int) -> str:
    """0-based (x, y) -> two-letter SGF coordinate."""
    chars = "abcdefghijklmnopqrs"
    assert 0 <= x < BOARD_SIZE and 0 <= y < BOARD_SIZE
    return chars[x] + chars[y]
