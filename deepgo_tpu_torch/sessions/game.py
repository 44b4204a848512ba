"""Per-session Go game state with FULL move legality.

The port's copy of ``deepgo_tpu/sessions/game.py``: the same rules,
snapshot and digest, so one move list gives the same ``digest()`` in
both packages.

The ``go/`` rules engine deliberately tracks no ko and allows suicide
(board.py:15-18): it replays *recorded* games whose legality the source
guarantees. An interactive session serves moves from an untrusted
client, so this layer adds what the replay engine omits — on top of the
same capture/liberty primitives, so board evolution stays bit-identical
to ``go/replay.py`` ground truth for any legal move sequence:

  * occupied-point refusal (wrapping the board engine's own check),
  * suicide refusal via ``simulate_play`` (liberties-after == 0),
  * POSITIONAL SUPERKO: a stone play may not recreate any earlier
    (board, side-to-move) pair of this game — stricter than the simple
    ko selfplay.py uses, because a session must refuse the long cycles
    a deterministic client could otherwise drive forever,
  * turn order, and pass handling with pass-pass game end (the SGF
    parser drops passes, so the replay engine never sees them).

Everything a resumed server must reproduce bit-identically — stones,
age, captures, move history, per-player clock, the superko history
itself — lives in the snapshot, and ``digest()`` hashes the canonical
serialization so "resumed bit-identically" is one string comparison.
"""

from __future__ import annotations

import base64
import hashlib
import json

import numpy as np

from ..go.board import (BLACK, EMPTY, SIZE, WHITE, IllegalMoveError,
                        new_board, play, simulate_play)


class SessionError(RuntimeError):
    """Base for typed session-layer errors."""


class IllegalMove(SessionError):
    """A move the rules refuse; ``reason`` says why, for the client."""

    def __init__(self, session_id: str, reason: str):
        super().__init__(f"illegal move in session {session_id!r}: {reason}")
        self.session_id = session_id
        self.reason = reason


def _board_key(stones: np.ndarray, to_play: int) -> str:
    """Superko identity: the stone configuration plus whose turn it is
    (age is derived bookkeeping, not position identity)."""
    return hashlib.sha1(
        stones.tobytes() + bytes([to_play])).hexdigest()


class GoGame:
    """One live game: board, captures, clock, superko history.

    All mutation goes through ``play_move``/``play_pass`` so the WAL
    layer (store.py) can log exactly what it applied; replaying the
    same records through the same methods reconstructs the same state.
    """

    def __init__(self, session_id: str, handicaps: tuple = ()):
        self.session_id = session_id
        self.stones, self.age = new_board()
        self.handicaps = tuple((int(p), int(x), int(y))
                               for p, x, y in handicaps)
        for p, x, y in self.handicaps:
            play(self.stones, self.age, x, y, p)
        # with setup stones on the board, white moves first (free-placement
        # handicap convention); otherwise black
        self.to_play = WHITE if self.handicaps else BLACK
        self.captures = {BLACK: 0, WHITE: 0}
        self.clock_s = {BLACK: 0.0, WHITE: 0.0}
        self.moves: list[dict] = []
        self.passes = 0
        self.over = False
        self.history: set[str] = {_board_key(self.stones, self.to_play)}

    # -- legality ----------------------------------------------------------

    def check_move(self, x: int, y: int, player: int) -> str | None:
        """The refusal reason for playing ``player`` at (x, y) now, or
        None when the move is legal. Pure — never mutates."""
        if self.over:
            return "game is over (two consecutive passes)"
        if player != self.to_play:
            return (f"out of turn: player {player} moved but "
                    f"{self.to_play} is to play")
        if not (0 <= x < SIZE and 0 <= y < SIZE):
            return f"point ({x}, {y}) is off the board"
        if self.stones[x, y] != EMPTY:
            return f"point ({x}, {y}) is occupied"
        _, liberties_after = simulate_play(self.stones, x, y, player)
        if liberties_after == 0:
            return f"suicide at ({x}, {y})"
        trial = self.stones.copy()
        play(trial, None, x, y, player)
        if _board_key(trial, 3 - player) in self.history:
            return (f"positional superko: ({x}, {y}) recreates an "
                    "earlier position of this game")
        return None

    def legal_points(self) -> list[tuple[int, int]]:
        """Every legal stone play for the side to move (empty when only
        a pass remains)."""
        if self.over:
            return []
        return [(x, y) for x in range(SIZE) for y in range(SIZE)
                if self.stones[x, y] == EMPTY
                and self.check_move(x, y, self.to_play) is None]

    # -- mutation ----------------------------------------------------------

    def play_move(self, x: int, y: int, player: int,
                  elapsed_s: float = 0.0) -> int:
        """Apply one legal stone play; returns stones captured. Raises
        typed ``IllegalMove`` (never the board engine's bare error)."""
        reason = self.check_move(x, y, player)
        if reason is not None:
            raise IllegalMove(self.session_id, reason)
        try:
            kills = play(self.stones, self.age, x, y, player)
        except IllegalMoveError as e:  # unreachable after check_move
            raise IllegalMove(self.session_id, str(e)) from e
        self.captures[player] += kills
        self.clock_s[player] = round(
            self.clock_s[player] + float(elapsed_s), 6)
        self.moves.append({"player": int(player), "x": int(x), "y": int(y)})
        self.passes = 0
        self.to_play = 3 - player
        self.history.add(_board_key(self.stones, self.to_play))
        return kills

    def play_pass(self, player: int, elapsed_s: float = 0.0) -> bool:
        """Record a pass; returns True when this pass ends the game."""
        if self.over:
            raise IllegalMove(self.session_id,
                              "game is over (two consecutive passes)")
        if player != self.to_play:
            raise IllegalMove(
                self.session_id,
                f"out of turn: player {player} passed but "
                f"{self.to_play} is to play")
        self.clock_s[player] = round(
            self.clock_s[player] + float(elapsed_s), 6)
        self.moves.append({"player": int(player), "pass": True})
        self.passes += 1
        self.to_play = 3 - player
        if self.passes >= 2:
            self.over = True
        return self.over

    # -- serialization (checkpoints + the bit-identical comparator) --------

    def snapshot(self) -> dict:
        return {
            "session": self.session_id,
            "stones": base64.b64encode(self.stones.tobytes()).decode(),
            "age": base64.b64encode(
                self.age.astype(np.int32).tobytes()).decode(),
            "handicaps": [list(h) for h in self.handicaps],
            "to_play": int(self.to_play),
            "captures": {str(k): int(v) for k, v in self.captures.items()},
            "clock_s": {str(k): float(v) for k, v in self.clock_s.items()},
            "moves": list(self.moves),
            "passes": int(self.passes),
            "over": bool(self.over),
            "history": sorted(self.history),
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "GoGame":
        game = cls.__new__(cls)
        game.session_id = str(snap["session"])
        stones = np.frombuffer(base64.b64decode(snap["stones"]),
                               dtype=np.uint8)
        age = np.frombuffer(base64.b64decode(snap["age"]), dtype=np.int32)
        if stones.size != SIZE * SIZE or age.size != SIZE * SIZE:
            raise ValueError(
                f"snapshot for {game.session_id!r} has a malformed board "
                f"({stones.size}/{age.size} points)")
        game.stones = stones.reshape(SIZE, SIZE).copy()
        game.age = age.reshape(SIZE, SIZE).copy()
        game.handicaps = tuple(tuple(h) for h in snap.get("handicaps", ()))
        game.to_play = int(snap["to_play"])
        game.captures = {int(k): int(v)
                         for k, v in snap["captures"].items()}
        game.clock_s = {int(k): float(v)
                        for k, v in snap["clock_s"].items()}
        game.moves = [dict(m) for m in snap["moves"]]
        game.passes = int(snap["passes"])
        game.over = bool(snap["over"])
        game.history = set(snap["history"])
        return game

    def digest(self) -> str:
        """One hash over the full resumable state; two games are
        bit-identical iff their digests match."""
        body = json.dumps(self.snapshot(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(body.encode()).hexdigest()
