"""The interactive game service: sessions in front of the fleet.

The port's copy of ``deepgo_tpu/sessions/service.py``, over the port's
fleet.

One ``GameService`` owns a ``SessionStore`` (durability) and a
``FleetRouter`` (engine replies). A client move is acked only after its
WAL record is fsync'd; the engine's reply then goes through the
INTERACTIVE tier with deadline-tiered per-move budgets — the first
attempt gets the tight deadline, each retry a looser one (the
escalation a human opponent prefers over a refusal), with bounded
full-jitter backoff between attempts. The ``session_reply``
fault site is consulted per attempt, so chaos can brown out exactly
this path; exhaustion surfaces as typed ``ReplyExhausted`` with the
session state untouched (the client simply retries the reply).

Replies are DETERMINISTIC — argmax of the policy logits over the
game's legal points (suicide/superko/occupied already excluded), pass
when no legal point remains — so a resumed server replays to the same
game as an uninterrupted one. Requests are stamped with the ``session``
label for the workload observatory. With ``search_sims > 0`` the reply
is instead a batched PUCT search (``search``) whose leaf
evaluations ride the same fleet tier; the search's anytime contract
returns a legal move within the final deadline tier, and any search
failure degrades to the plain argmax path rather than losing the move.
"""

from __future__ import annotations

import random
import time

import numpy as np

from ..analysis.lockcheck import make_lock
from ..go.board import SIZE
from ..go.summarize import summarize
from ..obs.registry import get_registry
from ..serving.resilience import full_jitter_delay
from ..utils import faults
from .game import SessionError
from .store import SessionStore

# deadline tiers for one engine reply: attempt k gets budget[k] seconds
# end-to-end (submit admission + queue + forward). Escalating budgets
# convert a transient stall into one slower reply instead of a refusal.
DEFAULT_BUDGETS_S = (0.25, 0.5, 1.5)


class ReplyExhausted(SessionError):
    """Every deadline-tiered reply attempt failed; the session is
    unchanged and the reply can be retried."""

    def __init__(self, session_id: str, attempts: int, last: str):
        super().__init__(
            f"engine reply for session {session_id!r} exhausted "
            f"{attempts} deadline-tiered attempt(s); last: {last}")
        self.session_id = session_id
        self.attempts = attempts


class GameService:
    """Interactive play over a durable store and a serving fleet."""

    def __init__(self, fleet, store: SessionStore,
                 tier: str = "interactive",
                 budgets_s: tuple = DEFAULT_BUDGETS_S, rank: int = 5,
                 sleep=time.sleep, rng: random.Random | None = None,
                 search_sims: int = 0, search_config=None, metrics=None):
        if not budgets_s:
            raise ValueError("budgets_s needs at least one deadline tier")
        self.fleet = fleet
        self.store = store
        self.tier = tier
        self.budgets_s = tuple(float(b) for b in budgets_s)
        self.rank = int(rank)
        self._sleep = sleep
        self._rng = rng or random.Random(0)
        # search_sims > 0 puts a PUCT search (the port's search) behind
        # every engine reply: leaf evaluations ride the same fleet on
        # the interactive tier, the reply deadline is the LAST budget
        # tier (the anytime contract absorbs mid-search failures the
        # retry ladder would otherwise pay for), and the move is still
        # deterministic and always legal for the session's superko rules
        # (the search only picks inside the game's own legal set)
        self._searcher = None
        if search_sims > 0 or search_config is not None:
            from ..search import Search, SearchConfig

            cfg = search_config or SearchConfig(
                simulations=search_sims, tier=tier, rank=int(rank),
                deadline_s=self.budgets_s[-1])
            self._searcher = Search(fleet, cfg, metrics=metrics)
        self._lock = make_lock("sessions.service")
        self._opened = 0
        self.reply_retries = 0
        self.replies = 0
        reg = get_registry()
        self._obs_moves = reg.counter(
            "deepgo_session_moves_total",
            "durably acked session moves, by source "
            "(client / engine / pass)")
        self._obs_replies = reg.counter(
            "deepgo_session_replies_total",
            "engine reply attempts on the interactive tier, by outcome")

    # -- lifecycle ---------------------------------------------------------

    def new_game(self, session_id: str | None = None,
                 handicaps: tuple = ()) -> str:
        with self._lock:
            if session_id is None:
                session_id = f"g{self._opened:05d}"
            self._opened += 1
        self.store.open_session(session_id, handicaps)
        return session_id

    def resign(self, session_id: str) -> int:
        return self.store.close_session(session_id)

    def state(self, session_id: str) -> dict:
        return self.store.get(session_id).snapshot()

    # -- the client move ---------------------------------------------------

    def play(self, session_id: str, x: int | None, y: int | None,
             elapsed_s: float = 0.0, reply: bool = True) -> dict:
        """Apply one client move (``x is None`` = pass); ack is durable
        on return. With ``reply=True`` the engine answers on the
        interactive tier unless the client's move ended the game."""
        game = self.store.get(session_id)
        player = game.to_play
        is_pass = x is None
        seq = self.store.append_move(session_id, player, x=x, y=y,
                                     is_pass=is_pass,
                                     elapsed_s=elapsed_s)
        self._obs_moves.inc(source="pass" if is_pass else "client")
        out = {"session": session_id, "seq": seq, "player": player,
               "over": game.over}
        if reply and not game.over:
            out["reply"] = self.engine_reply(session_id)
            out["over"] = game.over
        return out

    # -- the engine reply --------------------------------------------------

    def engine_reply(self, session_id: str,
                     elapsed_s: float = 0.0) -> dict:
        game = self.store.get(session_id)
        if game.over:
            raise SessionError(
                f"session {session_id!r} is over; nothing to reply to")
        player = game.to_play
        legal = game.legal_points()
        if not legal:
            seq = self.store.append_move(session_id, player, is_pass=True,
                                         elapsed_s=elapsed_s)
            self._obs_moves.inc(source="pass")
            return {"session": session_id, "seq": seq, "player": player,
                    "pass": True, "over": game.over}
        packed = summarize(game.stones, game.age)
        idx = np.array([x * SIZE + y for x, y in legal], dtype=np.int64)
        pick, extra = -1, {}
        if self._searcher is not None:
            pick, extra = self._search_reply(packed, player, idx)
        if pick < 0 or not (0 <= pick < SIZE * SIZE) or pick not in idx:
            row = self._forward(session_id, packed, player)
            masked = np.full(SIZE * SIZE, -np.inf, dtype=np.float64)
            masked[idx] = np.asarray(row,
                                     dtype=np.float64).reshape(-1)[idx]
            pick = int(masked.argmax())
        x, y = divmod(pick, SIZE)
        seq = self.store.append_move(session_id, player, x=x, y=y,
                                     elapsed_s=elapsed_s)
        self._obs_moves.inc(source="engine")
        self.replies += 1
        out = {"session": session_id, "seq": seq, "player": player,
               "x": x, "y": y, "over": game.over}
        out.update(extra)
        return out

    def _search_reply(self, packed, player: int, idx) -> tuple[int, dict]:
        """One PUCT search for the reply move. The session's own legal
        set (superko-aware) is the root mask, so the search can only
        pick moves the game accepts; any search failure degrades to the
        plain deadline-tiered argmax path rather than losing the move."""
        from ..search import game_from_packed

        root_legal = np.zeros(SIZE * SIZE, dtype=bool)
        root_legal[idx] = True
        try:
            res = self._searcher.search(game_from_packed(packed, player),
                                        root_legal=root_legal)
        except Exception:  # noqa: BLE001 — anytime: argmax still replies
            self._obs_replies.inc(outcome="search_failed")
            return -1, {}
        self._obs_replies.inc(outcome="search")
        extra = {"search": {"search_id": res.search_id,
                            "value": round(float(res.value), 4),
                            "simulations": res.simulations,
                            "deadline_met": res.deadline_met,
                            "pv": res.pv[:8]}}
        return int(res.move), extra

    def _forward(self, session_id: str, packed, player: int):
        """One policy forward under deadline-tiered budgets. Absorbable
        failures (shed, deadline, transient injection) burn one tier
        and back off full-jitter; anything else surfaces typed."""
        last: BaseException | None = None
        for attempt, budget_s in enumerate(self.budgets_s, start=1):
            try:
                faults.check("session_reply")
                fut = self.fleet.submit(packed, player, self.rank,
                                        tier=self.tier,
                                        timeout_s=budget_s,
                                        session=session_id)
                row = fut.result(timeout=budget_s + 5.0)
                self._obs_replies.inc(outcome="ok")
                return row
            except faults.InjectedFailure:
                self._obs_replies.inc(outcome="failed")
                raise  # a hard injected fault is not a deadline problem
            except (TimeoutError, OSError) as e:
                last = e  # deadline verdicts + transient injections
            except Exception as e:  # noqa: BLE001 — classified below
                if type(e).__name__ not in ("EngineOverloaded",
                                            "CircuitOpen", "EngineBusy",
                                            "FleetUnavailable"):
                    self._obs_replies.inc(outcome="failed")
                    raise
                last = e  # shed: the next tier gets more headroom
            self._obs_replies.inc(outcome="retry")
            with self._lock:
                self.reply_retries += 1
            if attempt < len(self.budgets_s):
                self._sleep(full_jitter_delay(attempt, 0.02, 0.2,
                                              self._rng))
        self._obs_replies.inc(outcome="exhausted")
        raise ReplyExhausted(session_id, len(self.budgets_s),
                             repr(last)) from last

    # -- observability -----------------------------------------------------

    def health(self) -> dict:
        """The composed-health component for ``cli serve --sessions``:
        healthy while no session is irrecoverably corrupt and the WAL
        lag stays under one full checkpoint interval of backlog."""
        s = self.store.stats()
        lag = s["wal_lag_records"]
        healthy = (not s["corrupt_sessions"]
                   and lag <= 2 * self.store.checkpoint_every)
        return {"healthy": healthy, "open_sessions": s["open_sessions"],
                "wal_lag_records": lag,
                "corrupt_sessions": len(s["corrupt_sessions"]),
                "reply_retries": self.reply_retries}

    def stats(self) -> dict:
        with self._lock:
            out = {"replies": self.replies,
                   "reply_retries": self.reply_retries}
        out.update(self.store.stats())
        return out

    def close(self) -> None:
        self.store.close()
