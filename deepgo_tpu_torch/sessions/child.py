"""Scripted session-server child for the crash-resume check.

The port's version of ``deepgo_tpu/sessions/child.py``.
``python -m deepgo_tpu_torch.sessions.child --store DIR --games N --moves M``
drives N interactive games against a 1-replica in-process fleet on
``--device`` (``cuda`` by default; it raises without CUDA), printing a
line-oriented protocol the parent parses:

    SESSION_RESUMED <n>         store recovery found n live sessions
    SESSION_ACK <sid> <seq>     one durably acked move (client or engine)
    SESSION_DIGEST <sid> <hex>  full-state digest of a finished game

``--kill-after-acks K`` makes the child SIGKILL ITSELF the instant the
K-th ack has been printed — between the fsync'd ack and whatever would
have come next, the exact window where an undurable implementation
loses a move. The client is STATE-driven, not script-position-driven:
on resume it looks only at the recovered board (whose turn, which
points are legal, how many moves played), so a killed run continued by
a fresh process replays to the same game as an uninterrupted one; the
parent grades that by comparing SESSION_DIGEST lines against a
never-killed reference child. Engine replies are deterministic (the
``small`` net drawn from a fixed ``torch.Generator`` seed, argmax policy),
which is what makes the digest comparison meaningful.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

from ..go.board import BLACK, SIZE
from .service import GameService
from .store import SessionStore


def _script(game_index: int) -> list[tuple[int, int]]:
    """The client's move preference order for game ``game_index`` —
    a fixed seeded shuffle of the whole board, so two runs of the same
    game index always prefer the same points."""
    import random

    points = [(x, y) for x in range(SIZE) for y in range(SIZE)]
    random.Random(1000 + game_index).shuffle(points)
    return points


class _AckCounter:
    """Print acks; self-SIGKILL the moment the K-th lands."""

    def __init__(self, kill_after: int | None):
        self.kill_after = kill_after
        self.acks = 0

    def ack(self, sid: str, seq: int) -> None:
        self.acks += 1
        print(f"SESSION_ACK {sid} {seq}", flush=True)
        if self.kill_after is not None and self.acks >= self.kill_after:
            # a real crash: no cleanup, no final checkpoint, no flush
            os.kill(os.getpid(), signal.SIGKILL)


def _scripted_point(game, script) -> tuple[int, int] | None:
    for x, y in script:
        if game.check_move(x, y, game.to_play) is None:
            return x, y
    return None


def _drive(service: GameService, counter: _AckCounter, games: int,
           moves: int, engine: bool) -> None:
    for gi in range(games):
        sid = f"bench-{gi:02d}"
        try:
            game = service.store.get(sid)
        except Exception:  # noqa: BLE001 — SessionNotFound: first run
            service.new_game(sid)
            game = service.store.get(sid)
        script = _script(gi)
        while len(game.moves) < 2 * moves and not game.over:
            elapsed = 0.01 * (len(game.moves) + 1)
            if game.to_play == BLACK or not engine:
                point = _scripted_point(game, script)
                if point is None:
                    out = service.play(sid, None, None, elapsed_s=elapsed,
                                       reply=False)
                else:
                    out = service.play(sid, point[0], point[1],
                                       elapsed_s=elapsed, reply=False)
            else:
                out = service.engine_reply(sid, elapsed_s=elapsed)
            counter.ack(sid, out["seq"])
        print(f"SESSION_DIGEST {sid} {game.digest()}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="scripted crash-resume session client")
    ap.add_argument("--store", required=True)
    ap.add_argument("--games", type=int, default=3)
    ap.add_argument("--moves", type=int, default=12,
                    help="client moves per game (total acks ~= 2x)")
    ap.add_argument("--kill-after-acks", type=int, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--no-engine", action="store_true",
                    help="script both sides (no fleet; WAL-path only)")
    ap.add_argument("--device", default="cuda",
                    help="the fleet's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    store = SessionStore(args.store,
                         checkpoint_every=args.checkpoint_every)
    print(f"SESSION_RESUMED {store.recovery['sessions']}", flush=True)
    counter = _AckCounter(args.kill_after_acks)

    fleet = None
    if not args.no_engine:
        import torch

        from ..models import policy_cnn
        from ..serving import EngineConfig, fleet_policy_engine

        cfg = policy_cnn.CONFIGS["small"]
        model = policy_cnn.init(torch.Generator().manual_seed(0), cfg,
                                device=args.device)
        fleet = fleet_policy_engine(
            model, cfg, replicas=1,
            config=EngineConfig(buckets=(1,), max_wait_ms=1.0),
            name="session-child", device=args.device)
        fleet.warmup()
    service = GameService(fleet, store, budgets_s=(0.5, 1.0, 2.0))
    try:
        _drive(service, counter, args.games, args.moves,
               engine=fleet is not None)
    finally:
        if fleet is not None:
            fleet.close()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
