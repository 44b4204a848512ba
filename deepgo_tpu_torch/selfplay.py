"""Batched self-play: the policy network playing itself.

The port's twin of ``deepgo_tpu/selfplay.py``. Everything but the forward
is the same numpy: the host summarizes each live board into a packed
record (the native C++ engine when it builds, ``go/native.py``), every
game submits its board to the micro-batching inference engine
(``deepgo_tpu_torch.serving``) as an independent request, the dispatcher
coalesces the fleet into one padded forward on the card per ply (the
expansion kernel, then the conv stack), and each game plays its best
*legal* move (legality = empty and not suicide, straight from the packed
liberties-after channel — no second rules query). Batches pad onto the
engine's bucket ladder, so games finishing at mixed lengths keep the
dispatch shapes to a handful of rungs.

Games end on double pass — a player passes when no legal move is left or
when its best move's probability falls below ``pass_threshold`` — or at
``max_moves``. Finished games can be exported as SGF, which feeds back into
the port's own transcription pipeline (``data/transcribe.py``).

Usage (on the card; ``--device cpu`` for the CPU):
  python -m deepgo_tpu_torch.selfplay --games 32 [--checkpoint runs/<id>/checkpoint.npz]
      [--max-moves 200] [--sgf-out selfplay_games/] [--temperature 0.5]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import BOARD_SIZE
from .features import P_LIB_AFTER, P_STONES
from .go import (group_and_liberties, native, neighbors, new_board, play,
                 summarize)
from .models import policy_cnn
from .serving import (BucketLadder, EngineConfig, bucketed_forward,
                      ladder_for, policy_engine)
from .sgf import Move, coord_to_sgf


class GameState:
    def __init__(self):
        self.stones, self.age = new_board()
        self.player = 1
        self.moves: list[Move] = []
        self.passes = 0
        self.done = False
        self.ko_point: tuple[int, int] | None = None


def apply_move(g: GameState, x: int, y: int) -> None:
    """Play the side-to-move's stone in game ``g`` with simple-ko tracking.

    The rules engine deliberately has no ko (it replays *recorded* games,
    board.py:15-18), but generated games need it: without a ko ban two
    deterministic agents recapture the same stone forever. After a play that
    captures exactly one stone and leaves the new stone as a lone chain with
    exactly one liberty, that captured point is banned for the opponent's
    immediate reply (simple ko; superko is not needed for policy-net play).
    """
    would_die: set[tuple[int, int]] = set()
    for n in neighbors(x, y):
        if g.stones[n] == 3 - g.player and n not in would_die:
            grp, libs = group_and_liberties(g.stones, *n)
            if libs == {(x, y)}:
                would_die |= grp
    play(g.stones, g.age, x, y, g.player)
    g.ko_point = None
    if len(would_die) == 1:
        grp, libs = group_and_liberties(g.stones, x, y)
        if len(grp) == 1 and len(libs) == 1:
            g.ko_point = next(iter(would_die))
    g.moves.append(Move(g.player, x, y))


def step_game(g: GameState, move_idx: int, max_moves: int) -> None:
    """Advance one ply: play ``move_idx`` or record a pass (-1); end the
    game on double pass or the move cap; flip the side to move."""
    if move_idx < 0:
        g.passes += 1
        g.ko_point = None  # a pass lifts the ko ban for the next player
        if g.passes >= 2:
            g.done = True
    else:
        g.passes = 0
        x, y = divmod(move_idx, BOARD_SIZE)
        apply_move(g, x, y)
        if len(g.moves) >= max_moves:
            g.done = True
    g.player = 3 - g.player


def step_games(games: list[GameState], moves, max_moves: int) -> None:
    """Advance every game one ply: game i plays ``moves[i]`` (-1 = pass).

    The move application — capture resolution, aging, simple-ko detection —
    runs as ONE threaded native call over all boards
    (native.play_batch_native) instead of a Python flood-fill per game,
    which profiling showed was >80% of the arena/self-play host time.
    Python keeps only the bookkeeping (move lists, pass/done flags, side to
    move). Falls back to per-game step_game without the native library.
    """
    played = [i for i, m in enumerate(moves) if m >= 0 and not games[i].done]
    if not native.batch_available() or not played:
        for i, m in enumerate(moves):
            if not games[i].done:  # same done-game skip as the native path
                step_game(games[i], int(m), max_moves)
        return
    stones = np.stack([games[i].stones for i in played])
    age = np.stack([games[i].age for i in played])
    mv = np.array([int(moves[i]) for i in played], dtype=np.int32)
    pl = np.array([games[i].player for i in played], dtype=np.int32)
    ko = native.play_batch_native(stones, age, mv, pl)
    for j, i in enumerate(played):
        g = games[i]
        g.stones[:] = stones[j]
        g.age[:] = age[j]
        g.ko_point = None if ko[j] < 0 else divmod(int(ko[j]), BOARD_SIZE)
        x, y = divmod(int(mv[j]), BOARD_SIZE)
        g.moves.append(Move(g.player, x, y))
        g.passes = 0
        if len(g.moves) >= max_moves:
            g.done = True
        g.player = 3 - g.player
    for i, m in enumerate(moves):
        if m < 0 and not games[i].done:
            step_game(games[i], int(m), max_moves)


def summarize_state(state: GameState) -> np.ndarray:
    if native.available():
        return native.summarize_native(state.stones, state.age)
    return summarize(state.stones, state.age)


def summarize_states(states: list[GameState]) -> np.ndarray:
    """Packed records for a fleet of live games, (N, 9, 19, 19) uint8.

    One native call (threaded in C++) summarizes every board — the per-ply
    host cost of self-play/arena drops from N FFI crossings plus a Python
    loop to a single crossing. Falls back to the per-board path without the
    native library (or with a stale .so lacking the batch symbol)."""
    if native.batch_available():
        stones = np.stack([g.stones for g in states])
        age = np.stack([g.age for g in states])
        return native.summarize_batch_native(stones, age)
    return np.stack([summarize_state(g) for g in states])


def legal_mask(packed: np.ndarray, players: np.ndarray,
               games: list[GameState] | None = None) -> np.ndarray:
    """(N, 361) bool: empty, not suicide, and not a banned ko recapture.

    Emptiness and suicide come from the packed planes alone; the ko ban
    comes from each game's ``ko_point`` when ``games`` is given.
    """
    n = packed.shape[0]
    empty = packed[:, P_STONES].reshape(n, -1) == 0
    lib_after = packed[np.arange(n), P_LIB_AFTER + players - 1].reshape(n, -1)
    legal = empty & (lib_after > 0)
    if games is not None:
        for i, g in enumerate(games):
            if g.ko_point is not None:
                legal[i, g.ko_point[0] * BOARD_SIZE + g.ko_point[1]] = False
    return legal


def batched_log_probs(predict, params, packed: np.ndarray,
                      players: np.ndarray, ranks: np.ndarray,
                      ladder: BucketLadder | None = None) -> np.ndarray:
    """Policy log-probs with the batch padded onto the serving bucket
    ladder (``serving/buckets.py``); ``predict`` is a
    ``models.serving.make_policy_fn`` forward.

    Game batches shrink irregularly as games finish; the ladder keeps the
    set of batch sizes the forward ever sees to a handful of rungs (and so
    cuDNN's algorithm choices), and within a rung a padded row is bitwise
    the row of any other batch on that rung (row-independent model). This
    is the direct, threadless path for a single lockstep caller;
    concurrent submitters should share an ``serving.InferenceEngine``
    instead.
    """
    return bucketed_forward(
        lambda pk, pl, rk: predict(params, pk, pl, rk)["log_probs"],
        packed, players, ranks, ladder or ladder_for(len(packed)))


def select_from_log_probs(row: np.ndarray, temperature: float,
                          pass_threshold: float,
                          rng: np.random.Generator) -> int:
    """Pick a move from one masked (-inf = illegal) log-prob row.

    Returns a flat move index, or -1 to pass (no legal move, or the chosen
    move's probability falls below ``pass_threshold``).
    """
    if not np.isfinite(row.max()):
        return -1
    if temperature > 0:
        z = (row - row.max()) / temperature
        p = np.exp(z)
        move = int(rng.choice(361, p=p / p.sum()))
    else:
        move = int(row.argmax())
    if float(np.exp(row[move])) < pass_threshold:
        return -1
    return move


def self_play(params, cfg: policy_cnn.ModelConfig, n_games: int = 32,
              max_moves: int = 361, temperature: float = 0.0,
              pass_threshold: float = 1e-4, rank: int = 9, seed: int = 0,
              engine=None, max_wait_ms: float = 2.0,
              supervised: bool = False, fleet: int = 0,
              move_selector=None, device="cuda"):
    """Play n_games to completion; returns (games, stats).

    ``params`` is a float32 ``PolicyCNN`` of ``cfg`` on ``device``; a
    private engine runs there (``cuda`` unless asked for the CPU, raising
    without CUDA). Inference rides the micro-batching engine
    (``deepgo_tpu_torch.serving``): each
    live game submits its own board and gets a future, instead of the
    fleet advancing as one lockstep batch. The dispatcher coalesces the
    submissions, pads to a precompiled bucket, and answers them in one
    device dispatch — so as games finish at mixed lengths the shrinking
    fleet stays on the ladder's rungs, and other workloads
    sharing the engine (arena agents, an eval frontend) ride the same
    saturated dispatches. Pass ``engine`` to share one; by default the
    run builds a private engine over a ladder trimmed to ``n_games``,
    warms every rung, and closes it on exit. ``supervised=True`` puts the
    private engine under the resilience supervisor (auto-restart, poison
    isolation, breaker, deadline shedding): games
    then ride through dispatcher deaths untouched, with bit-identical
    results (the forward is pure, replay is idempotent).
    ``fleet >= 2`` spreads the games over that many supervised replicas
    behind a FleetRouter (serving/fleet.py) — requests ride the
    ``selfplay`` priority tier, so an overloaded shared fleet sheds them
    before interactive traffic. ``stats["engine"]`` carries the engine's
    occupancy/latency/bucket counters (plus the supervisor's
    restart/shed/poison counters when supervised, or the fleet's
    failover/respawn/shed counters with ``fleet``).

    ``move_selector`` replaces the per-row policy sampling entirely —
    AlphaZero-style search-selfplay
    (``search.make_move_selector``): called as
    ``move_selector(games, packed, players, legal, rng)`` and returning
    one move index per active game (-1 = pass). The selector owns its
    own inference traffic (the search's wave-batched leaf futures), so
    the per-game policy submission loop is skipped.
    """
    own_engine = engine is None
    if own_engine:
        ecfg = EngineConfig(buckets=ladder_for(n_games).buckets,
                            max_wait_ms=max_wait_ms)
        if fleet and fleet >= 2:
            from .serving import FleetConfig, fleet_policy_engine

            engine = fleet_policy_engine(
                params, cfg, replicas=fleet, config=ecfg,
                fleet=FleetConfig(default_tier="selfplay"), device=device)
        elif supervised:
            from .serving import supervised_policy_engine

            engine = supervised_policy_engine(params, cfg, config=ecfg,
                                              device=device)
        else:
            engine = policy_engine(params, cfg, config=ecfg, device=device)
        engine.warmup()
    rng = np.random.default_rng(seed)
    games = [GameState() for _ in range(n_games)]
    positions = 0
    from .obs import get_registry

    reg = get_registry()
    obs_positions = reg.counter(
        "deepgo_selfplay_positions_total", "selfplay positions evaluated")
    obs_rate = reg.gauge(
        "deepgo_selfplay_positions_per_sec",
        "positions/sec of the most recent selfplay run")
    obs_games = reg.gauge(
        "deepgo_selfplay_active_games", "live games in the current fleet")
    t0 = time.time()

    try:
        while True:
            active = [g for g in games if not g.done]
            if not active:
                break
            packed = summarize_states(active)
            players = np.array([g.player for g in active], dtype=np.int32)
            legal = legal_mask(packed, players, active)
            positions += len(active)
            obs_positions.inc(len(active))
            obs_games.set(len(active))

            if move_selector is not None:
                # search-selfplay: the selector runs its own tree search
                # per game (its leaf futures are the inference traffic)
                moves = [int(m) for m in
                         move_selector(active, packed, players, legal, rng)]
            else:
                # every game is an independent submitter: futures out,
                # one coalesced dispatch behind them
                futures = [engine.submit(packed[i], int(players[i]), rank)
                           for i in range(len(active))]
                logp = np.stack([f.result() for f in futures])
                logp = np.where(legal, logp, -np.inf)
                moves = [select_from_log_probs(logp[i], temperature,
                                               pass_threshold, rng)
                         for i in range(len(active))]

            step_games(active, moves, max_moves)

        dt = time.time() - t0
        obs_rate.set(positions / dt)
        obs_games.set(0)
        stats = {
            "games": n_games,
            "positions": positions,
            "seconds": dt,
            "positions_per_sec": positions / dt,
            "mean_moves": float(np.mean([len(g.moves) for g in games])),
            "engine": engine.stats(),
        }
        return games, stats
    finally:
        if own_engine:
            engine.close()


def to_sgf(game: GameState, black_rank: int = 9, white_rank: int = 9,
           result: str | None = None, komi: float | None = None) -> str:
    lines = ["(;GM[1]", "FF[4]", "CA[UTF-8]", "SZ[19]",
             f"BR[{black_rank}d]", f"WR[{white_rank}d]"]
    if komi is not None:
        lines.append(f"KM[{komi:g}]")
    if result is not None:
        lines.append(f"RE[{result}]")
    for m in game.moves:
        tag = "B" if m.player == 1 else "W"
        lines.append(f";{tag}[{coord_to_sgf(m.x, m.y)}]")
    return "\r\n".join(lines) + ")\r\n"


def main(argv=None) -> None:
    import os

    from .utils.atomicio import atomic_write

    ap = argparse.ArgumentParser()
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--checkpoint", help="policy checkpoint (default: random init)")
    ap.add_argument("--model", default="small", choices=list(policy_cnn.CONFIGS))
    ap.add_argument("--max-moves", type=int, default=361)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--sgf-out", help="directory to write finished games")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="engine coalescing window: how long the "
                         "dispatcher waits for more submitters before "
                         "padding and dispatching")
    ap.add_argument("--supervised", action="store_true",
                    help="run the engine under the resilience supervisor: "
                         "dispatcher-death auto-restart with request "
                         "replay, batch-poison isolation, circuit "
                         "breaker, deadline-aware shedding")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="spread inference over N supervised engine "
                         "replicas behind the failover router "
                         "(serving/fleet.py): least-wait placement, "
                         "replica respawn, selfplay-tier QoS")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    if args.checkpoint:
        from .models.serving import load_policy

        _, params, cfg = load_policy(args.checkpoint, device=args.device)
    else:
        # a seeded torch.Generator: not the JAX package's weights for the
        # same seed
        cfg = policy_cnn.CONFIGS[args.model]
        params = policy_cnn.init(torch.Generator().manual_seed(args.seed),
                                 cfg, device=args.device)

    games, stats = self_play(params, cfg, n_games=args.games,
                             max_moves=args.max_moves,
                             temperature=args.temperature, seed=args.seed,
                             max_wait_ms=args.max_wait_ms,
                             supervised=args.supervised, fleet=args.fleet,
                             device=args.device)
    print({k: round(v, 2) if isinstance(v, float) else v
           for k, v in stats.items()})

    if args.sgf_out:
        from .go.scoring import area_score

        os.makedirs(args.sgf_out, exist_ok=True)
        scored = 0
        for i, g in enumerate(games):
            # only finished games (double pass) get a result: Tromp-Taylor
            # on a move-cap-truncated board would be arbitrary
            s = area_score(g.stones) if g.passes >= 2 else None
            scored += s is not None
            # atomic: selfplay SGFs feed corpus builds; never leave a torn
            # record under the final name
            with atomic_write(os.path.join(args.sgf_out,
                                           f"game_{i:04d}.sgf"),
                              mode="w") as f:
                f.write(to_sgf(g, result=s and s.result_string(),
                               komi=s and s.komi))
        print(f"wrote {len(games)} SGFs ({scored} finished/scored) "
              f"to {args.sgf_out}")


if __name__ == "__main__":
    main()
