"""Match harness: batched games between two agents, scored, win rates out.

N games advance in lockstep, colors alternate across games (game i gives
black to agent ``i % 2``), each ply batches all boards where a given
agent is to move into one forward on the card (for policy agents) or one
vectorized host step (for baselines), and finished games are
Tromp-Taylor scored (``go.scoring.area_score``) to produce W/L and
margins. The players live in ``agents.py``; ``python -m
deepgo_tpu_torch.arena`` runs the same CLI. The port's twin of
``deepgo_tpu/match.py``: ``play_match`` and ``standard_gate`` are the same
numpy; ``main`` builds its agents on ``--device`` (``cuda`` by default).

Usage:
  python -m deepgo_tpu_torch.match --a checkpoint:runs/<id>/checkpoint.npz \
      --b random --games 64 [--komi 7.5] [--sgf-out arena_games/] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .agents import Agent, _make_agent
from .go import BLACK
from .go.scoring import area_score
from .selfplay import (GameState, legal_mask, step_games, summarize_states,
                       to_sgf)

# The pinned evaluation protocol every strength number in RESULTS.md is
# quoted under ("1,000-game precision"): 1,000 games vs the oneply
# baseline, 8 shared random opening plies per color-swapped pair, seed 29,
# rank plane 8 (the synthetic corpus's strongest tag). One definition —
# standard_gate() below, the arena CLI's --standard-gate, and the shell
# queues (tools/r5_value_loop.sh vmatch) all read these — so the arena
# gatekeeper and the historical match queues can never drift apart.
GATE_GAMES = 1000
GATE_OPENING_PLIES = 8
GATE_SEED = 29
GATE_RANK = 8


def standard_gate(agent_a: Agent, agent_b: Agent, n_games: int = GATE_GAMES,
                  komi: float = 7.5, max_moves: int = 450):
    """``play_match`` under the pinned arena protocol.

    Returns (games, scores, stats) with the protocol recorded in
    ``stats["protocol"]`` and agent A's win rate surfaced as
    ``stats["win_rate_a"]`` (the per-name key play_match emits depends on
    the agent's name; gate consumers want a fixed key). ``n_games`` stays
    overridable — an in-process loop turn gates on a handful of games,
    the production gate keeps the 1,000-game pin — but the opening /
    seed / pairing discipline is not: that is the part that makes two win
    rates comparable."""
    games, scores, stats = play_match(
        agent_a, agent_b, n_games=n_games, komi=komi, max_moves=max_moves,
        seed=GATE_SEED, opening_plies=GATE_OPENING_PLIES,
        shared_openings=True)
    name_a = agent_a.name
    stats["win_rate_a"] = stats[f"{name_a}_win_rate"]
    stats["protocol"] = {"games": n_games, "opening_plies": GATE_OPENING_PLIES,
                         "seed": GATE_SEED, "rank": GATE_RANK,
                         "komi": komi, "max_moves": max_moves}
    return games, scores, stats


def play_match(agent_a: Agent, agent_b: Agent, n_games: int = 32,
               komi: float = 7.5, max_moves: int = 450, seed: int = 0,
               opening_plies: int = 0, shared_openings: bool = True):
    """Run n_games with alternating colors; returns (games, scores, stats).

    Game i gives black to agent_a when i is even. Every active game advances
    one ply per iteration, so all active boards share a side-to-move and each
    agent sees at most one batch per ply.

    ``opening_plies > 0`` starts each game with that many uniformly-random
    legal moves before the agents take over, with games 2i and 2i+1
    SHARING an opening (the color-swapped rematch starts from the same
    position). Two deterministic agents otherwise produce one pair of
    games replicated n_games/2 times — sub-ulp tie-break noise almost
    never flips a trained net's argmax — so a 200-game match carries two
    games' worth of evidence; balanced random openings restore n_games
    distinct trajectories while keeping the color-paired fairness.

    ``shared_openings=False`` draws an independent opening per GAME
    instead of per pair. Win-rate evaluation wants the pair-shared
    default (the color-swapped rematch from the same position is what
    makes the pairing fair); corpus generation wants maximum trajectory
    diversity — a deterministic agent playing itself from a pair-shared
    opening produces the SAME game twice, and the duplicates can
    straddle train/validation splits downstream.
    """
    import sys

    rng = np.random.default_rng(seed)
    games = [GameState() for _ in range(n_games)]
    # black_agent[i] plays BLACK in game i
    agent_of = [(agent_a, agent_b) if i % 2 == 0 else (agent_b, agent_a)
                for i in range(n_games)]
    plies = 0
    t0 = time.time()
    last_report = t0

    while True:
        live = [i for i, g in enumerate(games) if not g.done]
        if not live:
            break
        # long matches (a 1,000-game pin is hours on a host core) print
        # nothing until scoring without this: a heartbeat on stderr keeps
        # the run observable and log-stall supervisors satisfied
        now = time.time()
        if now - last_report > 120:
            last_report = now
            print(f"# match {n_games - len(live)}/{n_games} games done, "
                  f"{plies:,} plies, {plies / (now - t0):.1f} pos/sec",
                  file=sys.stderr, flush=True)
        packed = summarize_states([games[i] for i in live])
        players = np.array([games[i].player for i in live], dtype=np.int32)
        legal = legal_mask(packed, players, [games[i] for i in live])
        plies += len(live)

        moves = np.full(len(live), -1, dtype=np.int64)
        if len(games[live[0]].moves) < opening_plies:
            # balanced random opening: draw one legal point per PAIR and
            # give it to both color assignments (identical positions, so
            # one draw is legal in both)
            u = rng.random(legal.shape)
            pick = np.where(legal, u, -1.0).argmax(axis=1)
            pick = np.where(legal.any(axis=1), pick, -1)
            for j, i in enumerate(live):
                if shared_openings:
                    mate = live.index(i ^ 1) if (i ^ 1) in live else j
                    moves[j] = pick[min(j, mate)]
                else:
                    moves[j] = pick[j]
        else:
            agents = (agent_a,) if agent_b is agent_a else (agent_a, agent_b)
            for agent in agents:
                sel = [j for j, i in enumerate(live)
                       if agent_of[i][games[i].player - 1] is agent]
                if sel:
                    moves[sel] = agent.select_moves(
                        packed[sel], players[sel], legal[sel], rng)

        step_games([games[i] for i in live], moves.tolist(), max_moves)

    scores = [area_score(g.stones, komi=komi) for g in games]
    dt = time.time() - t0

    a_wins = b_wins = draws = 0
    a_black_wins = 0
    margins = []
    for i, s in enumerate(scores):
        winner = s.winner
        black, white = agent_of[i]
        margins.append(s.margin if black is agent_a else -s.margin)
        if winner == 0:
            draws += 1
        elif (black if winner == BLACK else white) is agent_a:
            a_wins += 1
            if winner == BLACK and black is agent_a:
                a_black_wins += 1
        else:
            b_wins += 1
    name_a = agent_a.name
    name_b = agent_b.name if agent_b.name != name_a else agent_b.name + "-b"
    # area-scoring a move-cap-truncated board is an approximation; surface
    # how much of the result rests on it so win-rate consumers can judge
    truncated = sum(1 for g in games if g.passes < 2)
    stats = {
        "games": n_games,
        "truncated": truncated,
        f"{name_a}_wins": a_wins,
        f"{name_b}_wins": b_wins,
        "draws": draws,
        f"{name_a}_win_rate": a_wins / n_games,
        f"{name_a}_wins_as_black": a_black_wins,
        "mean_margin_for_a": float(np.mean(margins)),
        "plies": plies,
        "seconds": dt,
        "positions_per_sec": plies / dt,
    }
    return games, scores, stats


def main(argv=None) -> None:
    import os

    from .utils.atomicio import atomic_write

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", default="model:small", help="agent A spec")
    ap.add_argument("--b", default="random", help="agent B spec")
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--komi", type=float, default=7.5)
    ap.add_argument("--max-moves", type=int, default=450)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="softmax sampling temperature for checkpoint:/model: "
                         "policy agents (0 = argmax; >0 diversifies "
                         "policy-vs-policy games); search: agents stay "
                         "deterministic regardless")
    ap.add_argument("--rank", type=int, default=9,
                    help="dan rank fed to policy agents' rank planes; match "
                         "the training corpus (e.g. 8 for the synthetic "
                         "corpus, whose strongest games are tagged 8d)")
    ap.add_argument("--opening-plies", type=int, default=0,
                    help="start each game pair from this many shared "
                         "uniformly-random legal moves — restores distinct "
                         "trajectories in deterministic-vs-deterministic "
                         "matches (the color-swapped rematch shares the "
                         "opening, keeping the pairing fair)")
    ap.add_argument("--standard-gate", action="store_true",
                    help="apply the pinned arena protocol (the RESULTS.md "
                         "'1,000-game precision' pins shared with the "
                         "expert-iteration gatekeeper): --b oneply, "
                         f"--games {GATE_GAMES}, --opening-plies "
                         f"{GATE_OPENING_PLIES}, --seed {GATE_SEED}, "
                         f"--rank {GATE_RANK}; explicit --games/--b win "
                         "over the defaults, the protocol pins do not")
    ap.add_argument("--search-sims", type=int, default=128, metavar="N",
                    help="simulation budget for mcts: agents "
                         "(search/): the pinned per-move PUCT "
                         "budget the Elo gate quotes — "
                         "'--a mcts:P.npz:V.npz --b value2:P.npz:V.npz "
                         "--standard-gate --search-sims 128' is the "
                         "search-vs-shallow gate")
    ap.add_argument("--sgf-out", help="directory to write scored games")
    ap.add_argument("--engine", action="store_true",
                    help="route net-backed agents through the shared "
                         "micro-batching inference engine "
                         "(serving/): both sides of a match "
                         "built from the same checkpoint coalesce into "
                         "the same padded dispatches")
    ap.add_argument("--supervised", action="store_true",
                    help="like --engine, but the shared engines run under "
                         "the resilience supervisor: dispatcher-death "
                         "auto-restart with replay, batch-poison "
                         "isolation, circuit breaker, deadline shedding")
    ap.add_argument("--fleet", type=int, default=1, metavar="N",
                    help="like --supervised, but the shared engines become "
                         "a FleetRouter of N supervised replicas: "
                         "least-wait placement, failover with exclusion, "
                         "background respawn, tiered QoS")
    ap.add_argument("--variant-a", default="f32", metavar="V",
                    help="serving variant for agent A's policy forward "
                         "(f32 | int8 | sym | int8+sym — serving/"
                         "variants.py). The live quantization A/B: "
                         "'--a checkpoint:C --variant-a int8 --b "
                         "checkpoint:C' gates the int8 champion against "
                         "the f32 one under the pinned protocol; lossy "
                         "variants tolerance-verify before serving and "
                         "imply --engine")
    ap.add_argument("--variant-b", default="f32", metavar="V",
                    help="serving variant for agent B's policy forward")
    ap.add_argument("--device", default="cuda",
                    help="where net-backed agents run: cuda (default; "
                         "raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    if args.standard_gate:
        # the protocol pins are not negotiable under --standard-gate (they
        # are what makes the number comparable to every RESULTS.md rung);
        # the opponent and game count keep their explicit overrides so a
        # smoke run can gate 32 games against a different baseline
        args.rank = GATE_RANK
        args.seed = GATE_SEED
        args.opening_plies = GATE_OPENING_PLIES
        if args.b == ap.get_default("b"):
            args.b = "oneply"
        if args.games == ap.get_default("games"):
            args.games = GATE_GAMES

    use_engine = ("supervised" if args.supervised
                  else args.engine or args.fleet > 1
                  or args.variant_a != "f32" or args.variant_b != "f32")
    agent_a = _make_agent(args.a, args.seed, args.temperature, args.rank,
                          use_engine=use_engine, fleet=args.fleet,
                          variant=args.variant_a,
                          search_sims=args.search_sims, device=args.device)
    agent_b = _make_agent(args.b, args.seed + 1, args.temperature, args.rank,
                          use_engine=use_engine, fleet=args.fleet,
                          variant=args.variant_b,
                          search_sims=args.search_sims, device=args.device)
    # distinct names keep the A/B's win-rate keys readable when both
    # sides are the same checkpoint under different serving variants
    if args.variant_a != "f32":
        agent_a.name = f"{agent_a.name}+{args.variant_a}"
    if args.variant_b != "f32":
        agent_b.name = f"{agent_b.name}+{args.variant_b}"
    try:
        games, scores, stats = play_match(
            agent_a, agent_b, n_games=args.games, komi=args.komi,
            max_moves=args.max_moves, seed=args.seed,
            opening_plies=args.opening_plies)
    finally:
        if use_engine:
            from .serving import close_shared_engines

            close_shared_engines()
    print({k: round(v, 3) if isinstance(v, float) else v
           for k, v in stats.items()})

    if args.sgf_out:
        os.makedirs(args.sgf_out, exist_ok=True)
        finished = 0
        for i, (g, s) in enumerate(zip(games, scores)):
            # RE[] only for games that ended on double pass; a move-cap
            # truncation is scored for the stats table (standard
            # approximation) but not stamped into the record
            done = g.passes >= 2
            finished += done
            # atomic: a kill mid-write must not leave a torn SGF that a
            # later corpus build half-parses
            with atomic_write(os.path.join(args.sgf_out,
                                           f"match_{i:04d}.sgf"),
                              mode="w") as f:
                f.write(to_sgf(g, result=s.result_string() if done else None,
                               komi=args.komi))
        print(f"wrote {len(games)} SGFs ({finished} finished/scored, "
              f"{len(games) - finished} move-cap truncated) to {args.sgf_out}")


if __name__ == "__main__":
    main()
