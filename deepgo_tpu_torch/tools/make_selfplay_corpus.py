"""Generate a ranked corpus from arbitrary agent pairings (self-play loop).

Where ``make_corpus`` fixes the scripted-baseline pairings, this one takes
agent SPECS (match/agents ``_make_agent`` syntax: oneply | heuristic |
random | checkpoint:PATH | search:PATH | model:NAME) so a TRAINED policy
can generate its own next training corpus — the data side of the
imitation -> outcome-conditioned -> self-play improvement loop. Games are
written as SGFs with the given dan-rank tags and split train/validation/
test by game id exactly like make_corpus, then transcribed through the
same shard pipeline. The port's twin of ``tools/make_selfplay_corpus.py``;
net-backed agents run on ``--device`` (``cuda`` by default).

Usage:
  python -m deepgo_tpu_torch.tools.make_selfplay_corpus --out data/iter1 \
      --pairs "checkpoint:runs/X/checkpoint.npz,oneply" \
              "checkpoint:runs/X/checkpoint.npz,checkpoint:runs/X/checkpoint.npz" \
      --games 2048 --temperature 0.25 --rank 8
"""

from __future__ import annotations

import argparse
import os
import time

from .. import arena
from ..selfplay import to_sgf
from ..utils.atomicio import atomic_write
from .make_corpus import split_of


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--pairs", nargs="+", required=True,
                    help="comma-separated agent-spec pairs, cycled per chunk")
    ap.add_argument("--games", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--max-moves", type=int, default=350)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.25,
                    help="sampling temperature for checkpoint:/model: agents "
                         "(diversifies otherwise-deterministic games)")
    ap.add_argument("--opening-plies", type=int, default=0,
                    help="start each GAME from this many independent "
                         "uniformly-random plies (per-game, not the "
                         "pair-shared match openings). Search agents "
                         "(search:/search2:/value:) are deterministic and "
                         "ignore temperature, so without openings a "
                         "self-pair chunk collapses to one game duplicated "
                         "chunk-size times")
    ap.add_argument("--rank", type=int, default=8,
                    help="dan-rank tag for policy agents (baselines keep "
                         "their make_corpus tags: oneply=8, heuristic=4)")
    ap.add_argument("--skip-transcribe", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the net-backed agents (cuda or cpu)")
    args = ap.parse_args(argv)

    baseline_rank = {"oneply": 8, "heuristic": 4, "random": 1}
    pairs = [tuple(p.split(",")) for p in args.pairs]
    if not all(len(p) == 2 for p in pairs):
        raise ValueError("each --pairs entry is 'specA,specB'")
    agents: dict[str, arena.Agent] = {}
    deterministic_prefixes = ("search:", "search2:", "value:", "value2:")
    for spec in {s for p in pairs for s in p}:
        # search-family agents are deterministic re-rankers; _make_agent
        # never forwards a temperature to them, so the 0.0 pin documents
        # at the call site that these agents play greedily
        temp = 0.0 if spec in baseline_rank \
            or spec.startswith(deterministic_prefixes) else args.temperature
        agents[spec] = arena._make_agent(spec, args.seed, temp, args.rank,
                                         device=args.device)

    def rank_of(spec: str) -> int:
        return baseline_rank.get(spec, args.rank)

    for split in ("train", "validation", "test"):
        os.makedirs(os.path.join(args.out, "sgf", split), exist_ok=True)

    totals = {"games": 0, "positions": 0, "truncated": 0}
    t0 = time.time()
    round_idx = 0
    while totals["games"] < args.games:
        spec_a, spec_b = pairs[round_idx % len(pairs)]
        n = min(args.chunk, args.games - totals["games"])
        games, scores, stats = arena.play_match(
            agents[spec_a], agents[spec_b], n_games=n,
            max_moves=args.max_moves, seed=args.seed + round_idx,
            # per-game openings: a corpus wants trajectory diversity, not
            # the pair-fairness of a win-rate match (play_match docstring)
            opening_plies=args.opening_plies, shared_openings=False)
        totals["truncated"] += stats["truncated"]
        for i, (g, s) in enumerate(zip(games, scores)):
            gid = totals["games"]
            totals["games"] += 1
            totals["positions"] += len(g.moves)
            black, white = (spec_a, spec_b) if i % 2 == 0 else (spec_b, spec_a)
            done = g.passes >= 2
            path = os.path.join(args.out, "sgf", split_of(gid),
                                f"g{gid:07d}.sgf")
            with atomic_write(path, "w") as f:
                f.write(to_sgf(
                    g, black_rank=rank_of(black), white_rank=rank_of(white),
                    result=s.result_string() if done else None, komi=7.5))
        round_idx += 1
        rate = totals["positions"] / (time.time() - t0)
        print(f"{totals['games']:,}/{args.games:,} games "
              f"({totals['positions']:,} positions, {rate:,.0f} pos/sec)",
              flush=True)
    print(totals)

    if not args.skip_transcribe:
        from ..data.transcribe import transcribe_split

        for split in ("train", "validation", "test"):
            n = transcribe_split(
                os.path.join(args.out, "sgf", split),
                os.path.join(args.out, "processed", split),
                workers=max(1, (os.cpu_count() or 2) - 1), verbose=False)
            print(f"transcribed {split}: {n:,} examples", flush=True)


if __name__ == "__main__":
    main()
