"""Generate a synthetic arena corpus at KGS scale.

The 55% KGS top-1 north star needs ~27M human positions that do not exist
in this zero-egress environment (BASELINE.md), so the accuracy axis is
exercised on data the framework generates itself: arena games between the
scripted baselines (HeuristicAgent, OnePlyAgent) plus any checkpoint-backed
agents mixed in via ``--extra``, written as ranked SGFs and pushed through
the same transcription -> shard -> loader -> train pipeline a real corpus
would use. The port's twin of ``tools/make_corpus.py``: with the scripted
pool, ``--positions N --seed S`` writes byte-identical SGFs and shards.

Agent identity is encoded in the dan-rank tags (oneply=8d, heuristic=4d,
``--extra SPEC=RANK`` as given), so the model can condition on "player
strength" through the rank planes exactly like KGS dan ranks. Every
unordered agent pairing (self-pairs included) is cycled for
move-distribution diversity, and colors alternate inside each chunk so
both color assignments occur (match.play_match).

``--opening-plies N`` starts every game from N independent uniformly-
random legal moves (per GAME, not per pair): trajectory diversity is the
difference between a corpus a model saturates at 400k positions and one
where the data axis keeps paying.

``--extra`` agents (``checkpoint:`` / ``search:`` / ...) run their
forwards on ``--device`` (``cuda`` by default); the scripted pool needs no
device.

Usage:
  python -m deepgo_tpu_torch.tools.make_corpus --out data/corpus \
      --positions 5000000
  python -m deepgo_tpu_torch.tools.make_corpus --out data/corpus2 \
      --positions 3400000 --opening-plies 8 \
      --extra search:runs/<id>/checkpoint.npz=9 \
      --extra checkpoint:runs/<id>/checkpoint.npz=6
"""

from __future__ import annotations

import argparse
import os
import time

from .. import arena
from ..selfplay import to_sgf
from ..utils.atomicio import atomic_write

RANK_OF = {"heuristic": 4, "oneply": 8}


def split_of(gid: int) -> str:
    """Deterministic 2% validation / 2% test / 96% train by game id."""
    r = gid % 50
    return {1: "validation", 2: "test"}.get(r, "train")


def build_pool(extra: list[str], seed: int, temperature: float,
               device="cuda") -> dict[str, tuple[arena.Agent, int]]:
    """name -> (agent, rank): the scripted baselines plus --extra specs.

    Each extra is SPEC=RANK (e.g. search:ckpt.npz=9); the spec goes
    through arena._make_agent on ``device``, so every agent family the
    arena knows is available to the generator. Sampling policy agents
    (checkpoint:/model:) get ``temperature`` for extra move diversity; the
    search family ignores it (deterministic re-rankers).
    """
    pool: dict[str, tuple[arena.Agent, int]] = {
        "heuristic": (arena.HeuristicAgent(), RANK_OF["heuristic"]),
        "oneply": (arena.OnePlyAgent(), RANK_OF["oneply"]),
    }
    for i, item in enumerate(extra or []):
        spec, _, rank_s = item.rpartition("=")
        if not (spec and rank_s.isdigit()):
            raise ValueError(f"--extra wants SPEC=RANK, got {item!r}")
        agent = arena._make_agent(spec, seed + 1000 + i, temperature,
                                  int(rank_s), device=device)
        pool[f"x{i}-{agent.name}"] = (agent, int(rank_s))
    return pool


def generate(out: str, target_positions: int, chunk: int, max_moves: int,
             seed: int, opening_plies: int = 0,
             pool: dict[str, tuple[arena.Agent, int]] | None = None) -> dict:
    if pool is None:
        pool = build_pool([], seed, 0.0)
    # strongest first; with the default pool this is the legacy pair cycle
    # [(oneply,oneply), (oneply,heuristic), (heuristic,heuristic)], so
    # `--positions N --seed 0` regenerates the JAX tool's corpus bit-exactly
    names = sorted(pool, key=lambda n: (-pool[n][1], n))
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i:]]
    for split in ("train", "validation", "test"):
        os.makedirs(os.path.join(out, "sgf", split), exist_ok=True)

    totals = {"games": 0, "positions": 0, "truncated": 0}
    t0 = time.time()
    round_idx = 0
    while totals["positions"] < target_positions:
        name_a, name_b = pairs[round_idx % len(pairs)]
        games, scores, stats = arena.play_match(
            pool[name_a][0], pool[name_b][0], n_games=chunk,
            max_moves=max_moves, seed=seed + round_idx,
            opening_plies=opening_plies,
            # per-GAME openings: a deterministic self-pair from a
            # pair-shared opening is the same game twice, and duplicates
            # can straddle the train/validation split downstream
            shared_openings=False)
        totals["truncated"] += stats["truncated"]
        for i, (g, s) in enumerate(zip(games, scores)):
            gid = totals["games"]
            totals["games"] += 1
            totals["positions"] += len(g.moves)
            split = split_of(gid)
            # colors alternate inside play_match: even game index gives
            # black to agent A
            black, white = (name_a, name_b) if i % 2 == 0 else (name_b, name_a)
            done = g.passes >= 2
            path = os.path.join(out, "sgf", split, f"g{gid:07d}.sgf")
            with atomic_write(path, "w") as f:
                f.write(to_sgf(
                    g,
                    black_rank=pool[black][1], white_rank=pool[white][1],
                    result=s.result_string() if done else None, komi=7.5))
        round_idx += 1
        rate = totals["positions"] / (time.time() - t0)
        print(f"{totals['positions']:,}/{target_positions:,} positions "
              f"({totals['games']:,} games, {rate:,.0f} pos/sec)", flush=True)
    totals["gen_seconds"] = time.time() - t0
    return totals


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="data/corpus")
    ap.add_argument("--positions", type=int, default=5_000_000)
    ap.add_argument("--chunk", type=int, default=1024,
                    help="games advanced in lockstep per match call")
    ap.add_argument("--max-moves", type=int, default=350)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--opening-plies", type=int, default=0,
                    help="independent random opening moves per game "
                         "(trajectory diversity; 8 = round-5 recipe)")
    ap.add_argument("--extra", action="append", default=[],
                    help="additional agent as SPEC=RANK (repeatable), e.g. "
                         "search:runs/<id>/checkpoint.npz=9")
    ap.add_argument("--temperature", type=float, default=0.25,
                    help="sampling temperature for checkpoint:/model: "
                         "--extra agents (diversity; search family "
                         "ignores it)")
    ap.add_argument("--transcribe-workers", type=int,
                    default=max(1, (os.cpu_count() or 2) - 1))
    ap.add_argument("--skip-transcribe", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the --extra agents' forwards (cuda or "
                         "cpu)")
    args = ap.parse_args(argv)

    pool = build_pool(args.extra, args.seed, args.temperature,
                      device=args.device)
    print({name: (agent.name, rank) for name, (agent, rank) in pool.items()})
    totals = generate(args.out, args.positions, args.chunk, args.max_moves,
                      args.seed, args.opening_plies, pool)
    print(totals)

    if not args.skip_transcribe:
        from ..data.transcribe import transcribe_split

        for split in ("train", "validation", "test"):
            t0 = time.time()
            n = transcribe_split(
                os.path.join(args.out, "sgf", split),
                os.path.join(args.out, "processed", split),
                workers=args.transcribe_workers, verbose=False)
            print(f"transcribed {split}: {n:,} examples "
                  f"in {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
