"""Instrumented TwoPly-vs-PolicySearch mini-match: why is head-to-head 0-200?

Counts, per ply: how often the differential veto fires, what it fires on
(tact/threat of policy move vs chosen), and pass decisions. The port's twin
of ``tools/debug_twoply.py``; both agents' forwards run on ``--device``
(``cuda`` by default), and ``--max-moves`` caps each game (450, the match
harness's default, as the JAX tool plays).

Usage:
  python -m deepgo_tpu_torch.tools.debug_twoply \
      --ckpt runs/<id>/checkpoint.npz [--games 16] [--device cpu]
"""

import argparse

import numpy as np

from .. import arena


class DebugTwoPly(arena.TwoPlyAgent):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.stats = dict(plies=0, boards=0, fired=0, passed=0, urgent=0,
                          fire_tact=[])

    def select_moves(self, packed, players, legal, rng):
        moves = super().select_moves(packed, players, legal, rng)
        # re-derive the internals for accounting (cheap at debug scale);
        # report the REALIZED gain the agent scores with (no speculative
        # save credit), not _oneply_scores' save-inflated tact
        legal2 = arena._no_own_eyes(packed, players, legal)
        logp = self._legal_log_probs(packed, players, legal2)
        my_kills, _, my_libs, opp_libs, ladders = arena._tactical_grids(
            packed, players)
        tact1 = (arena.W_KILL * my_kills + arena.W_LADDER * ladders
                 + arena.W_LIB * my_libs + arena.W_OPP_LIB * opp_libs
                 - arena.W_SELF_ATARI * (my_libs <= 1))
        _, forcing1 = arena._oneply_scores(packed, players)
        any_legal = legal2.any(axis=1)
        policy_move = np.where(any_legal, logp.argmax(axis=1), -1)
        n = len(packed)
        self.stats["plies"] += 1
        self.stats["boards"] += n
        self.stats["passed"] += int((moves == -1).sum())
        self.stats["urgent"] += int(
            (legal2 & (forcing1 >= self.urgent)).any(axis=1).sum())
        fired = (moves != policy_move) & (moves != -1)
        self.stats["fired"] += int(fired.sum())
        for i in np.nonzero(fired)[0][:3]:
            self.stats["fire_tact"].append(
                (int(tact1[i, moves[i]]), int(tact1[i, policy_move[i]])))
        return moves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--games", type=int, default=16)
    ap.add_argument("--max-moves", type=int, default=450)
    ap.add_argument("--device", default="cuda",
                    help="device of both agents' forwards (cuda or cpu)")
    args = ap.parse_args(argv)

    from ..models.serving import load_policy

    _, params, cfg = load_policy(args.ckpt, device=args.device)
    two = DebugTwoPly(params, cfg, rank=8, device=args.device)
    one = arena.PolicySearchAgent(params, cfg, rank=8, device=args.device)
    games, scores, stats = arena.play_match(two, one, n_games=args.games,
                                            max_moves=args.max_moves, seed=11)
    print({k: v for k, v in stats.items()})
    s = two.stats
    print(f"twoply: {s['boards']} boards over {s['plies']} plies; "
          f"fired {s['fired']} ({s['fired']/max(1,s['boards']):.1%}), "
          f"passed {s['passed']}, urgent-boards {s['urgent']} "
          f"({s['urgent']/max(1,s['boards']):.1%})")
    print("sample fired (tact_chosen, tact_policy):", s["fire_tact"][:20])
    # a couple of final positions' last moves for eyeballing
    g = games[0]
    print("game0 moves tail:", g.moves[-12:], "passes", g.passes,
          "done", g.done)


if __name__ == "__main__":
    main()
