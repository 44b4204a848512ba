"""Selfplay actors: the game-producing side of the expert-iteration loop.

The port's copy of ``deepgo_tpu/loop/actors.py``, over the port's
``selfplay.self_play`` (engine path) and rules engine. Each actor plays
rounds of engine-driven selfplay against the serving fleet's ``selfplay``
priority tier and durably ingests every finished game into the replay
buffer. Two properties matter more than raw speed:

  * actors hold NO weights — they submit boards to the shared fleet, so a
    champion hot-reload (``FleetRouter.reload``) retargets every actor's
    very next ply with zero actor-side coordination. The publish
    mechanism is the only weight channel the loop has.
  * actors are crash-disposable — all durable state lives in the buffer.
    A restarted actor replays its interrupted round from the round seed;
    games the buffer already acked stay acked (never lost), games it
    hadn't don't exist yet (never half-ingested).

Training records are produced by replaying the finished game's move list
through the rules engine — the same pre-move-summarize convention as
``go.replay.replay_positions`` and the SGF transcription path, so
buffer-fed training and corpus-fed training see byte-identical features
for the same game.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..data.dataset import META_COLS, RECORD_SHAPE
from ..go import native, new_board, play
from ..go.scoring import area_score
from ..go.summarize import summarize
from ..obs import get_registry
from ..selfplay import GameState, self_play
from .replay import ReplayBuffer


def game_records(game: GameState, black_rank: int = 8,
                 white_rank: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """(packed (M,9,19,19) uint8, meta (M,6) int32) for one finished game.

    Replays the move list from an empty board, summarizing the *pre-move*
    position for each move (passes never enter ``game.moves``, so the
    board — age channel included — evolves exactly as transcription's
    replay does). The game_id column is left 0; the buffer rewrites it
    to the ingest gid at seal time."""
    moves = game.moves
    stones, age = new_board()
    packed = np.empty((len(moves), *RECORD_SHAPE), np.uint8)
    meta = np.empty((len(moves), META_COLS), np.int32)
    for i, m in enumerate(moves):
        packed[i] = (native.summarize_native(stones, age)
                     if native.available() else summarize(stones, age))
        meta[i] = (m.player, m.x, m.y, black_rank, white_rank, 0)
        play(stones, age, m.x, m.y, m.player)
    return packed, meta


class SelfplayActor:
    """One actor: rounds of selfplay over a shared engine, games into the
    buffer. ``engine`` is anything with the InferenceEngine surface — in
    the loop service it is the FleetRouter, so submissions carry the
    fleet's selfplay-tier QoS and pick up champion reloads in place."""

    def __init__(self, actor_id: int, buffer: ReplayBuffer, engine,
                 games_per_round: int = 8, max_moves: int = 120,
                 temperature: float = 0.25, rank: int = 8,
                 komi: float = 7.5, seed: int = 0, metrics=None,
                 search_sims: int = 0):
        self.actor_id = actor_id
        self.buffer = buffer
        self.engine = engine
        self.games_per_round = games_per_round
        self.max_moves = max_moves
        self.temperature = temperature
        self.rank = rank
        self.komi = komi
        self.seed = seed
        self._metrics = metrics
        # search_sims > 0 upgrades the actor to AlphaZero-style
        # search-selfplay: each move is a PUCT search over the same
        # fleet (selfplay tier, root noise + visit temperature), so the
        # expert-iteration corpus is produced by policy+search rather
        # than the raw policy (docs/search.md)
        self.search_sims = search_sims
        self._move_selector = None
        if search_sims > 0:
            from ..search import SearchConfig, make_move_selector

            self._move_selector = make_move_selector(
                engine, SearchConfig(
                    simulations=search_sims, tier="selfplay",
                    rank=rank, max_moves=max_moves, temperature=1.0,
                    root_noise_frac=0.25),
                metrics=metrics)
        self.round = 0          # advances only when a round fully ingests
        self.games_acked = 0
        reg = get_registry()
        self._obs_games = reg.counter(
            "deepgo_loop_games_ingested_total",
            "finished selfplay games durably ingested into the replay "
            "buffer")
        self._obs_positions = reg.counter(
            "deepgo_loop_positions_ingested_total",
            "training positions durably ingested into the replay buffer")

    def run_round(self) -> dict:
        """Play one round of games and ingest every finished one.

        The round seed is a pure function of (actor seed, round index):
        a restarted actor repeats the round it died in rather than
        skipping it, so an ingest crash costs the un-acked remainder of
        one round, never a hole in the schedule."""
        t0 = time.monotonic()
        games, stats = self_play(
            None, None, n_games=self.games_per_round,
            max_moves=self.max_moves, temperature=self.temperature,
            rank=self.rank,
            seed=int(np.random.SeedSequence(
                (self.seed, self.actor_id, self.round)).generate_state(1)[0]),
            engine=self.engine, move_selector=self._move_selector)
        ingested = positions = 0
        for g in games:
            if not g.moves:
                continue  # an immediate double pass carries no training data
            packed, meta = game_records(g, self.rank, self.rank)
            winner = (area_score(g.stones, komi=self.komi).winner
                      if g.passes >= 2 else 0)
            gid = self.buffer.ingest_game(packed, meta, winner=winner,
                                          source=f"actor-{self.actor_id}")
            ingested += 1
            positions += len(g.moves)
            self.games_acked += 1
            self._obs_games.inc(1)
            self._obs_positions.inc(len(g.moves))
            if self._metrics is not None:
                # the lineage chain's leaf: game gid -> its producer.
                # `cli trace RUN_DIR champion` joins these against the
                # seal/window/gate records to answer "which games
                # trained the champion currently serving"
                self._metrics.write(
                    "lineage_game", gid=gid, positions=len(g.moves),
                    winner=winner, source=f"actor-{self.actor_id}",
                    round=self.round)
        record = {
            "actor": self.actor_id,
            "round": self.round,
            "games": ingested,
            "positions": positions,
            "seconds": round(time.monotonic() - t0, 3),
            "positions_per_sec": stats["positions_per_sec"],
        }
        if self._metrics is not None:
            self._metrics.write("loop_actor_round", **record)
        self.round += 1
        return record

    def run_forever(self, stop: threading.Event) -> None:
        """The component body the loop supervisor runs: rounds until
        stopped. Exceptions propagate — restart policy is the
        supervisor's job, not the actor's."""
        while not stop.is_set():
            self.run_round()
