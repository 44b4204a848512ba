"""Agent zoo: batched move selection for matches, self-play, and corpora.

The reference paper's headline evaluation is win rate of the raw policy
net against an opponent (97% vs GnuGo, README.md:5 / arXiv:1412.6564).
These are the players that evaluation machinery (``match.py``) runs:
scripted baselines (random / capture-greedy heuristic / 1-ply tactical),
the trained policy net, and the search family that uses the policy as a
pruning prior (1-ply tactical veto, realized-outcome 2-ply, value-net
guided) — each selecting moves for a whole fleet of boards per call, one
forward on the card per ply for the net-backed agents.

The port's twin of ``deepgo_tpu/agents.py``: the selection logic is the
same numpy; the forwards are the port's (``models/serving.py``, the
expansion kernel on the card), and every net-backed agent and
``_make_agent`` run on ``device`` (``cuda`` unless the caller asks for the
CPU; without CUDA they raise). ``checkpoint:`` / ``search:`` /
``search2:`` / ``value:`` / ``value2:`` / ``mcts:`` specs read checkpoints
the JAX package wrote. ``model:NAME`` draws random weights from a seeded
``torch.Generator``, which does not give the JAX package's weights for the
same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from .features import P_KILLS, P_LIB_AFTER
from .models import policy_cnn
from .selfplay import batched_log_probs, legal_mask, select_from_log_probs


class Agent:
    """Batched move selection: packed boards in, move indices out (-1 = pass)."""

    name = "agent"

    def select_moves(self, packed: np.ndarray, players: np.ndarray,
                     legal: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


def _no_own_eyes(packed, players, legal):
    """Mask single-point own eyes (all 4 neighbors own stones) from legal.

    Without this, stone-placing baselines fill their own territory forever
    and every game truncates at the move cap; with it they run out of
    sensible moves, pass, and games end properly for scoring (the standard
    naive-rollout eye rule; diagonals deliberately ignored).
    """
    from .features import P_STONES

    n = len(packed)
    stones = packed[:, P_STONES].astype(np.int8)
    own = stones == players[:, None, None]
    # a padded neighbor counts as "own" so edge/corner eyes are masked too
    padded = np.ones((n, 21, 21), dtype=bool)
    padded[:, 1:20, 1:20] = own
    eye = (padded[:, :19, 1:20] & padded[:, 2:, 1:20]
           & padded[:, 1:20, :19] & padded[:, 1:20, 2:])
    return legal & ~eye.reshape(n, -1)


def _argmax_random_tiebreak(score: np.ndarray, legal: np.ndarray,
                            rng: np.random.Generator) -> np.ndarray:
    """Per-row argmax of integer ``score`` over ``legal`` points, ties
    broken uniformly, -1 where nothing is legal — vectorized.

    Adding iid U(0,1) noise to integer-valued scores keeps the order
    between distinct scores (gaps >= 1) while the argmax over a tie set
    follows the noise alone, i.e. uniform over the ties — one argmax for
    the whole batch instead of a flatnonzero + rng.choice Python loop per
    game (the hot loop once move application went native).
    """
    noisy = np.where(legal, score.astype(np.float64) + rng.random(score.shape),
                     -np.inf)
    moves = noisy.argmax(axis=1)
    return np.where(legal.any(axis=1), moves, -1)


class RandomAgent(Agent):
    name = "random"

    def select_moves(self, packed, players, legal, rng):
        legal = _no_own_eyes(packed, players, legal)
        return _argmax_random_tiebreak(
            np.zeros(legal.shape, dtype=np.int64), legal, rng)


class HeuristicAgent(Agent):
    """Capture-greedy: max kills, then max liberties-after, random tie-break."""

    name = "heuristic"

    def select_moves(self, packed, players, legal, rng):
        legal = _no_own_eyes(packed, players, legal)
        n = len(packed)
        idx = np.arange(n)
        kills = packed[idx, P_KILLS + players - 1].reshape(n, -1).astype(np.int64)
        libs = packed[idx, P_LIB_AFTER + players - 1].reshape(n, -1).astype(np.int64)
        # lexicographic (kills, libs, random tie-break) over legal points
        return _argmax_random_tiebreak((kills << 20) + (libs << 10), legal, rng)


class OnePlyAgent(Agent):
    """1-ply lookahead over every packed tactical channel.

    Stronger than HeuristicAgent (71.5% head-to-head over 200 games,
    seed 7, 6 truncated — RESULTS.md win-rate table; tests/test_arena.py
    checks the vs-random floor): for each legal point it weighs, from the
    to-move player's perspective,
      * stones captured by playing there (P_KILLS, own channel),
      * stones SAVED by playing there — the opponent's capture count at the
        same point (P_KILLS, opponent channel): occupying it denies the
        capture,
      * working ladder captures (P_LADDERS, own channel),
      * own liberties after the move, with a self-atari penalty
        (P_LIB_AFTER own channel <= 1), and
      * denial of high-liberty points to the opponent (P_LIB_AFTER,
        opponent channel).
    This is exactly the evaluation a 1-ply search over the feature
    extractor's hypothetical-play data supports (reference
    count_kills_and_liberties, makedata.lua:304-327) without replaying
    moves; the round-1 verdict asked for it as an informative third
    baseline (GnuGo is unavailable: zero egress).
    """

    name = "oneply"

    def select_moves(self, packed, players, legal, rng):
        legal = _no_own_eyes(packed, players, legal)
        return _argmax_random_tiebreak(_oneply_scores(packed, players)[0],
                                       legal, rng)


# Tactical tier weights, shared by every scoring agent (OnePly, veto,
# 2-ply). One table so the agents' arithmetic cannot desynchronize — the
# 2-ply differential in particular relies on W_KILL being identical in
# its gain and threat terms.
W_KILL = 1000      # per stone captured by playing here
W_SAVE = 700       # per own stone the opponent could capture here (1-ply
#                    speculative save credit; TwoPlyAgent deliberately
#                    scores saves through the threat delta instead)
W_LADDER = 400     # per stone capturable via a working ladder from here
W_LIB = 12         # own liberties after playing here
W_OPP_LIB = 6      # opponent liberties denied
W_SELF_ATARI = 900 # penalty for leaving own chain at <= 1 liberty


def _tactical_grids(packed: np.ndarray, players: np.ndarray):
    """The five (n, 361) int64 planes every tactical score derives from:
    (my_kills, opp_kills, my_libs, opp_libs, my_ladders), each read from
    the summarizer's per-player channels for the side to move."""
    from .features import P_LADDERS

    n = len(packed)
    idx = np.arange(n)
    mine, theirs = players - 1, 2 - players
    flat = lambda ch: packed[idx, ch].reshape(n, -1).astype(np.int64)  # noqa: E731
    return (flat(P_KILLS + mine), flat(P_KILLS + theirs),
            flat(P_LIB_AFTER + mine), flat(P_LIB_AFTER + theirs),
            flat(P_LADDERS + mine))


def _oneply_scores(packed: np.ndarray, players: np.ndarray,
                   grids=None) -> tuple[np.ndarray, np.ndarray]:
    """OnePlyAgent's tactical evaluation as two (n, 361) int64 grids.

    Returns ``(score, forcing)``: the full evaluation, and its
    capture/save/ladder component alone — the part that identifies a
    genuinely forcing move, free of the positional liberty terms (which
    can reach hundreds next to a big group). Shared by OnePlyAgent
    (argmax of ``score`` over all legal points) and PolicySearchAgent
    (re-ranking of policy candidates; urgency from ``forcing``). Pass
    ``grids`` (a ``_tactical_grids`` result) to reuse planes the caller
    already extracted."""
    my_kills, opp_kills, my_libs, opp_libs, ladders = (
        grids if grids is not None else _tactical_grids(packed, players))
    forcing = W_KILL * my_kills + W_SAVE * opp_kills + W_LADDER * ladders
    score = (forcing + W_LIB * my_libs + W_OPP_LIB * opp_libs
             - W_SELF_ATARI * (my_libs <= 1))
    return score, forcing


class PolicyAgent(Agent):
    """The trained CNN, one batched forward on ``device`` per ply.

    ``engine`` (a serving.InferenceEngine over the same params) reroutes
    inference through the shared micro-batching engine: this agent's
    batch dissolves into per-board requests that coalesce with every
    other submitter's — both sides of a self-match, a selfplay fleet, an
    eval frontend — into one saturated padded dispatch. Without an
    engine the agent pads its own batch onto the bucket ladder directly
    (same shapes, the same rows at each rung, no dispatcher thread).
    ``params`` is a ``PolicyCNN`` of ``cfg`` on ``device``.
    """

    def __init__(self, params, cfg: policy_cnn.ModelConfig, name: str = "policy",
                 temperature: float = 0.0, pass_threshold: float = 1e-4,
                 rank: int = 9, engine=None, device="cuda"):
        from .models.serving import make_policy_fn

        self.params = params
        self.cfg = cfg
        self.name = name
        self.temperature = temperature
        self.pass_threshold = pass_threshold
        self.rank = rank
        self.engine = engine
        self.device = device
        self._predict = make_policy_fn(cfg, top_k=1, device=device)

    def _legal_log_probs(self, packed, players, legal) -> np.ndarray:
        """One batched forward -> log-probs with illegal points at -inf."""
        ranks = np.full(len(packed), self.rank, dtype=np.int32)
        if self.engine is not None:
            logp = self.engine.evaluate(packed, players, ranks)
        else:
            logp = batched_log_probs(self._predict, self.params, packed,
                                     players, ranks)
        return np.where(legal, logp, -np.inf)

    def select_moves(self, packed, players, legal, rng):
        logp = self._legal_log_probs(packed, players, legal)
        moves = np.full(len(packed), -1, dtype=np.int64)
        for i in range(len(packed)):
            moves[i] = select_from_log_probs(logp[i], self.temperature,
                                             self.pass_threshold, rng)
        return moves


class PolicySearchAgent(PolicyAgent):
    """Policy move with a tactical veto — the policy/search combine.

    On a quiet board the agent plays the net's argmax move unchanged. Only
    when a FORCING move exists — the capture/save/ladder component of the
    1-ply evaluation (``_oneply_scores``, positional liberty terms
    excluded) reaches ``urgent`` (default 400: a working ladder or
    better) — does the tactical evaluation take over: the forcing moves
    plus the policy's ``top_k`` candidates are re-ranked by tactical
    score, with the policy probability as tie-break (tactical tiers are
    integers >= 1 apart; a probability in (0, 1] never reorders distinct
    tiers). A live forcing move also vetoes the pass rule; otherwise the
    agent passes exactly when the net's best eye-masked legal move falls
    below ``pass_threshold``.

    Deferring to tactics ONLY on forcing boards is load-bearing:
    re-ranking every move imposes the 1-ply searcher's own style and
    drags a policy that already beats it back toward its level (measured
    60.5% -> 51.0% vs oneply for the winner-fine-tuned net), while the
    veto design preserves the policy's play and only patches its
    blunders (60.5% -> 69.5%; and it lifts a weak pure imitator from
    2.5% -> 45.5% — RESULTS.md win-rate tables, which also state the
    ±~4-point tie-break/binomial noise at 200 games).

    The agent is deterministic given the position; ``rng`` only breaks
    exact score ties, so ``--temperature`` is rejected for ``search:``
    specs rather than silently ignored. This is the cheapest instance of
    the policy-guides-search pattern the paper points at
    (arXiv:1412.6564 §Conclusion: the policy net as a search prior); one
    forward plus one vectorized host check per ply, no tree.
    """

    def __init__(self, params, cfg, name: str = "policy-search",
                 top_k: int = 8, urgent: int = 400, **kw):
        if kw.get("temperature", 0.0):
            raise ValueError("PolicySearchAgent is a deterministic "
                             "re-ranker; temperature is not supported")
        super().__init__(params, cfg, name=name, **kw)
        self.top_k = top_k
        self.urgent = urgent

    def select_moves(self, packed, players, legal, rng):
        legal = _no_own_eyes(packed, players, legal)
        logp = self._legal_log_probs(packed, players, legal)
        tact, forcing = _oneply_scores(packed, players)
        urgent = legal & (forcing >= self.urgent)
        has_urgent = urgent.any(axis=1)
        moves = np.where(legal.any(axis=1), logp.argmax(axis=1), -1)
        if has_urgent.any():
            # re-rank only the rows with a live forcing move — most Go
            # positions are quiet, so the partition/exp work is skipped
            # for the typical all-quiet ply
            cand = _topk_mask(logp, legal, self.top_k) | urgent
            # prob in (0, 1] breaks tactical ties without reordering
            # integer tiers; sub-ulp rng noise breaks exact ties uniformly
            prob = np.exp(logp) + rng.random(logp.shape) * 1e-9
            score = np.where(cand, tact.astype(np.float64) + prob, -np.inf)
            rerank = np.where(cand.any(axis=1), score.argmax(axis=1), -1)
            moves = np.where(has_urgent, rerank, moves)
        # pass when the policy itself would (best legal move below the
        # pass threshold) — unless something forcing is on the board
        best_p = np.exp(logp.max(axis=1, initial=-np.inf))
        do_pass = (best_p < self.pass_threshold) & ~has_urgent
        return np.where(do_pass, -1, moves)


def _topk_mask(logp: np.ndarray, legal: np.ndarray, top_k: int) -> np.ndarray:
    """(n, 361) bool: the top-k log-prob legal points per row. Rows with
    fewer than k legal moves get a kth value of -inf, which admits every
    legal move — the right degradation. Shared by the 1-ply re-ranker and
    the 2-ply candidate set so the rule cannot drift between them."""
    k = min(top_k, logp.shape[1])
    kth = np.partition(logp, -k, axis=1)[:, -k][:, None]
    return legal & (logp >= kth)


def _apply_and_summarize(stones: np.ndarray, age: np.ndarray,
                         moves: np.ndarray, players: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Apply one move per board in place; return (new packed, ko points).

    Native batched path when the C++ engine is loaded (one FFI crossing for
    the whole fleet); otherwise the tested Python GameState/apply_move
    logic per board. ko[i] is the flat index banned for the opponent's
    immediate recapture, -1 if none.
    """
    from .go import native

    if native.batch_available():
        ko = native.play_batch_native(stones, age, moves, players)
        return native.summarize_batch_native(stones, age), ko
    from .selfplay import GameState, apply_move, summarize_state

    ko = np.full(len(moves), -1, dtype=np.int32)
    packed = np.empty((len(moves), 9, 19, 19), dtype=np.uint8)
    for i in range(len(moves)):
        g = GameState()
        g.stones[:], g.age[:], g.player = stones[i], age[i], int(players[i])
        apply_move(g, *divmod(int(moves[i]), 19))
        stones[i], age[i] = g.stones, g.age
        if g.ko_point is not None:
            ko[i] = g.ko_point[0] * 19 + g.ko_point[1]
        packed[i] = summarize_state(g)
    return packed, ko


def _play_candidates(packed, players, legal, logp, forcing, top_k,
                     urgent_threshold):
    """Candidate set + played after-boards, shared by every deep searcher.

    Returns ``(urgent, cand, rows, cols, after, ko)``: the forcing-point
    mask, the candidate mask (policy top-k | urgent), the candidates in
    nonzero order, and each candidate's after-board + ko point (``after``
    is None when no board has a candidate). One definition so the
    candidate-set rule cannot drift between search agents.
    """
    from .features import P_AGE, P_STONES

    urgent = legal & (forcing >= urgent_threshold)
    cand = _topk_mask(logp, legal, top_k) | urgent
    rows, cols = np.nonzero(cand)
    if rows.size == 0:
        return urgent, cand, rows, cols, None, None
    stones = packed[rows, P_STONES].astype(np.uint8).copy()
    age = packed[rows, P_AGE].astype(np.int32)
    after, ko = _apply_and_summarize(stones, age, cols.astype(np.int32),
                                     players[rows].astype(np.int32))
    return urgent, cand, rows, cols, after, ko


def _veto_select(logp, legal, cand, rows, cols, cand_scores, margin, urgent,
                 pass_threshold, rng, tie_scale=1.0):
    """Differential-veto move selection, shared by every deep searcher.

    ``cand_scores`` aligns with (rows, cols). The policy argmax is kept
    unless some candidate beats ITS score by ``margin``; the pass rule is
    PolicySearchAgent's (policy below threshold, nothing forcing, veto not
    firing). ``tie_scale`` sizes the policy-prob tie-break relative to the
    score units (1.0 for integer tactical tiers, sub-margin for win-prob
    scores).
    """
    n, p = logp.shape
    any_legal = legal.any(axis=1)
    policy_move = np.where(any_legal, logp.argmax(axis=1), -1)
    score = np.full((n, p), -np.inf)
    score[rows, cols] = cand_scores
    score += np.where(cand,
                      tie_scale * (np.exp(logp) + rng.random(logp.shape)
                                   * 1e-9),
                      0.0)
    best = score.argmax(axis=1)
    best_val = score.max(axis=1)
    pol_val = np.where(any_legal, score[np.arange(n), policy_move], -np.inf)
    fire = any_legal & (best_val >= pol_val + margin)
    moves = np.where(fire, best, policy_move)
    # pass exactly when PolicySearchAgent would: policy below the pass
    # threshold AND nothing forcing on the board AND no override. Without
    # the urgency veto, a settled endgame whose argmax IS a live capture
    # would pass over dead stones and hand them to the opponent under
    # area scoring.
    best_p = np.exp(logp.max(axis=1, initial=-np.inf))
    do_pass = (best_p < pass_threshold) & ~fire & ~urgent.any(axis=1)
    return np.where(do_pass, -1, moves)


class TwoPlyAgent(PolicySearchAgent):
    """Policy-pruned 2-ply search: candidates from the net, replies refuted.

    The expert-iteration study (RESULTS.md) showed the strength loop
    saturating because the 1-ply veto expert caps what distillation can
    teach; this agent is the next expert up. Per board it

      1. takes the policy's ``top_k`` moves plus every live forcing move as
         the candidate set (the policy as search prior, arXiv:1412.6564
         §Conclusion — the same pruning role the paper projects),
      2. PLAYS each candidate on a copy of the board (batched native move
         application across the whole fleet x candidate set), and
      3. scores it by REALIZED outcome: the captures/ladders/liberty shape
         the move itself achieves, minus the material the opponent's best
         reply takes on the resulting board (immediate captures + working
         ladders, ko-banned reply excluded) — so snapbacks, self-ataris
         beyond the immediate stone, and captures that hand back a bigger
         recapture are all seen, which the purely-static OnePlyAgent
         cannot do (reference analogue: count_kills_and_liberties,
         makedata.lua:304-327, is exactly one hypothetical ply deep).

    Deliberately NOT in a candidate's own gain: the 1-ply 700-point
    "save" term (``_oneply_scores``' opponent-kills channel). A save is
    speculative — it only worked if the capture threat is actually gone
    from the after-board, which is exactly what the threat term measures.
    Crediting saves up front made the first build of this agent chase
    doomed groups (save k stones -> still capturable as k+1 -> save again
    ...), escalating the horizon effect until it lost every head-to-head
    game against the 1-ply veto agent with half the matches hitting the
    move cap (0/200, measured round 4). Under realized-outcome scoring a
    futile save scores ~-1000(k+1) while the quiet policy move scores
    ~-1000k: giving the group up is correctly preferred, and a WORKING
    save (threat drops to zero) fires on its own merits. Pre-existing
    threats cancel out of the differential veto entirely — both sides of
    the comparison face the same standing board.

    The policy keeps the move unless its own candidate is REFUTED: the best
    candidate must beat the policy move's 2-ply score by ``margin``
    (default 500, half a capture tier) for the search to take over. This
    differential veto generalizes round 3's forcing-move veto — blanket
    re-ranking measurably drags a strong policy down to its evaluator's
    level (RESULTS.md), so the agent only overrides on a demonstrated
    tactical blunder.
    """

    name = "twoply-search"

    def __init__(self, params, cfg, name: str = "twoply-search",
                 margin: int = 500, **kw):
        super().__init__(params, cfg, name=name, **kw)
        self.margin = margin

    def select_moves(self, packed, players, legal, rng):
        legal = _no_own_eyes(packed, players, legal)
        logp = self._legal_log_probs(packed, players, legal)
        grids = _tactical_grids(packed, players)
        _, forcing1 = _oneply_scores(packed, players, grids)
        urgent, cand, rows, cols, after, ko = _play_candidates(
            packed, players, legal, logp, forcing1, self.top_k, self.urgent)
        if after is None:
            any_legal = legal.any(axis=1)
            return np.where(any_legal, logp.argmax(axis=1), -1)

        # realized 1-ply gain: captures, working ladders, liberty shape —
        # WITHOUT the speculative save term (see class docstring)
        my_kills, _, my_libs, opp_libs, ladders = grids
        gain = (W_KILL * my_kills + W_LADDER * ladders + W_LIB * my_libs
                + W_OPP_LIB * opp_libs - W_SELF_ATARI * (my_libs <= 1))

        # measure the material the opponent's best legal reply actually
        # takes on each after-board (immediate captures + working ladders;
        # ko-banned reply excluded)
        opp = (3 - players[rows]).astype(np.int32)
        midx = np.arange(len(rows))
        reply_kills, _, _, _, reply_ladders = _tactical_grids(after, opp)
        reply_take = W_KILL * reply_kills + W_LADDER * reply_ladders
        reply_legal = legal_mask(after, opp)
        banned = ko >= 0
        reply_legal[midx[banned], ko[banned]] = False
        threat = np.where(reply_legal, reply_take, 0).max(axis=1)

        # realized-outcome 2-ply score: what the move takes minus what the
        # best reply takes back; standing threats hit every candidate's
        # after-board alike and so cancel out of the differential veto
        return _veto_select(logp, legal, cand, rows, cols,
                            gain[rows, cols].astype(np.float64) - threat,
                            self.margin, urgent, self.pass_threshold, rng)


class ValueSearchAgent(PolicySearchAgent):
    """Policy-pruned 1-ply search over a LEARNED evaluation (``value:`` spec).

    The round-4 expert-iteration study's conclusion (RESULTS.md): a
    constant tactical wrapper saturates the self-improvement loop after
    one distillation round — climbing further needs an evaluation whose
    quality grows with training. This agent is that next rung's
    scaffold: candidates are the policy's top-k plus every forcing
    point (the same pruning as the tactical searchers), each candidate
    is PLAYED (batched native stepping), and the score is the value
    network's win probability for the mover on the after-board
    (1 - P(opponent-to-move wins), models/value_cnn.py). The
    differential veto fires only when some candidate beats the policy
    move's own after-board value by ``margin`` win-probability (default
    0.08) — the same only-override-demonstrated-blunders asymmetry the
    tactical sweeps showed is optimal.

    Known approximations, documented not hidden: the value net does not
    see the ko ban on the after-board, and a net trained on
    mixed-rank corpora can lean on the rank planes (equal-rank matches
    force it onto board features).
    """

    name = "value-search"

    def __init__(self, params, cfg, value_params, value_cfg,
                 name: str = "value-search", margin: float = 0.08,
                 value_engine=None, **kw):
        from .models.serving import make_value_fn

        super().__init__(params, cfg, name=name, **kw)
        self.value_params = value_params
        self.value_cfg = value_cfg
        self.margin = margin
        self.value_engine = value_engine
        self._win_prob = make_value_fn(value_cfg, device=self.device)

    def _values(self, boards: np.ndarray, to_move: np.ndarray) -> np.ndarray:
        """P(side ``to_move`` wins) per board, padded onto the serving
        bucket ladder so the jitted value forward only ever sees
        ladder's rungs (the same guard as selfplay.batched_log_probs;
        the candidate count varies ply to ply). With a ``value_engine``
        the boards ride the shared micro-batching engine instead, so a
        2-ply search's leaf evaluations coalesce with every other value
        consumer's dispatches."""
        to_move = to_move.astype(np.int32)
        ranks = np.full(len(boards), self.rank, dtype=np.int32)
        if self.value_engine is not None:
            return self.value_engine.evaluate(boards, to_move, ranks)
        from .serving import bucketed_forward, ladder_for

        return bucketed_forward(
            lambda pk, pl, rk: self._win_prob(self.value_params, pk, pl, rk),
            boards, to_move, ranks, ladder_for(len(boards)))

    def select_moves(self, packed, players, legal, rng):
        legal = _no_own_eyes(packed, players, legal)
        logp = self._legal_log_probs(packed, players, legal)
        _, forcing1 = _oneply_scores(packed, players)
        urgent, cand, rows, cols, after, _ = _play_candidates(
            packed, players, legal, logp, forcing1, self.top_k, self.urgent)
        if after is None:
            any_legal = legal.any(axis=1)
            return np.where(any_legal, logp.argmax(axis=1), -1)

        v_opp = self._values(after, 3 - players[rows])
        # tie_scale keeps the policy-prob tie-break under the win-prob
        # margin, preserving the prior's ordering among value-equal moves
        return _veto_select(logp, legal, cand, rows, cols, 1.0 - v_opp,
                            self.margin, urgent, self.pass_threshold, rng,
                            tie_scale=1e-4)


class Value2PlyAgent(ValueSearchAgent):
    """Policy-pruned 2-ply search under the learned evaluation (``value2:``).

    The round-4 factorial's prescribed next expert (RESULTS.md): the 1-ply
    value agent scores a candidate by the value of its after-board, which
    credits moves whose refutation sits one reply away — exactly the
    horizon the tactical TwoPlyAgent closed for the capture game. This
    agent closes it for the learned evaluation: the opponent's best reply
    is found BY VALUE, not by the fixed tactical table.

    Per board it (1) takes the policy top-k plus forcing points as
    candidates and plays each (the same pruning as every search agent),
    (2) on each after-board, takes the OPPONENT's policy top-``reply_k``
    plus forcing points as replies and plays those too (batched native
    stepping across fleet x candidates x replies), (3) scores every leaf
    with the value net from the original mover's perspective (mover is to
    move again at depth 2), and (4) scores a candidate by the WORST leaf
    over the opponent's replies — the opponent also gets the no-op reply
    (pass), whose leaf is the after-board itself, so a candidate can
    never look good merely because every opponent reply would worsen the
    opponent's position. The differential veto then fires only when some
    candidate beats the policy move's own 2-ply score by ``margin`` win
    probability — the only-override-demonstrated-blunders asymmetry every
    search sweep selected.

    The min over replies uses the value net at BOTH plies, so evaluation
    quality still grows with value training — the property the round-4
    study identified as the requirement for the loop to keep climbing.
    Known approximations inherited from the 1-ply agent: leaves don't see
    the depth-2 ko ban, and ranks feed the net's rank planes uniformly.
    """

    name = "value2-search"

    def __init__(self, params, cfg, value_params, value_cfg,
                 name: str = "value2-search", reply_k: int = 6, **kw):
        super().__init__(params, cfg, value_params, value_cfg, name=name, **kw)
        self.reply_k = reply_k

    def select_moves(self, packed, players, legal, rng):
        legal = _no_own_eyes(packed, players, legal)
        logp = self._legal_log_probs(packed, players, legal)
        _, forcing1 = _oneply_scores(packed, players)
        urgent, cand, rows, cols, after, ko = _play_candidates(
            packed, players, legal, logp, forcing1, self.top_k, self.urgent)
        if after is None:
            any_legal = legal.any(axis=1)
            return np.where(any_legal, logp.argmax(axis=1), -1)

        # opponent's turn on each after-board: reply candidates from THEIR
        # policy prior + forcing points, ko-banned recapture excluded
        n_c = len(rows)
        mover = players[rows].astype(np.int32)
        opp = (3 - mover).astype(np.int32)
        reply_legal = legal_mask(after, opp)
        banned = ko >= 0
        reply_legal[np.arange(n_c)[banned], ko[banned]] = False
        reply_legal = _no_own_eyes(after, opp, reply_legal)
        logp2 = self._legal_log_probs(after, opp, reply_legal)
        _, forcing2 = _oneply_scores(after, opp)
        _, _, rrows, rcols, leaves, _ = _play_candidates(
            after, opp, reply_legal, logp2, forcing2, self.reply_k,
            self.urgent)

        # every candidate starts from the pass-reply leaf: the after-board
        # itself with the mover back on move
        score = self._values(after, mover).astype(np.float64)
        if leaves is not None:
            v_leaf = self._values(leaves, mover[rrows])
            np.minimum.at(score, rrows, v_leaf.astype(np.float64))
        return _veto_select(logp, legal, cand, rows, cols, score,
                            self.margin, urgent, self.pass_threshold, rng,
                            tie_scale=1e-4)


class SearchAgent(PolicyAgent):
    """Full PUCT tree search over the serving fleet (``mcts:`` spec).

    The deep end of the policy-guides-search ladder:
    where the ``search:``/``search2:``/``value2:`` family re-ranks a
    handful of candidates 1-2 plies deep, this agent runs a
    virtual-loss wave-batched MCTS (``search/``) whose leaf
    evaluations ride the shared serving engine as batched futures and
    whose transposition table is keyed on the canonical position
    digests — so both sides of a match, and every symmetry of every
    transposition, share forwards through the content-addressed cache.
    The table persists across moves and games: tree reuse is a table
    hit. With value params the leaves are scored by the value net
    (``mcts:POLICY:VALUE``); without, the search is prior-guided with
    terminal-only values.

    Deterministic at ``temperature=0`` given a fixed simulation budget
    and a deterministic evaluator (the Elo gate's requirement); ``rng``
    only matters for root Dirichlet noise / visit sampling, which the
    arena leaves off.
    """

    def __init__(self, params, cfg, value_params=None, value_cfg=None,
                 name: str = "mcts", simulations: int = 128,
                 search_config=None, value_engine=None, table=None, **kw):
        if kw.get("temperature", 0.0):
            raise ValueError("SearchAgent selects by visit count; "
                             "temperature is not supported in the arena")
        super().__init__(params, cfg, name=name, **kw)
        from .search import Search, SearchConfig, TranspositionTable

        self.simulations = simulations
        if value_engine is None and value_params is not None:
            value_engine = _DirectValue(value_params, value_cfg,
                                        device=self.device)
        self.value_engine = value_engine
        cfg_s = search_config or SearchConfig(
            simulations=simulations, rank=self.rank, tier="interactive")
        self.search_config = cfg_s
        self.table = table if table is not None else TranspositionTable(
            cfg_s.max_nodes)
        engine = self.engine if self.engine is not None \
            else _DirectSubmit(self)
        self._search = Search(engine, cfg_s, table=self.table,
                              value_engine=value_engine)

    def select_moves(self, packed, players, legal, rng):
        from .search import game_from_packed

        moves = np.full(len(packed), -1, dtype=np.int64)
        for i in range(len(packed)):
            g = game_from_packed(packed[i], int(players[i]), legal[i])
            r = self._search.search(g, simulations=self.simulations,
                                    root_legal=legal[i])
            moves[i] = r.move
        return moves


class _DirectSubmit:
    """Engine-shaped adapter over the agent's direct forward path: each
    leaf is one (bucket-padded) forward resolved into an
    already-completed future. The no-engine smoke path — real searches
    should share a micro-batching engine so waves coalesce."""

    def __init__(self, agent: PolicyAgent):
        self._agent = agent

    def submit(self, packed, player, rank):
        from concurrent.futures import Future

        a = self._agent
        row = batched_log_probs(
            a._predict, a.params, np.asarray(packed)[None],
            np.array([player], dtype=np.int32),
            np.array([rank], dtype=np.int32))[0]
        f = Future()
        f.set_result(np.asarray(row))
        return f


class _DirectValue:
    """``evaluate``-shaped adapter over a direct value forward (the same
    ladder-padded path ValueSearchAgent uses without an engine)."""

    def __init__(self, value_params, value_cfg, device="cuda"):
        from .models.serving import make_value_fn

        self._params = value_params
        self._win_prob = make_value_fn(value_cfg, device=device)

    def evaluate(self, boards, to_move, ranks):
        from .serving import bucketed_forward, ladder_for

        return bucketed_forward(
            lambda pk, pl, rk: self._win_prob(self._params, pk, pl, rk),
            boards, np.asarray(to_move, dtype=np.int32),
            np.asarray(ranks, dtype=np.int32), ladder_for(len(boards)))


def _policy_engine_for(params, cfg, use_engine, fleet: int = 1,
                       variant: str = "f32", device="cuda"):
    """The shared policy engine for this checkpoint, or None. Agents built
    from the same params then coalesce their per-ply forwards into the
    same micro-batched dispatches (serving.shared_policy_engine).
    ``use_engine="supervised"`` puts the shared engine under the
    resilience supervisor (serving.SupervisedEngine) so agents ride
    through dispatcher restarts untouched; ``fleet >= 2`` spreads it over
    that many supervised replicas behind the failover router
    (serving.FleetRouter). ``variant`` selects the
    serving program (f32 | int8 | sym | int8+sym — serving/variants.py;
    lossy variants tolerance-gate before serving), memoized per
    (checkpoint, variant) so an int8 agent and an f32 agent of the same
    champion coexist for a live arena A/B."""
    if not use_engine and variant != "f32":
        raise ValueError(
            f"variant {variant!r} needs the serving engine path — pass "
            "--engine/--supervised/--fleet (the variant forward lives in "
            "the shared engine registry)")
    if not use_engine:
        return None
    from .serving import shared_policy_engine

    return shared_policy_engine(params, cfg,
                                supervised=use_engine == "supervised",
                                fleet=fleet, variant=variant, device=device)


def _make_agent(spec: str, seed: int, temperature: float = 0.0,
                rank: int = 9, use_engine=False, fleet: int = 1,
                variant: str = "f32", search_sims: int = 128,
                device="cuda") -> Agent:
    """``use_engine``: False (direct ladder path), True (shared
    micro-batching engine), or "supervised" (shared engine under the
    resilience supervisor). ``fleet >= 2`` upgrades the shared engines to
    a FleetRouter of that many supervised replicas. ``variant`` routes
    the POLICY forward through a named serving variant (arena A/B:
    quantized vs full-precision champions). Net-backed agents run on
    ``device``; ``model:NAME`` seeds a ``torch.Generator`` with ``seed``
    (not the JAX package's weights for that seed)."""
    if spec == "random":
        return RandomAgent()
    if spec == "heuristic":
        return HeuristicAgent()
    if spec == "oneply":
        return OnePlyAgent()
    if spec.startswith("checkpoint:"):
        from .models.serving import load_policy

        _, params, cfg = load_policy(spec.split(":", 1)[1],
                                     device=device)
        return PolicyAgent(params, cfg, name="policy", temperature=temperature,
                           rank=rank,
                           engine=_policy_engine_for(params, cfg, use_engine,
                                                     fleet=fleet,
                                                     variant=variant,
                                                     device=device),
                           device=device)
    if spec.startswith("search:"):
        from .models.serving import load_policy

        # --temperature deliberately NOT forwarded: it applies to sampling
        # policy agents only (see the CLI help); the re-ranker stays
        # deterministic even in a mixed policy-vs-search match
        _, params, cfg = load_policy(spec.split(":", 1)[1],
                                     device=device)
        return PolicySearchAgent(params, cfg, rank=rank,
                                 engine=_policy_engine_for(params, cfg,
                                                           use_engine,
                                                           fleet=fleet,
                                                           variant=variant,
                                                           device=device),
                                 device=device)
    if spec.startswith("search2:"):
        from .models.serving import load_policy

        _, params, cfg = load_policy(spec.split(":", 1)[1],
                                     device=device)
        return TwoPlyAgent(params, cfg, rank=rank,
                           engine=_policy_engine_for(params, cfg, use_engine,
                                                     fleet=fleet,
                                                     variant=variant,
                                                     device=device),
                           device=device)
    if spec.startswith(("value:", "value2:")):
        from .models.serving import load_policy, load_value

        # value[2]:POLICY_CKPT:VALUE_CKPT — policy prunes, value net scores
        try:
            kind, policy_path, value_path = spec.split(":", 2)
        except ValueError:
            raise ValueError(
                f"value spec needs two checkpoint paths, got {spec!r} "
                "(use value:POLICY.npz:VALUE.npz or value2:...)") from None
        _, params, cfg = load_policy(policy_path, device=device)
        _, vparams, vcfg = load_value(value_path, device=device)
        cls = Value2PlyAgent if kind == "value2" else ValueSearchAgent
        value_engine = None
        if use_engine:
            from .serving import shared_value_engine

            value_engine = shared_value_engine(
                vparams, vcfg, supervised=use_engine == "supervised",
                fleet=fleet, device=device)
        return cls(params, cfg, vparams, vcfg, rank=rank,
                   engine=_policy_engine_for(params, cfg, use_engine,
                                             fleet=fleet, device=device),
                   value_engine=value_engine, device=device)
    if spec.startswith("mcts:"):
        from .models.serving import load_policy, load_value

        # mcts:POLICY_CKPT[:VALUE_CKPT] — full PUCT tree search
        # (search/) with the policy as prior and, when given,
        # the value net at the leaves. Always rides the shared
        # micro-batching engine: wave-batched leaf futures are the point.
        parts = spec.split(":")
        _, params, cfg = load_policy(parts[1], device=device)
        vparams = vcfg = None
        if len(parts) > 2:
            _, vparams, vcfg = load_value(parts[2], device=device)
        value_engine = None
        if vparams is not None and use_engine:
            from .serving import shared_value_engine

            value_engine = shared_value_engine(
                vparams, vcfg, supervised=use_engine == "supervised",
                fleet=fleet, device=device)
        return SearchAgent(params, cfg, vparams, vcfg, rank=rank,
                           simulations=search_sims,
                           engine=_policy_engine_for(params, cfg,
                                                     use_engine or True,
                                                     fleet=fleet,
                                                     variant=variant,
                                                     device=device),
                           value_engine=value_engine, device=device)
    if spec.startswith("model:"):  # random-init policy, for smoke runs
        cfg = policy_cnn.CONFIGS[spec.split(":", 1)[1]]
        params = policy_cnn.init(torch.Generator().manual_seed(seed), cfg,
                                 device=device)
        return PolicyAgent(params, cfg, name=f"init-{spec.split(':', 1)[1]}",
                           temperature=temperature, rank=rank,
                           engine=_policy_engine_for(params, cfg, use_engine,
                                                     fleet=fleet,
                                                     variant=variant,
                                                     device=device),
                           device=device)
    raise ValueError(
        f"unknown agent spec {spec!r} "
        "(use random | heuristic | oneply | checkpoint:PATH | search:PATH "
        "| search2:PATH | value:POLICY:VALUE | value2:POLICY:VALUE "
        "| mcts:POLICY[:VALUE] | model:NAME)")
