"""Batched PUCT MCTS over the serving fleet: deep search as a service.

The port's copy of ``deepgo_tpu/search/mcts.py`` over the port's
``selfplay``, ``go.scoring``, ``obs`` and ``utils/digest``.

The source paper frames the CNN as a move evaluator whose real strength
appears when paired with search (arXiv:1412.6564 §Conclusion). This
module is that search, built AS A SERVING WORKLOAD rather than a
standalone engine:

  * **Wave-batched leaf evaluation** — descents run in waves of
    ``wave_size`` parallel simulations under virtual loss, every leaf a
    future submitted to whatever engine shape the caller hands over (a
    bare ``InferenceEngine``, a ``SupervisedEngine``, a ``FleetRouter``,
    or a test fake) so hundreds of leaves coalesce into the padded
    serving buckets instead of 1-board dispatches.
  * **Transposition table = content-addressed cache** — tree nodes are
    keyed on the ``utils/digest.py`` CANONICAL digest and store their
    statistics in the canonical dihedral frame; leaf evaluations submit
    the canonical view itself, so every transposition (and every
    symmetry of one) across all concurrent searches lands on the same
    position-cache entry and shares one forward. The table persists across
    consecutive moves of a game: tree reuse is just a table hit.
  * **Anytime deadline contract** — ``deadline_s`` bounds the wall
    clock. A replica kill, a brownout, or a shed mid-search reverts
    that simulation's virtual losses (a LOST simulation, counted, never
    silently absorbed) and burns deadline headroom — the move itself is
    never lost: the search always returns a legal move (falling back to
    the lowest-index legal point only if the very first root evaluation
    cannot complete in budget).
  * **Traceable verdicts** — each search emits one ``search_request``
    event carrying the search id, chosen move, principal variation and
    loss/deadline accounting; leaf submissions ride the fleet with
    ``session="search:<id>"`` so the workload recorder and per-request
    traces join back to the search that caused them (``cli trace``).

Board stepping reuses ``selfplay.GameState`` (native batch kernels where
available); frame conversions are pure gathers through ``PERMS`` /
``INV_PERMS``: canonical edge ``p`` is actual point ``PERMS[k][p]``, an
actual ko point ``q`` is banned at canonical index ``INV_PERMS[k][q]``.

A ``Search`` instance runs one search at a time (not thread-safe);
concurrent searches each build their own ``Search`` and may SHARE one
``TranspositionTable`` (its own lock guards the entry map; concurrent
node-stat updates are benign statistical noise, not corruption — the
determinism tests use private tables).
"""

from __future__ import annotations

import dataclasses
import inspect
import time
import uuid
from collections import OrderedDict

import numpy as np

from ..analysis.lockcheck import make_lock
from .. import BOARD_SIZE
from ..features import P_AGE, P_STONES
from ..go.scoring import area_score
from ..obs import get_registry
from ..selfplay import GameState, legal_mask, step_game, summarize_state
from ..utils.digest import INV_PERMS, NUM_POINTS, PERMS, canonicalize

PASS_EDGE = NUM_POINTS   # edge 361: pass (the policy head has no pass output)
NUM_EDGES = NUM_POINTS + 1


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """One search's budget and shape. ``deadline_s`` is the anytime QoS
    knob ("best move in 200ms" vs "analyze for 10s"); ``tier`` maps the
    leaf traffic onto the fleet's priority ladder — it should stay on a
    CACHED tier (the fleet cache bypasses ``batch`` by default, and the
    transposition-sharing story depends on the cache)."""

    simulations: int = 128       # full budget; a deadline may cut it short
    wave_size: int = 16          # parallel virtual-loss descents per wave
    c_puct: float = 1.25
    virtual_loss: float = 1.0
    tier: str | None = "interactive"
    deadline_s: float | None = None
    eval_timeout_s: float = 30.0  # per-wave future timeout w/o a deadline
    temperature: float = 0.0     # root visit sampling (0 = argmax)
    rank: int = 9
    komi: float = 7.5
    max_moves: int = 450         # descent depth cap (move-cap leaf = draw)
    pass_prior: float = 1e-3     # pass edge prior vs the 361 point edges
    root_noise_frac: float = 0.0  # Dirichlet mix at the root (selfplay)
    root_noise_alpha: float = 0.12
    max_nodes: int = 100_000     # transposition-table LRU capacity


class Node:
    """One canonical position's edge statistics (362 edges, canonical
    frame). ``W`` accumulates values from THIS node's player's
    perspective; ``legal`` is ko-free board legality (ko is a property
    of the path, masked per-descent)."""

    __slots__ = ("digest", "player", "legal", "P", "N", "W", "expanded")

    def __init__(self, digest: str, player: int, legal: np.ndarray):
        self.digest = digest
        self.player = int(player)
        self.legal = legal
        self.P = None
        self.N = np.zeros(NUM_EDGES, dtype=np.float64)
        self.W = np.zeros(NUM_EDGES, dtype=np.float64)
        self.expanded = False

    def expand(self, log_probs: np.ndarray, pass_prior: float) -> None:
        """Priors from one canonical-frame policy row: masked to legal
        points, renormalized, with a fixed sliver for the pass edge
        (all mass when nothing is legal — the node must stay playable)."""
        p = np.zeros(NUM_EDGES, dtype=np.float64)
        row = np.asarray(log_probs, dtype=np.float64).reshape(-1)[:NUM_POINTS]
        if self.legal.any():
            probs = np.where(self.legal, np.exp(row - row.max()), 0.0)
            total = probs.sum()
            if total > 0:
                p[:NUM_POINTS] = probs / total * (1.0 - pass_prior)
                p[PASS_EDGE] = pass_prior
            else:   # degenerate row (all -inf on legal): uniform fallback
                p[:NUM_POINTS] = self.legal / self.legal.sum()
                p[:NUM_POINTS] *= (1.0 - pass_prior)
                p[PASS_EDGE] = pass_prior
        else:
            p[PASS_EDGE] = 1.0
        self.P = p
        self.expanded = True


class TranspositionTable:
    """LRU digest -> Node map shared across searches and across moves.

    Keyed on the canonical digest, so all eight dihedral views of a
    position — and the same position reached through different move
    orders or by different concurrent searches — resolve to one node.
    The lock guards the map only; node statistics are updated lock-free
    by their searches (see module docstring)."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = int(capacity)
        self._lock = make_lock("search.tt")
        self._entries: OrderedDict[str, Node] = OrderedDict()
        self.lookups = 0
        self.hits = 0
        self.evictions = 0

    def get(self, digest: str) -> Node | None:
        with self._lock:
            self.lookups += 1
            node = self._entries.get(digest)
            if node is not None:
                self.hits += 1
                self._entries.move_to_end(digest)
            return node

    def put(self, digest: str, node: Node) -> Node:
        """Insert (or return the already-present node — two searches
        racing to create the same leaf must converge on ONE node)."""
        with self._lock:
            existing = self._entries.get(digest)
            if existing is not None:
                return existing
            self._entries[digest] = node
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
            return node

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "lookups": self.lookups,
                    "hits": self.hits, "evictions": self.evictions,
                    "capacity": self.capacity}


class LeafEvaluator:
    """Adapter from ``engine.submit`` shapes to the search's needs.

    Signature-detects ``tier`` / ``session`` / ``timeout_s`` the same way
    the workload replayer does, so the one descent loop rides a
    FleetRouter (tiered, session-labeled, deadline-aware), a supervised
    or bare engine, or a test fake without per-backend branches."""

    def __init__(self, engine, tier: str | None = None,
                 session: str | None = None):
        self.engine = engine
        self.tier = tier
        self.session = session
        try:
            params = inspect.signature(engine.submit).parameters
        except (TypeError, ValueError):
            params = {}
        self._accepts = {k for k in ("tier", "session", "timeout_s")
                         if k in params}

    def submit(self, packed: np.ndarray, player: int, rank: int,
               timeout_s: float | None = None):
        kw = {}
        if "tier" in self._accepts and self.tier:
            kw["tier"] = self.tier
        if "session" in self._accepts and self.session:
            kw["session"] = self.session
        if "timeout_s" in self._accepts and timeout_s is not None:
            kw["timeout_s"] = timeout_s
        return self.engine.submit(packed, player, rank, **kw)


@dataclasses.dataclass
class SearchResult:
    """One search's verdict plus the accounting the QoS story runs on.

    ``move`` is an ACTUAL-frame flat index (-1 = pass) and is always
    legal for the position searched; ``visits`` are actual-frame root
    visit counts (the AlphaZero-style selfplay target), ``pv`` the
    principal variation as actual-frame indices from the root."""

    move: int
    value: float
    simulations: int
    lost: int
    waves: int
    wave_occupancy: float
    duration_s: float
    deadline_met: bool
    fallback: bool
    pv: list[int]
    search_id: str
    root_digest: str
    visits: np.ndarray
    pass_visits: float
    tt: dict


def game_from_packed(packed: np.ndarray, player: int,
                     legal_row: np.ndarray | None = None) -> GameState:
    """Reconstruct a steppable GameState from one packed record.

    Exact by construction: the packed record stores the stone grid
    (P_STONES) and the age grid (P_AGE, already clipped at go.MAX_AGE —
    ``play`` clips before ``summarize`` writes, so clipping is
    idempotent and re-summarizing the reconstruction is bitwise the
    original record). The simple-ko point is recovered from ``legal_row``
    when given: the unique point that is board-legal by the planes but
    masked from the caller's legal row is the banned recapture.
    """
    g = GameState()
    g.stones[:] = packed[P_STONES]
    g.age[:] = packed[P_AGE]
    g.player = int(player)
    if legal_row is not None:
        board_legal = legal_mask(
            packed[None], np.array([player], dtype=np.int32))[0]
        banned = np.flatnonzero(board_legal & ~np.asarray(legal_row,
                                                          dtype=bool))
        if len(banned) == 1:
            g.ko_point = divmod(int(banned[0]), BOARD_SIZE)
    return g


def _clone(g: GameState) -> GameState:
    c = GameState.__new__(GameState)
    c.stones = g.stones.copy()
    c.age = g.age.copy()
    c.player = g.player
    c.moves = list(g.moves)
    c.passes = g.passes
    c.done = g.done
    c.ko_point = g.ko_point
    return c


def _terminal_value(g: GameState, player: int, komi: float) -> float:
    """z in {-1, 0, +1} from ``player``'s perspective for a finished
    descent: Tromp-Taylor for a double pass, a draw for a move-cap
    truncation (scoring an arbitrary truncation would be noise)."""
    if g.passes < 2:
        return 0.0
    w = area_score(g.stones, komi=komi).winner
    if w == 0:
        return 0.0
    return 1.0 if w == player else -1.0


def make_move_selector(engine, config: SearchConfig | None = None,
                       value_engine=None,
                       table: TranspositionTable | None = None,
                       metrics=None):
    """A ``selfplay.self_play(move_selector=...)`` hook: AlphaZero-style
    search-selfplay. Each active game gets one PUCT search (root
    Dirichlet noise + visit-count temperature by default — the
    exploration mix expert iteration needs); all games in the actor
    share one transposition table, so the selfplay fleet's
    transpositions collapse onto shared forwards like everything else."""
    cfg = config or SearchConfig(simulations=64, wave_size=16,
                                 tier="selfplay", temperature=1.0,
                                 root_noise_frac=0.25)
    tt = table if table is not None else TranspositionTable(cfg.max_nodes)
    search = Search(engine, cfg, table=tt, value_engine=value_engine,
                    metrics=metrics)

    def select(games, packed, players, legal, rng):
        search.rng = rng
        return [search.search(games[i], root_legal=legal[i]).move
                for i in range(len(games))]

    select.search = search   # introspection for stats/tests
    return select


class Search:
    """PUCT MCTS: virtual-loss wave descent, canonical transpositions,
    anytime deadlines. One instance per concurrent searcher; the
    ``TranspositionTable`` may be shared (and persists across moves —
    that IS the tree reuse)."""

    def __init__(self, engine, config: SearchConfig | None = None,
                 table: TranspositionTable | None = None,
                 value_engine=None, rng: np.random.Generator | None = None,
                 metrics=None, search_session: str | None = None):
        self.cfg = config or SearchConfig()
        self.table = table if table is not None else TranspositionTable(
            self.cfg.max_nodes)
        self.value_engine = value_engine
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self._metrics = metrics
        self._session = search_session
        self._engine = engine
        self._evaluator: LeafEvaluator | None = None
        self._root_P: np.ndarray | None = None
        self._root_mask: np.ndarray | None = None
        reg = get_registry()
        self._obs_sims = reg.counter(
            "deepgo_search_simulations_total",
            "completed (backed-up) PUCT simulations")
        self._obs_lost = reg.counter(
            "deepgo_search_lost_simulations_total",
            "simulations reverted after a failed/timed-out leaf eval "
            "(the anytime contract: deadline headroom burned, never "
            "the move)")
        self._obs_waves = reg.counter(
            "deepgo_search_waves_total", "leaf-evaluation waves dispatched")
        self._obs_fallback = reg.counter(
            "deepgo_search_fallback_moves_total",
            "moves answered by the legal-move fallback because the root "
            "evaluation never completed in budget")
        self._obs_rate = reg.gauge(
            "deepgo_search_simulations_per_sec",
            "simulations/sec of the most recent search")
        self._obs_occupancy = reg.gauge(
            "deepgo_search_wave_occupancy",
            "unique leaves per wave / wave_size of the most recent search")
        self._obs_nodes = reg.gauge(
            "deepgo_search_tree_nodes",
            "transposition-table entries after the most recent search")

    # -- descent -----------------------------------------------------------

    def _canonical_legal(self, view: np.ndarray, player: int) -> np.ndarray:
        """(361,) ko-free board legality in the canonical frame —
        computed directly from the canonical view's planes (legality is
        a pure function of the planes, so this equals
        ``legal_actual[PERMS[k]]``)."""
        return legal_mask(view[None],
                          np.array([player], dtype=np.int32))[0]

    def _select_edge(self, node: Node, g: GameState, k: int,
                     is_root: bool) -> int:
        """PUCT argmax over this node's playable edges. Deterministic:
        numpy argmax breaks ties by lowest index."""
        allowed = np.empty(NUM_EDGES, dtype=bool)
        allowed[:NUM_POINTS] = node.legal
        allowed[PASS_EDGE] = True
        if g.ko_point is not None:
            q = g.ko_point[0] * BOARD_SIZE + g.ko_point[1]
            allowed[int(INV_PERMS[k][q])] = False
        if is_root and self._root_mask is not None:
            allowed[:NUM_POINTS] &= self._root_mask
        P = (self._root_P if is_root and self._root_P is not None
             else node.P)
        N, W = node.N, node.W
        q_val = np.divide(W, N, out=np.zeros(NUM_EDGES), where=N > 0)
        u = self.cfg.c_puct * P * (np.sqrt(N.sum() + 1.0) / (1.0 + N))
        score = np.where(allowed, q_val + u, -np.inf)
        return int(score.argmax())

    def _descend(self, root_game: GameState):
        """One virtual-loss simulation from the root. Returns
        ``("terminal", value_player, path)`` with the terminal value
        context, or ``("leaf", (digest, view, k, player), path)`` for a
        position that needs (or is awaiting) a leaf evaluation."""
        g = _clone(root_game)
        path: list[tuple[Node, int]] = []
        is_root = True
        while True:
            if g.done:
                return "terminal", g, path
            packed = summarize_state(g)
            digest, view, k = canonicalize(packed, g.player, self.cfg.rank)
            node = self.table.get(digest)
            if node is None:
                node = self.table.put(digest, Node(
                    digest, g.player, self._canonical_legal(view, g.player)))
            if not node.expanded:
                return "leaf", (digest, view, k, g.player), path
            edge = self._select_edge(node, g, k, is_root)
            is_root = False
            node.N[edge] += 1.0
            node.W[edge] -= self.cfg.virtual_loss
            path.append((node, edge))
            move = -1 if edge == PASS_EDGE else int(PERMS[k][edge])
            step_game(g, move, self.cfg.max_moves)

    def _backup(self, path: list[tuple[Node, int]], value: float,
                value_player: int) -> None:
        """Convert each edge's virtual loss into a real visit: the -vloss
        applied on the way down comes back, plus the value signed into
        each node's own perspective."""
        vloss = self.cfg.virtual_loss
        for node, edge in path:
            signed = value if node.player == value_player else -value
            node.W[edge] += vloss + signed
        self._obs_sims.inc(1)

    def _revert(self, path: list[tuple[Node, int]]) -> None:
        """A lost simulation: undo its virtual losses entirely so a
        failed eval can never bias the tree (the double-count guard the
        determinism tests pin)."""
        vloss = self.cfg.virtual_loss
        for node, edge in path:
            node.N[edge] -= 1.0
            node.W[edge] += vloss
        self._obs_lost.inc(1)

    # -- leaf evaluation ---------------------------------------------------

    def _leaf_values(self, views: list[np.ndarray],
                     players: list[int]) -> np.ndarray:
        """Leaf values in [-1, 1] from each leaf player's perspective:
        the value net's win probability mapped to 2v-1 when a value
        engine is attached, else 0 (pure prior-guided search)."""
        if self.value_engine is None or not views:
            return np.zeros(len(views))
        ranks = np.full(len(views), self.cfg.rank, dtype=np.int32)
        v = np.asarray(self.value_engine.evaluate(
            np.stack(views), np.array(players, dtype=np.int32), ranks),
            dtype=np.float64).reshape(-1)
        return 2.0 * v - 1.0

    def _expand_root(self, game: GameState, deadline: float | None):
        """Make sure the root node is expanded (tree reuse makes this a
        table hit on every move after a game's first). Returns the
        (digest, view, k, node) root context, or None when the eval
        cannot complete in budget (the caller falls back)."""
        packed = summarize_state(game)
        digest, view, k = canonicalize(packed, game.player, self.cfg.rank)
        node = self.table.get(digest)
        if node is None:
            node = self.table.put(digest, Node(
                digest, game.player, self._canonical_legal(view,
                                                           game.player)))
        if node.expanded:
            return digest, view, k, node
        timeout = self._remaining(deadline)
        try:
            fut = self._evaluator.submit(view, game.player, self.cfg.rank,
                                         timeout_s=timeout)
            row = np.asarray(fut.result(timeout=timeout))
        except Exception:  # noqa: BLE001 — any shed/kill/timeout: fallback
            return None
        node.expand(row, self.cfg.pass_prior)
        return digest, view, k, node

    def _remaining(self, t_end: float | None) -> float:
        if t_end is None:
            return self.cfg.eval_timeout_s
        return max(t_end - time.monotonic(), 0.05)

    # -- the search --------------------------------------------------------

    def search(self, game: GameState, simulations: int | None = None,
               deadline_s: float | None = None,
               root_legal: np.ndarray | None = None) -> SearchResult:
        """Best move for ``game``'s side to move under the configured
        budget. ``root_legal`` (actual-frame (361,) bool) further
        restricts the ROOT move set — the superko hook for callers whose
        rules are stricter than the descent's simple ko; the returned
        move always satisfies it."""
        cfg = self.cfg
        sims = int(simulations if simulations is not None
                   else cfg.simulations)
        deadline = (deadline_s if deadline_s is not None
                    else cfg.deadline_s)
        t0 = time.monotonic()
        t_end = None if deadline is None else t0 + deadline
        search_id = uuid.uuid4().hex[:12]
        self._evaluator = LeafEvaluator(
            self._engine, tier=cfg.tier,
            session=self._session or f"search:{search_id}")
        self._root_mask = (np.asarray(root_legal, dtype=bool)
                           if root_legal is not None else None)
        self._root_P = None

        done = lost = waves = 0
        leaves_submitted = 0
        fallback = False
        root_ctx = self._expand_root(game, t_end)
        if root_ctx is None:
            # anytime contract: the move is never lost — answer with the
            # lowest-index legal point (or pass) and account for it
            self._obs_fallback.inc(1)
            fallback = True
            legal = legal_mask(summarize_state(game)[None],
                               np.array([game.player], dtype=np.int32),
                               [game])[0]
            if self._root_mask is not None:
                legal &= self._root_mask
            idx = np.flatnonzero(legal)
            move = int(idx[0]) if len(idx) else -1
            return self._finish(game, search_id, move, 0.0, 0, 0, 0, 0.0,
                                t0, t_end, fallback, [])
        root_digest, _root_view, root_k, root = root_ctx

        if cfg.root_noise_frac > 0.0:
            legal_idx = np.flatnonzero(root.legal)
            if len(legal_idx):
                noise = self.rng.dirichlet(
                    np.full(len(legal_idx), cfg.root_noise_alpha))
                mixed = root.P.copy()
                mixed[legal_idx] = ((1.0 - cfg.root_noise_frac)
                                    * mixed[legal_idx]
                                    + cfg.root_noise_frac * noise)
                self._root_P = mixed

        # `done + lost` bounds the loop: a dead fleet cannot spin the
        # search forever — every failed wave burns budget (and, with a
        # deadline, wall clock) until the anytime finalization fires
        while done + lost < sims:
            if t_end is not None and time.monotonic() >= t_end:
                break
            want = min(cfg.wave_size, sims - done - lost)
            pending: OrderedDict[str, dict] = OrderedDict()
            for _ in range(want):
                kind, info, path = self._descend(game)
                if kind == "terminal":
                    g_t = info
                    z = _terminal_value(g_t, g_t.player, cfg.komi)
                    self._backup(path, z, g_t.player)
                    done += 1
                    continue
                digest, view, k, player = info
                entry = pending.get(digest)
                if entry is None:
                    pending[digest] = {"view": view, "player": player,
                                       "paths": [path]}
                else:   # wave-internal transposition: one submit, n paths
                    entry["paths"].append(path)
            waves += 1
            if not pending:
                continue
            timeout = self._remaining(t_end)
            futs: OrderedDict[str, object] = OrderedDict()
            for digest, entry in pending.items():
                try:
                    futs[digest] = self._evaluator.submit(
                        entry["view"], entry["player"], cfg.rank,
                        timeout_s=timeout)
                except Exception:  # noqa: BLE001 — door shed: lost sims
                    for path in entry["paths"]:
                        self._revert(path)
                        lost += 1
            leaves_submitted += len(futs)
            resolved = []
            for digest, fut in futs.items():
                entry = pending[digest]
                try:
                    row = np.asarray(
                        fut.result(timeout=self._remaining(t_end)))
                except Exception:  # noqa: BLE001 — kill/timeout mid-wave
                    for path in entry["paths"]:
                        self._revert(path)
                        lost += 1
                    continue
                resolved.append((digest, entry, row))
            values = self._leaf_values(
                [e["view"] for _, e, _ in resolved],
                [e["player"] for _, e, _ in resolved])
            for (digest, entry, row), z in zip(resolved, values):
                node = self.table.get(digest)
                if node is not None and not node.expanded:
                    node.expand(row, cfg.pass_prior)
                for path in entry["paths"]:
                    self._backup(path, float(z), entry["player"])
                    done += 1

        # -- move selection over root visits (actual frame) ----------------
        allowed = np.empty(NUM_EDGES, dtype=bool)
        allowed[:NUM_POINTS] = root.legal
        allowed[PASS_EDGE] = True
        if game.ko_point is not None:
            q = game.ko_point[0] * BOARD_SIZE + game.ko_point[1]
            allowed[int(INV_PERMS[root_k][q])] = False
        if self._root_mask is not None:
            allowed[:NUM_POINTS] &= self._root_mask
        counts = np.where(allowed, root.N, -1.0)
        if cfg.temperature > 0 and counts.max() > 0:
            w = np.where(allowed, np.maximum(root.N, 0.0), 0.0)
            w = w ** (1.0 / cfg.temperature)
            edge = int(self.rng.choice(NUM_EDGES, p=w / w.sum()))
        elif counts.max() > 0:
            edge = int(counts.argmax())
        else:   # zero completed sims: fall back to the root prior
            prior = np.where(allowed, root.P, -np.inf)
            edge = int(prior.argmax())
        move = -1 if edge == PASS_EDGE else int(PERMS[root_k][edge])
        q_move = (root.W[edge] / root.N[edge]) if root.N[edge] > 0 else 0.0
        pv = self._principal_variation(game)
        occupancy = (leaves_submitted / (waves * cfg.wave_size)
                     if waves else 0.0)
        return self._finish(game, search_id, move, float(q_move), done,
                            lost, waves, occupancy, t0, t_end, fallback,
                            pv, root=root, root_k=root_k,
                            root_digest=root_digest)

    def _principal_variation(self, game: GameState,
                             max_depth: int = 12) -> list[int]:
        """Max-visit walk from the root through the table: the moves (in
        the ACTUAL frame of each successive position) the search most
        believes in. Stops at unexpanded/unvisited nodes."""
        pv: list[int] = []
        g = _clone(game)
        for _ in range(max_depth):
            if g.done:
                break
            packed = summarize_state(g)
            digest, _, k = canonicalize(packed, g.player, self.cfg.rank)
            node = self.table.get(digest)
            if node is None or not node.expanded or node.N.max() <= 0:
                break
            allowed = np.empty(NUM_EDGES, dtype=bool)
            allowed[:NUM_POINTS] = node.legal
            allowed[PASS_EDGE] = True
            if g.ko_point is not None:
                q = g.ko_point[0] * BOARD_SIZE + g.ko_point[1]
                allowed[int(INV_PERMS[k][q])] = False
            counts = np.where(allowed, node.N, -1.0)
            if counts.max() <= 0:
                break
            edge = int(counts.argmax())
            move = -1 if edge == PASS_EDGE else int(PERMS[k][edge])
            pv.append(move)
            step_game(g, move, self.cfg.max_moves)
        return pv

    def _finish(self, game: GameState, search_id: str, move: int,
                value: float, done: int, lost: int, waves: int,
                occupancy: float, t0: float, t_end: float | None,
                fallback: bool, pv: list[int], root=None,
                root_k: int = 0, root_digest: str = "") -> SearchResult:
        duration = time.monotonic() - t0
        deadline_met = t_end is None or (t0 + duration) <= t_end + 0.05
        self._obs_waves.inc(waves)
        self._obs_rate.set(done / duration if duration > 0 else 0.0)
        self._obs_occupancy.set(occupancy)
        self._obs_nodes.set(len(self.table))
        if root is not None:
            visits = np.zeros(NUM_POINTS)
            # canonical edge p is actual point PERMS[k][p]
            visits[PERMS[root_k]] = np.maximum(root.N[:NUM_POINTS], 0.0)
            pass_visits = float(max(root.N[PASS_EDGE], 0.0))
        else:
            visits = np.zeros(NUM_POINTS)
            pass_visits = 0.0
        result = SearchResult(
            move=move, value=value, simulations=done, lost=lost,
            waves=waves, wave_occupancy=round(occupancy, 4),
            duration_s=round(duration, 6), deadline_met=deadline_met,
            fallback=fallback, pv=pv, search_id=search_id,
            root_digest=root_digest, visits=visits,
            pass_visits=pass_visits, tt=self.table.stats())
        if self._metrics is not None:
            try:
                self._metrics.write(
                    "search_request", search_id=search_id,
                    digest=root_digest, move=move, value=round(value, 4),
                    simulations=done, lost=lost, waves=waves,
                    wave_occupancy=round(occupancy, 4),
                    duration_s=round(duration, 6),
                    deadline_s=(None if t_end is None
                                else round(t_end - t0, 6)),
                    deadline_met=deadline_met, fallback=fallback,
                    pv=list(pv), tier=self.cfg.tier)
            except (OSError, ValueError):
                pass  # a full disk must not fail the search
        return result
