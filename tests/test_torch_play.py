"""The port's players against the JAX package's: agents, match, selfplay,
PUCT search and the workload replayer.

Games that go through a network are compared on the direct path
(``batched_log_probs``, no engine): which rung an engine dispatches a ply
on depends on timing. The network is 3 layers x 16 channels in float32,
its weights carried across by ``convert.model_from_jax``, with a sharp
N(0, 4) last-layer bias so the argmax has real margins; each such test
asserts that the smallest top-1 margin over legal points met in the run
is at least ``MARGIN_FACTOR`` times the largest difference between the
two packages' rows, so that agreement is not luck. Pure-numpy players
(random, heuristic, oneply) and the search over a deterministic fake
engine must agree exactly. Entry points run on ``cuda`` unless asked for
the CPU and raise without CUDA; here they run with ``device="cpu"``.
"""

import dataclasses
import os
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import REPO_ROOT
from deepgo_tpu import agents as jax_agents
from deepgo_tpu import match as jax_match
from deepgo_tpu import search as jax_search
from deepgo_tpu import selfplay as jax_selfplay
from deepgo_tpu.experiments.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from deepgo_tpu.models import policy_cnn as jax_policy
from deepgo_tpu.models.serving import make_policy_fn as jax_make_policy_fn
from deepgo_tpu.serving import replay as jax_replay

from deepgo_tpu_torch import agents, arena, match, search, selfplay
from deepgo_tpu_torch import sgf
from deepgo_tpu_torch.data.transcribe import transcribe_game
from deepgo_tpu_torch.go import replay_positions
from deepgo_tpu_torch.models import convert, policy_cnn, value_cnn
from deepgo_tpu_torch.models.serving import make_policy_fn
from deepgo_tpu_torch.obs import workload as wl
from deepgo_tpu_torch.ops import cuda_expand
from deepgo_tpu_torch.search.mcts import NUM_POINTS
from deepgo_tpu_torch.serving import (CacheConfig, EngineConfig,
                                      EngineOverloaded,
                                      close_shared_engines,
                                      fleet_policy_engine)
from deepgo_tpu_torch.serving import replay as rp
from deepgo_tpu_torch.utils.digest import INV_PERMS, PERMS, canonicalize

from test_search import RowEngine, Sink
from test_torch_policy import numpy_tree

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def private_jax_registry():
    """The JAX package's calls in this file count into a metrics registry
    of their own. Its process-wide one feeds the ``obs_snapshot`` of every
    later JAX run in this worker, and tests/test_attribution.py holds its
    run's train-step total to its own 30 steps."""
    from deepgo_tpu.obs import registry as jax_registry

    saved = jax_registry._default
    jax_registry._default = jax_registry.MetricsRegistry()
    yield
    jax_registry._default = saved

SGF_DIR = os.path.join(REPO_ROOT, "data/sgf")
CFG = policy_cnn.ModelConfig(num_layers=3, channels=16,
                             compute_dtype="float32")
MARGIN_FACTOR = 100


def sharp_tree(seed=0):
    tree = numpy_tree(CFG, seed=seed)
    last = tree["layers"][-1]
    last["b"] = np.random.default_rng(seed + 1).normal(
        0.0, 4.0, size=last["b"].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def nets():
    """(port model on the CPU, JAX params, JAX config) of the sharp net."""
    tree = sharp_tree()
    jcfg = jax_policy.ModelConfig(**dataclasses.asdict(CFG))
    return (convert.model_from_jax(tree, CFG, device="cpu"),
            jax.tree.map(jnp.asarray, tree), jcfg)


def sgfs(games):
    return [selfplay.to_sgf(g) for g in games]


def plain_stats(stats):
    return {k: v for k, v in stats.items()
            if k not in ("seconds", "positions_per_sec", "engine")}


class RowLog:
    """Rows of log-probs over legal points (-inf elsewhere), kept in call
    order, for the margin assertion."""

    def __init__(self):
        self.rows = []

    def wrap(self, agent):
        inner = agent._legal_log_probs

        def logged(packed, players, legal):
            out = inner(packed, players, legal)
            self.rows.append(np.asarray(out, np.float64))
            return out

        agent._legal_log_probs = logged
        return agent


def assert_margin(port_rows, jax_rows):
    """Same legal sets, and the smallest top-1 margin over legal points is
    at least MARGIN_FACTOR times the largest row difference."""
    assert len(port_rows) == len(jax_rows) > 0
    diff, margin = 0.0, np.inf
    for a, b in zip(port_rows, jax_rows):
        assert a.shape == b.shape
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin)
        if fin.any():
            diff = max(diff, float(np.abs(a[fin] - b[fin]).max()))
        for row, ok in zip(b, fin):
            if ok.sum() >= 2:
                top2 = np.sort(row[ok])[-2:]
                margin = min(margin, float(top2[1] - top2[0]))
    assert margin >= MARGIN_FACTOR * diff, (margin, diff)
    return margin, diff


# ---- pure-numpy players and the match harness ----


@pytest.mark.parametrize("a,b", [("random", "heuristic"),
                                 ("oneply", "heuristic"),
                                 ("oneply", "random")])
def test_numpy_match_equal_across_packages(a, b):
    kw = dict(n_games=6, max_moves=100, seed=7, opening_plies=4)
    games, scores, stats = match.play_match(
        agents._make_agent(a, 0), agents._make_agent(b, 1), **kw)
    jgames, jscores, jstats = jax_match.play_match(
        jax_agents._make_agent(a, 0), jax_agents._make_agent(b, 1), **kw)
    assert sgfs(games) == [jax_selfplay.to_sgf(g) for g in jgames]
    assert [(s.black, s.white) for s in scores] == [
        (s.black, s.white) for s in jscores]
    assert plain_stats(stats) == plain_stats(jstats)


def test_standard_gate_equal_at_a_small_count():
    """``standard_gate`` under its pinned protocol at 4 games, not the
    1,000 of the production gate."""
    games, _, stats = match.standard_gate(
        agents.OnePlyAgent(), agents.RandomAgent(), n_games=4, max_moves=60)
    jgames, _, jstats = jax_match.standard_gate(
        jax_agents.OnePlyAgent(), jax_agents.RandomAgent(), n_games=4,
        max_moves=60)
    assert stats["protocol"] == jstats["protocol"]
    assert stats["win_rate_a"] == jstats["win_rate_a"]
    assert sgfs(games) == [jax_selfplay.to_sgf(g) for g in jgames]


@pytest.mark.parametrize("kind", ["policy", "policy-search", "twoply"])
def test_net_agents_equal_across_packages(nets, kind):
    model, jparams, jcfg = nets
    cls, jcls = {"policy": (agents.PolicyAgent, jax_agents.PolicyAgent),
                 "policy-search": (agents.PolicySearchAgent,
                                   jax_agents.PolicySearchAgent),
                 "twoply": (agents.TwoPlyAgent, jax_agents.TwoPlyAgent)}[kind]
    log, jlog = RowLog(), RowLog()
    mine = log.wrap(cls(model, CFG, device="cpu"))
    ref = jlog.wrap(jcls(jparams, jcfg))
    kw = dict(n_games=4, max_moves=60, seed=3, opening_plies=4)
    games, _, stats = match.play_match(mine, agents.OnePlyAgent(), **kw)
    jgames, _, jstats = jax_match.play_match(ref, jax_agents.OnePlyAgent(),
                                             **kw)
    assert sgfs(games) == [jax_selfplay.to_sgf(g) for g in jgames]
    assert plain_stats(stats) == plain_stats(jstats)
    assert_margin(log.rows, jlog.rows)


class DirectEngine:
    """The direct path in the engine's submit shape: one board per
    ``batched_log_probs`` call, resolved at once; keeps each row masked to
    the board's legal points for the margin assertion."""

    def __init__(self, log_probs):
        self.rows = []
        self._log_probs = log_probs

    def submit(self, packed, player, rank):
        row = self._log_probs(packed[None], np.array([player], np.int32),
                              np.array([rank], np.int32))[0]
        legal = selfplay.legal_mask(packed[None], np.array([player]))[0]
        self.rows.append(np.where(legal, row, -np.inf)[None])
        f = Future()
        f.set_result(row)
        return f

    def stats(self):
        return {}


def test_selfplay_equal_across_packages_on_the_direct_path(nets):
    model, jparams, jcfg = nets
    predict = make_policy_fn(CFG, top_k=1, device="cpu")
    jpredict = jax_make_policy_fn(jcfg, top_k=1)
    eng = DirectEngine(lambda *a: selfplay.batched_log_probs(
        predict, model, *a))
    jeng = DirectEngine(lambda *a: jax_selfplay.batched_log_probs(
        jpredict, jparams, *a))
    kw = dict(n_games=3, max_moves=90, temperature=0.0, seed=0)
    games, stats = selfplay.self_play(model, CFG, engine=eng, device="cpu",
                                      **kw)
    jgames, jstats = jax_selfplay.self_play(jparams, jcfg, engine=jeng, **kw)
    assert sgfs(games) == [jax_selfplay.to_sgf(g) for g in jgames]
    assert stats["positions"] == jstats["positions"] > 100
    assert_margin(eng.rows, jeng.rows)


# ---- selfplay and agents on the port's engines (CPU) ----


def replay_legal(game):
    """The game's SGF through the port's rules and transcription: raises
    on an illegal move; returns the packed records."""
    parsed = sgf.parse(selfplay.to_sgf(game))
    records = np.stack([p for p, _ in replay_positions(parsed)])
    assert len(records) == len(game.moves)
    return records, parsed


@pytest.mark.parametrize("mode", ["engine", "supervised", "fleet"])
def test_self_play_through_the_engines(nets, mode, tmp_path):
    model = nets[0]
    kw = {"supervised": mode == "supervised",
          "fleet": 2 if mode == "fleet" else 0}
    cuda_expand.reset_launches()
    games, stats = selfplay.self_play(model, CFG, n_games=6, max_moves=24,
                                      temperature=0.5, seed=1, device="cpu",
                                      **kw)
    assert cuda_expand.launches == 0  # the CPU takes the plain expansion
    assert stats["positions"] >= sum(len(g.moves) for g in games) > 0
    for i, g in enumerate(games):
        records, _ = replay_legal(g)
        path = tmp_path / f"g{i}.sgf"
        path.write_text(selfplay.to_sgf(g))
        packed, meta = transcribe_game(str(path))
        assert np.array_equal(packed, records)
        assert [tuple(r[:3]) for r in meta] == [
            (m.player, m.x, m.y) for m in g.moves]
    eng = stats["engine"]
    if mode == "fleet":
        assert sum(r["forwards"] for r in eng["replicas"]) > 0
    else:
        assert eng["forwards"] > 0


def test_entry_points_raise_without_cuda(nets):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    model = nets[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        selfplay.self_play(model, CFG, n_games=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        agents._make_agent("model:small", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        agents.PolicyAgent(model, CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        selfplay.main(["--games", "1", "--model", "small"])
    with pytest.raises(RuntimeError, match="CUDA"):
        match.main(["--a", "model:small", "--b", "random", "--games", "2"])


def test_mains_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "sp"
    selfplay.main(["--games", "2", "--model", "small", "--max-moves", "12",
                   "--temperature", "0.5", "--device", "cpu", "--sgf-out",
                   str(out)])
    assert "positions_per_sec" in capsys.readouterr().out
    for name in sorted(os.listdir(out)):
        packed, _ = transcribe_game(str(out / name))
        game = sgf.parse_file(str(out / name))
        assert np.array_equal(packed, np.stack(
            [p for p, _ in replay_positions(game)]))
    match.main(["--a", "model:small", "--b", "oneply", "--games", "2",
                "--max-moves", "16", "--device", "cpu", "--sgf-out",
                str(tmp_path / "m")])
    printed = capsys.readouterr().out
    assert "init-small_win_rate" in printed
    assert len(os.listdir(tmp_path / "m")) == 2


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A policy and a value checkpoint, both written by the JAX package."""
    root = tmp_path_factory.mktemp("ckpt")
    policy = str(root / "policy.npz")
    jax_save_checkpoint(policy, jax.tree.map(jnp.asarray, sharp_tree()), {},
                        {"config": {"num_layers": 3, "channels": 16,
                                    "compute_dtype": "float32"}})
    vcfg = value_cnn.ValueConfig(num_layers=2, channels=8, head_hidden=16,
                                 compute_dtype="float32")
    vmodel = value_cnn.init(torch.Generator().manual_seed(0), vcfg,
                            device="cpu")
    value = str(root / "value.npz")
    jax_save_checkpoint(value, jax.tree.map(
        jnp.asarray, convert.value_to_jax(vmodel)), {}, {
            "kind": "value", "step": 1,
            "config": {"num_layers": 2, "channels": 8, "head_hidden": 16,
                       "compute_dtype": "float32"}})
    return policy, value


def some_positions():
    games = [selfplay.GameState() for _ in range(3)]
    for i, g in enumerate(games):
        for m in (60, 61 + i, 80, 100 + 2 * i)[: i + 1]:
            selfplay.step_game(g, m, 450)
    packed = selfplay.summarize_states(games)
    players = np.array([g.player for g in games], dtype=np.int32)
    return packed, players, selfplay.legal_mask(packed, players, games)


@pytest.mark.parametrize("spec,cls,use_engine", [
    ("checkpoint:{p}", agents.PolicyAgent, False),
    ("checkpoint:{p}", agents.PolicyAgent, True),
    ("search:{p}", agents.PolicySearchAgent, False),
    ("search2:{p}", agents.TwoPlyAgent, "supervised"),
    ("value:{p}:{v}", agents.ValueSearchAgent, False),
    ("value2:{p}:{v}", agents.Value2PlyAgent, True),
    ("mcts:{p}:{v}", agents.SearchAgent, False),
    ("model:small", agents.PolicyAgent, False),
])
def test_make_agent_specs_on_the_cpu(checkpoints, spec, cls, use_engine):
    p, v = checkpoints
    try:
        agent = agents._make_agent(spec.format(p=p, v=v), 0,
                                   use_engine=use_engine, search_sims=8,
                                   device="cpu")
        assert type(agent) is cls
        packed, players, legal = some_positions()
        moves = agent.select_moves(packed, players, legal,
                                   np.random.default_rng(0))
        for i, m in enumerate(moves):
            assert m == -1 or legal[i][m]
    finally:
        close_shared_engines()


def test_checkpoint_agent_plays_the_jax_weights(checkpoints, nets):
    agent = agents._make_agent(f"checkpoint:{checkpoints[0]}", 0,
                               device="cpu")
    for a, b in zip(agent.params.state_dict().values(),
                    nets[0].state_dict().values()):
        assert torch.equal(a, b)


def test_arena_reexports_match_the_jax_shim():
    from deepgo_tpu import arena as jax_arena

    names = {n for n in dir(jax_arena) if not n.startswith("__")}
    assert names - {"annotations"} <= set(dir(arena))


def test_variant_needs_the_engine_path(nets):
    with pytest.raises(ValueError, match="engine"):
        agents._policy_engine_for(nets[0], CFG, False, variant="int8",
                                  device="cpu")


# ---- PUCT search ----


def played(mod, moves):
    g = mod.GameState()
    for m in moves:
        mod.step_game(g, m, 450)
    return g


def run_search(pkg, moves, sims=32, **cfg):
    mod = search if pkg == "port" else jax_search
    sp = selfplay if pkg == "port" else jax_selfplay
    s = mod.Search(RowEngine(), mod.SearchConfig(simulations=sims,
                                                 wave_size=8, **cfg))
    return s, s.search(played(sp, moves))


@pytest.mark.parametrize("moves", [[], [3 * 19 + 3, 15 * 19 + 15,
                                        3 * 19 + 15], [60, 61, 80, -1]])
def test_search_equal_across_packages(moves):
    _, a = run_search("port", moves)
    _, b = run_search("jax", moves)
    for key in ("move", "pv", "root_digest", "value", "simulations", "lost",
                "waves", "wave_occupancy", "pass_visits", "fallback"):
        assert getattr(a, key) == getattr(b, key), key
    np.testing.assert_array_equal(a.visits, b.visits)
    assert {k: v for k, v in a.tt.items()} == b.tt


def test_search_accounting_virtual_loss_and_dedup():
    eng = RowEngine()
    s = search.Search(eng, search.SearchConfig(simulations=48, wave_size=16))
    g = selfplay.GameState()
    res = s.search(g)
    node = s.table.get(res.root_digest)
    assert res.simulations == 48 and res.lost == 0 and not res.fallback
    assert float(node.N.sum()) == 48.0
    assert float(res.visits.sum() + res.pass_visits) == 48.0
    np.testing.assert_array_equal(node.W, np.zeros_like(node.W))
    keys = [(c[0], c[1]) for c in eng.calls]
    assert len(keys) == len(set(keys))  # one submit per canonical position
    assert {c[3] for c in eng.calls} == {f"search:{res.search_id}"}


def test_search_lost_simulations_revert_bitwise():
    eng = RowEngine(fail_at={3, 7}, error_at={5, 9, 11})
    s = search.Search(eng, search.SearchConfig(simulations=40, wave_size=8))
    res = s.search(selfplay.GameState())
    assert res.lost >= 5 and res.simulations + res.lost == 40
    node = s.table.get(res.root_digest)
    assert float(node.N.sum()) == float(res.simulations)
    np.testing.assert_array_equal(node.W, np.zeros_like(node.W))


def test_search_determinism():
    moves = [3 * 19 + 3, 15 * 19 + 15, 3 * 19 + 15]
    _, r1 = run_search("port", moves)
    _, r2 = run_search("port", moves)
    assert (r1.move, r1.pv, r1.root_digest, r1.value) == (
        r2.move, r2.pv, r2.root_digest, r2.value)
    np.testing.assert_array_equal(r1.visits, r2.visits)


@pytest.mark.parametrize("k", range(8))
def test_transposition_remaps_through_inverse_perms_bitwise(k):
    g = played(selfplay, [3 * 19 + 3, 15 * 19 + 15, 3 * 19 + 4,
                          15 * 19 + 3])
    t = selfplay.GameState()
    t.stones = g.stones.reshape(-1)[PERMS[k]].reshape(19, 19).copy()
    t.age = g.age.reshape(-1)[PERMS[k]].reshape(19, 19).copy()
    t.player = g.player
    cfg = search.SearchConfig(simulations=24, wave_size=8)
    a = search.Search(RowEngine(), cfg).search(g)
    b = search.Search(RowEngine(), cfg).search(t)
    assert b.root_digest == a.root_digest and a.move >= 0
    assert b.move == int(INV_PERMS[k][a.move])
    np.testing.assert_array_equal(b.visits, a.visits[PERMS[k]])
    assert b.value == a.value


def test_search_anytime_contract_and_event():
    res = search.Search(RowEngine(fail_at=set(range(1000))),
                        search.SearchConfig(simulations=24)).search(
        selfplay.GameState())
    assert res.fallback and res.simulations == 0 and res.move == 0
    t0 = time.monotonic()
    res = search.Search(RowEngine(stall=True),
                        search.SearchConfig(simulations=24)).search(
        selfplay.GameState(), deadline_s=0.3)
    assert res.fallback and res.move == 0 and time.monotonic() - t0 < 2.0
    sink = Sink()
    res = search.Search(RowEngine(), search.SearchConfig(simulations=16),
                        metrics=sink).search(selfplay.GameState())
    assert [k for k, _ in sink.events] == ["search_request"]
    assert sink.events[0][1]["move"] == res.move


def test_tree_reuse_and_game_from_packed():
    table = search.TranspositionTable()
    eng = RowEngine()
    cfg = search.SearchConfig(simulations=24, wave_size=8)
    res = search.Search(eng, cfg, table=table).search(selfplay.GameState())
    g2 = played(selfplay, [res.move])
    d2, _, _ = canonicalize(selfplay.summarize_state(g2), g2.player, 9)
    assert table.get(d2) is not None and table.get(d2).expanded
    packed = selfplay.summarize_state(g2)
    back = search.game_from_packed(packed, g2.player)
    np.testing.assert_array_equal(selfplay.summarize_state(back), packed)


def test_search_agent_and_move_selector():
    agent = agents.SearchAgent(None, CFG, simulations=8, engine=RowEngine(),
                               device="cpu",
                               search_config=search.SearchConfig(
                                   simulations=8, wave_size=4))
    packed, players, legal = some_positions()
    moves = agent.select_moves(packed, players, legal,
                               np.random.default_rng(0))
    assert all(m == -1 or legal[i][m] for i, m in enumerate(moves))
    selector = search.make_move_selector(RowEngine(), search.SearchConfig(
        simulations=8, wave_size=4, temperature=1.0, root_noise_frac=0.25,
        tier="selfplay"))
    games = [selfplay.GameState(), played(selfplay, [60, 80])]
    pk = selfplay.summarize_states(games)
    pl = np.array([g.player for g in games], dtype=np.int32)
    lg = selfplay.legal_mask(pk, pl, games)
    chosen = selector(games, pk, pl, lg, np.random.default_rng(0))
    assert all(m == -1 or lg[i][m] for i, m in enumerate(chosen))
    assert NUM_POINTS == 361


# ---- the workload replayer ----


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += max(dt, 0.0)


class ScriptedEngine:
    def __init__(self):
        self.seen = []

    def submit(self, packed, player, rank, timeout_s=None, tier=None):
        self.seen.append(tier)
        f = Future()
        f.set_result(np.float32(packed.sum()))
        return f


def trace(n=20, gap=0.05):
    rng = np.random.default_rng(5)
    boards = rng.integers(0, 3, size=(4, 9, 19, 19), dtype=np.uint8)
    return [{"t": 100.0 + i * gap, "packed": boards[i % 4],
             "player": 1 + i % 2, "rank": 5,
             "tier": ("interactive", "selfplay", "batch")[i % 3]}
            for i in range(n)]


def test_fake_clock_replay_is_exact():
    clk = FakeClock()
    eng = ScriptedEngine()
    report = rp.WorkloadReplayer(eng, trace(), speed=2.0, clock=clk,
                                 sleep=clk.sleep).run()
    assert report["requests"] == 20 and report["fidelity_ok"] is True
    assert report["span_error_frac"] == 0.0 and report["mean_lag_ms"] == 0.0
    assert report["tiers"] == {"batch": 6, "interactive": 7, "selfplay": 7}
    assert eng.seen[:3] == ["interactive", "selfplay", "batch"]
    assert report["target_span_s"] == pytest.approx(0.475)


def test_real_clock_fidelity_within_bar():
    report = rp.WorkloadReplayer(ScriptedEngine(),
                                 trace(n=12, gap=0.025)).run()
    assert report["fidelity_ok"] is True
    assert report["span_error_frac"] <= 0.10 and report["lag_frac"] <= 0.10


def test_replay_outcomes_untiered_shed_failed_and_typed_errors():
    class Flaky:
        def __init__(self):
            self.n = 0

        def submit(self, packed, player, rank, timeout_s=None):
            self.n += 1
            if self.n % 3 == 0:
                raise EngineOverloaded("full")
            f = Future()
            if self.n % 3 == 1:
                f.set_result(np.float32(0))
            else:
                f.set_exception(RuntimeError("boom"))
            return f

    clk = FakeClock()
    report = rp.WorkloadReplayer(Flaky(), trace(n=9), clock=clk,
                                 sleep=clk.sleep).run()
    assert report["outcomes"] == {"ok": 3, "shed": 3, "failed": 3}
    with pytest.raises(ValueError):
        rp.WorkloadReplayer(ScriptedEngine(), [])
    with pytest.raises(ValueError):
        rp.WorkloadReplayer(ScriptedEngine(), trace(), speed=0)


def test_synthetic_requests_equal_across_packages(tmp_path):
    spec = dict(requests=64, games=4, opening_moves=6, seed=11)
    mine = rp.build_synthetic_requests(SGF_DIR, **spec)
    ref = jax_replay.build_synthetic_requests(SGF_DIR, **spec)
    assert len(mine) == len(ref) == 64
    for a, b in zip(mine, ref):
        assert (a["t"], a["player"], a["rank"], a["tier"]) == (
            b["t"], b["player"], b["rank"], b["tier"])
        assert np.array_equal(a["packed"], b["packed"])
    rp.write_synthetic_capture(str(tmp_path / "mine"), mine)
    jax_replay.write_synthetic_capture(str(tmp_path / "ref"), ref)
    for name in ("workload.jsonl", "positions.jsonl"):
        with open(tmp_path / "mine" / name) as f, \
                open(tmp_path / "ref" / name) as g:
            assert len(f.readlines()) == len(g.readlines())
    items = rp.load_trace(str(tmp_path / "ref"))
    assert len(items) == 64
    for a, b in zip(items, mine):
        assert np.array_equal(a["packed"], b["packed"])
    stats = wl.analyze_capture(str(tmp_path / "mine"))
    assert stats["dup_ratio"] > 0.4 and stats["replayable"] is True
    with pytest.raises(wl.WorkloadCaptureError):
        rp.build_synthetic_requests(str(tmp_path / "none"), requests=4)


def test_replay_into_a_cpu_fleet_with_the_cache(nets):
    items = rp.build_synthetic_requests(SGF_DIR, requests=48, games=4,
                                        opening_moves=6, rate_per_s=2000.0)
    fleet = fleet_policy_engine(nets[0], CFG, replicas=2, device="cpu",
                                config=EngineConfig(buckets=(1, 8, 32),
                                                    max_wait_ms=2.0),
                                cache=CacheConfig())
    try:
        report = rp.WorkloadReplayer(fleet, items).run()
        cache = fleet.stats()["fleet"]["cache"]
    finally:
        fleet.close()
    assert report["outcomes"] == {"ok": 48}
    assert cache["hits"] + cache["coalesced"] > 0
