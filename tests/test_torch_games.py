"""The port's rules engine, SGF reader and transcription against the JAX
package's.

Every module here is a copy of a jax-free module of the JAX package
(``go/``, ``sgf``, ``data/transcribe``, ``data/split``), so the bar is
equality: packed records bitwise (Python and native engines, on random
legal positions), scores, ladders and parsed games equal, the native
source byte-equal, and the transcription of ``data/sgf`` byte-equal file
by file. The native engine is run with ``n_threads=2``: the tests run
beside other workers.
"""

import os
import threading

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from deepgo_tpu import go as jax_go
from deepgo_tpu import sgf as jax_sgf
from deepgo_tpu.data import split as jax_split
from deepgo_tpu.data import transcribe as jax_transcribe
from deepgo_tpu.go import ladders as jax_ladders
from deepgo_tpu.go import scoring as jax_scoring

from deepgo_tpu_torch import go, sgf
from deepgo_tpu_torch.data import split, transcribe
from deepgo_tpu_torch.go import ladders, native, scoring
from deepgo_tpu_torch.selfplay import (GameState, apply_move, legal_mask,
                                       step_games)

torch.set_num_threads(2)

SGF_ROOT = os.path.join(REPO_ROOT, "data/sgf")
SPLITS = ("train", "validation", "test")
THREADS = 2
GAMES, PLIES = 4, 60  # 240 random legal positions


@pytest.fixture
def compiler():
    """Skips where the host has no C++ compiler (the native engine cannot
    build; the Python engine serves)."""
    if native.find_compiler() is None:
        pytest.skip("no host C++ compiler")


def random_positions(seed=0):
    """(stones, age) snapshots of GAMES random games, one per ply: each ply
    plays a uniformly random legal point (empty, not suicide, not a banned
    ko recapture) through the port's ``apply_move``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(GAMES):
        g = GameState()
        for _ in range(PLIES):
            out.append((g.stones.copy(), g.age.copy(), g.player))
            packed = go.summarize(g.stones, g.age)
            legal = legal_mask(packed[None], np.array([g.player]), [g])[0]
            move = int(rng.choice(np.flatnonzero(legal)))
            apply_move(g, *divmod(move, 19))
            g.player = 3 - g.player
    return out


@pytest.fixture(scope="module")
def positions():
    return random_positions()


def test_public_names_match():
    for mine, ref in ((go, jax_go), (sgf, jax_sgf)):
        names = {n for n in dir(ref) if not n.startswith("__")}
        assert names - {"native", "annotations"} <= set(dir(mine))


def test_summarize_python_bitwise_on_random_positions(positions):
    assert len(positions) >= 200
    for stones, age, _ in positions:
        want = jax_go.summarize(stones, age)
        assert np.array_equal(go.summarize(stones, age), want)


def test_summarize_native_bitwise_on_random_positions(compiler, positions):
    stones = np.stack([p[0] for p in positions])
    age = np.stack([p[1] for p in positions])
    got = native.summarize_batch_native(stones, age, n_threads=THREADS)
    want = np.stack([jax_go.summarize(s, a) for s, a, _ in positions])
    assert np.array_equal(got, want)
    for i in range(0, len(positions), 17):
        assert np.array_equal(native.summarize_native(stones[i], age[i]),
                              want[i])


@pytest.mark.parametrize("komi", [0.0, 0.5, 7.5])
def test_area_score_equal(positions, komi):
    for stones, _, _ in positions[::3]:
        a = scoring.area_score(stones, komi=komi)
        b = jax_scoring.area_score(stones, komi=komi)
        assert (a.black, a.white, a.komi, a.winner, a.margin,
                a.result_string()) == (b.black, b.white, b.komi, b.winner,
                                       b.margin, b.result_string())


def test_ladder_moves_equal(positions):
    seen = 0
    for stones, _, _ in positions[::4]:
        for x, y in zip(*np.nonzero(stones)):
            grp, libs = go.group_and_liberties(stones, int(x), int(y))
            if len(libs) != 2 or min(grp) != (x, y):
                continue
            a = ladders.ladder_moves(stones.copy(), int(x), int(y), set(libs))
            b = jax_ladders.ladder_moves(stones.copy(), int(x), int(y),
                                         set(libs))
            assert a == b
            seen += 1
    assert seen >= 20


SGF_TEXTS = (
    "(;GM[1]FF[4]SZ[19]BR[9d]WR[3d];B[pd];W[dd];B[pq])",
    "(;GM[1]\r\nFF[4]\r\nBR[5d]\r\nWR[5d]\r\n;B[aa]\r\n;W[ss])",
    "(;BR[1d]WR[1d];B[pd];W[];B[tt];W[dd])",
    "(;BR[2d]WR[2d]AB[pd][dp]AW[dd]AB[pp];B[qq])",
    "(;BR[3k]WR[2d];B[pd])",
    "(;BR[10d]WR[2d];B[pd])",
    "(;C[a \\] comment]BR[4d]\nWR[4d];B[pd]\n;W[zz];B[dd])",
)


def game_key(g):
    return ([(m.player, m.x, m.y) for m in g.moves],
            [(m.player, m.x, m.y) for m in g.handicaps], g.ranks,
            g.properties)


def test_sgf_parse_equal():
    paths = transcribe.find_sgfs(SGF_ROOT)
    assert paths == jax_transcribe.find_sgfs(SGF_ROOT) and len(paths) == 22
    for p in paths:
        assert game_key(sgf.parse_file(p)) == game_key(jax_sgf.parse_file(p))
    for text in SGF_TEXTS:
        assert game_key(sgf.parse(text)) == game_key(jax_sgf.parse(text))
    for x in range(19):
        assert sgf.coord_to_sgf(x, 18 - x) == jax_sgf.coord_to_sgf(x, 18 - x)


def test_replay_positions_equal():
    path = os.path.join(SGF_ROOT, "validation/1950-59/2000-03-24a.sgf")
    mine = list(go.replay_positions(sgf.parse_file(path)))
    ref = list(jax_go.replay_positions(jax_sgf.parse_file(path)))
    assert len(mine) == len(ref) > 100
    for (a, ma), (b, mb) in zip(mine, ref):
        assert (ma.player, ma.x, ma.y) == (mb.player, mb.x, mb.y)
        assert np.array_equal(a, b)


# ---- the native library ----


def test_goboard_source_byte_equal():
    with open(native.SOURCE, "rb") as f:
        mine = f.read()
    with open(os.path.join(REPO_ROOT, "native/goboard.cpp"), "rb") as f:
        assert mine == f.read()


def test_native_library_builds_in_the_port(compiler):
    assert native.available() and native.batch_available()
    path = native.library_path()
    assert path.exists()
    assert path.parent == native.BUILD_DIR
    assert os.path.join("deepgo_tpu_torch", "go", "build") in str(path)
    assert os.path.join("native", "build") not in str(path)


def test_concurrent_builds_make_one_library(compiler, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    target = native.library_path()
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        native._build(target))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert results == [True, True] and target.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [target.name, "lock"])


def test_native_transcribe_and_illegal_moves(compiler):
    game = sgf.parse("(;BR[9d]WR[9d]AB[pd][dp]AW[dd];B[qq];W[oc])")
    got = native.transcribe_game_native(game.handicaps, game.moves)
    assert np.array_equal(got, np.stack([p for p, _ in
                                         go.replay_positions(game)]))
    bad = sgf.parse("(;BR[1d]WR[1d];B[aa];W[aa])")
    with pytest.raises(go.IllegalMoveError):
        native.transcribe_game_native(bad.handicaps, bad.moves)
    stones, age = go.new_board()
    stones[3, 3] = 1
    with pytest.raises(go.IllegalMoveError):
        native.play_batch_native(stones[None].copy(), age[None].copy(),
                                 np.array([3 * 19 + 3]), np.array([2]),
                                 n_threads=THREADS)


def test_play_batch_matches_apply_move(compiler, positions):
    """One native call over many boards equals the port's Python
    ``apply_move`` per board: stones, ages and simple-ko points."""
    rng = np.random.default_rng(3)
    boards, moves, players, want = [], [], [], []
    for stones, age, player in positions[::2]:
        g = GameState()
        g.stones[:], g.age[:], g.player = stones, age, player
        packed = go.summarize(stones, age)
        legal = legal_mask(packed[None], np.array([player]))[0]
        move = int(rng.choice(np.flatnonzero(legal)))
        boards.append((stones.copy(), age.copy()))
        moves.append(move)
        players.append(player)
        apply_move(g, *divmod(move, 19))
        want.append((g.stones, g.age, -1 if g.ko_point is None
                     else g.ko_point[0] * 19 + g.ko_point[1]))
    stones = np.stack([b[0] for b in boards])
    age = np.stack([b[1] for b in boards])
    ko = native.play_batch_native(stones, age, np.array(moves),
                                  np.array(players), n_threads=THREADS)
    for i, (s, a, k) in enumerate(want):
        assert np.array_equal(stones[i], s) and np.array_equal(age[i], a)
        assert ko[i] == k


def test_step_games_native_and_python_agree(monkeypatch):
    def build():
        gs = [GameState() for _ in range(4)]
        gs[0].done = True
        gs[1].passes = 1
        gs[2].ko_point = (3, 3)
        return gs

    results = []
    for use_native in (True, False):
        if not use_native:
            monkeypatch.setattr(native, "batch_available", lambda: False)
        gs = build()
        step_games(gs, [5, -1, -1, 42], max_moves=100)
        assert gs[0].moves == [] and gs[0].player == 1
        assert gs[1].done and gs[1].passes == 2
        assert gs[2].ko_point is None and not gs[2].done
        assert len(gs[3].moves) == 1 and gs[3].player == 2
        results.append([(g.stones.tobytes(), g.age.tobytes(), g.player)
                        for g in gs])
    assert results[0] == results[1]


# ---- transcription and split ----


def shard_files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def reference_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax-shards")
    for s in SPLITS:
        jax_transcribe.transcribe_split(os.path.join(SGF_ROOT, s),
                                        str(root / s), workers=1,
                                        verbose=False, engine="native")
    return root


def test_transcribe_native_byte_equal(compiler, reference_shards, tmp_path):
    for s in SPLITS:
        n = transcribe.transcribe_split(os.path.join(SGF_ROOT, s),
                                        str(tmp_path / s), workers=1,
                                        verbose=False, engine="native")
        assert n > 0
    want = shard_files(reference_shards)
    assert len(want) == 3 * len(SPLITS)  # planes.bin, meta.npy, games.json
    assert shard_files(tmp_path) == want


@pytest.mark.parametrize("split_name", ["validation", "test"])
def test_transcribe_python_engine_byte_equal(reference_shards, tmp_path,
                                             split_name):
    """The Python engine on the two small splits: the 4,000-position train
    split, far slower in Python, is held by the native engine above."""
    n = transcribe.transcribe_split(os.path.join(SGF_ROOT, split_name),
                                    str(tmp_path), workers=1, verbose=False,
                                    engine="python")
    assert n > 100
    assert shard_files(tmp_path) == shard_files(reference_shards
                                                 / split_name)


def test_transcribe_game_equal():
    for p in transcribe.find_sgfs(os.path.join(SGF_ROOT, "test")):
        a = transcribe.transcribe_game(p, engine="python")
        b = jax_transcribe.transcribe_game(p, engine="python")
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_transcribe_skips_games_without_ranks(tmp_path):
    p = tmp_path / "g.sgf"
    p.write_text("(;BR[3k]WR[2d];B[pd];W[dd])")
    assert transcribe.transcribe_game(str(p), engine="python") is None
    assert jax_transcribe.transcribe_game(str(p), engine="python") is None


def test_scatter_same_assignment(tmp_path):
    sizes = {"a": 7, "b": 5, "c": 20}
    for seed in (0, 3):
        got = split.scatter(os.path.join(SGF_ROOT, "train"),
                            str(tmp_path / f"port{seed}"), sizes, seed=seed)
        want = jax_split.scatter(os.path.join(SGF_ROOT, "train"),
                                 str(tmp_path / f"jax{seed}"), sizes,
                                 seed=seed)
        assert got == want == {"a": 7, "b": 5, "c": 8}
        assert shard_files(tmp_path / f"port{seed}") == shard_files(
            tmp_path / f"jax{seed}")
