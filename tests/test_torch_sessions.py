"""The port's durable game sessions against the JAX package's.

Every scenario of ``tests/test_sessions.py`` runs against the port's
classes over the same ``StubFleet``. Across the packages, one move list
gives the same ``GoGame.digest()``, and a store written by either package
(checkpoints and WAL) recovers in the other to the same games. The port's
``sessions.child`` is SIGKILLed right after an ack and rerun: no acked
move is lost and the finished games' digests equal a never-killed run's,
with scripted replies (``--no-engine``) and with a CPU fleet.
"""

import json
import os
import random
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepgo_tpu import sessions as jax_sessions
from deepgo_tpu_torch.go.board import BLACK, WHITE
from deepgo_tpu_torch.go.replay import replay_positions
from deepgo_tpu_torch.go.summarize import summarize
from deepgo_tpu_torch.obs import workload as workload_mod
from deepgo_tpu_torch.sessions import (GameService, GoGame, IllegalMove,
                                       ReplyExhausted, SessionCorrupt,
                                       SessionNotFound, SessionStore,
                                       SgfAnalysisService)
from deepgo_tpu_torch.sessions.analysis import AnalysisCursorError
from deepgo_tpu_torch.sgf import parse_file
from deepgo_tpu_torch.utils import faults

from conftest import REPO_ROOT
from test_sessions import PINNED_SGF, EngineOverloaded, StubFleet

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


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DEEPGO_FAULTS", raising=False)
    faults.reset()
    yield
    faults.reset()


# ---- legality edges ----


class TestLegality:
    def test_turn_order_and_occupied(self):
        g = GoGame("t")
        assert "out of turn" in g.check_move(3, 3, WHITE)
        g.play_move(3, 3, BLACK)
        assert "occupied" in g.check_move(3, 3, WHITE)
        with pytest.raises(IllegalMove) as ei:
            g.play_move(3, 3, WHITE)
        assert ei.value.session_id == "t"
        assert "occupied" in ei.value.reason

    def test_suicide_refused(self):
        g = GoGame("s", handicaps=((WHITE, 0, 1), (WHITE, 1, 0)))
        g.play_move(10, 10, WHITE)
        reason = g.check_move(0, 0, BLACK)
        assert reason is not None and "suicide" in reason
        with pytest.raises(IllegalMove):
            g.play_move(0, 0, BLACK)
        assert g.to_play == BLACK and len(g.moves) == 1

    def test_capture_in_corner_is_not_suicide(self):
        g = GoGame("c", handicaps=((WHITE, 0, 0), (BLACK, 0, 1),
                                   (BLACK, 2, 0)))
        g.play_move(10, 10, WHITE)
        assert g.check_move(1, 0, BLACK) is None
        kills = g.play_move(1, 0, BLACK)
        assert kills == 1 and g.captures[BLACK] == 1

    def test_positional_superko(self):
        g = GoGame("ko", handicaps=(
            (BLACK, 4, 5), (BLACK, 5, 4), (BLACK, 6, 5),
            (WHITE, 4, 6), (WHITE, 5, 7), (WHITE, 6, 6),
            (BLACK, 5, 6),
        ))
        assert g.check_move(5, 5, WHITE) is None
        assert g.play_move(5, 5, WHITE) == 1
        reason = g.check_move(5, 6, BLACK)
        assert reason is not None and "superko" in reason
        with pytest.raises(IllegalMove):
            g.play_move(5, 6, BLACK)
        g.play_move(15, 15, BLACK)
        g.play_move(15, 16, WHITE)
        assert g.check_move(5, 6, BLACK) is None
        assert g.play_move(5, 6, BLACK) == 1

    def test_pass_pass_ends_the_game(self):
        g = GoGame("p")
        g.play_move(3, 3, BLACK)
        assert g.play_pass(WHITE) is False
        assert g.play_pass(BLACK) is True
        assert g.over
        assert "over" in g.check_move(4, 4, WHITE)
        with pytest.raises(IllegalMove):
            g.play_pass(WHITE)
        assert g.legal_points() == []

    def test_board_pinned_to_replay_ground_truth(self):
        sgf_game = parse_file(PINNED_SGF)
        g = GoGame("pin", handicaps=tuple(
            (m.player, m.x, m.y) for m in sgf_game.handicaps))
        applied = 0
        for packed, move in replay_positions(sgf_game):
            assert np.array_equal(summarize(g.stones, g.age), packed), \
                f"session board diverged from replay before move {applied}"
            if g.check_move(move.x, move.y, move.player) is not None:
                break
            g.play_move(move.x, move.y, move.player)
            applied += 1
            if applied >= 80:
                break
        assert applied >= 40

    def test_snapshot_digest_roundtrip(self):
        g = GoGame("r", handicaps=((BLACK, 3, 3),))
        g.play_move(10, 10, WHITE)
        g.play_move(4, 4, BLACK)
        g.play_pass(WHITE)
        clone = GoGame.from_snapshot(g.snapshot())
        assert clone.digest() == g.digest()
        clone.play_move(5, 5, BLACK)
        assert clone.digest() != g.digest()


def scripted_game(cls, sid="x", moves=60, seed=3):
    """A game of ``cls`` (either package's GoGame) driven by a seeded
    client through legal plays, a capture-rich ko corner and passes."""
    g = cls(sid, handicaps=((BLACK, 4, 5), (BLACK, 5, 4), (BLACK, 6, 5),
                            (WHITE, 4, 6), (WHITE, 5, 7), (WHITE, 6, 6),
                            (BLACK, 5, 6)))
    g.play_move(5, 5, WHITE, elapsed_s=0.5)
    rng = random.Random(seed)
    for i in range(moves):
        if i % 17 == 16:
            g.play_pass(g.to_play, elapsed_s=0.1)
            continue
        legal = g.legal_points()
        x, y = legal[rng.randrange(len(legal))]
        g.play_move(x, y, g.to_play, elapsed_s=0.01 * i)
    return g


def test_digest_and_snapshot_equal_across_packages():
    port, ref = scripted_game(GoGame), scripted_game(jax_sessions.GoGame)
    assert port.snapshot() == ref.snapshot()
    assert port.digest() == ref.digest()
    assert sum(port.captures.values()) > 0
    assert GoGame.from_snapshot(ref.snapshot()).digest() == ref.digest()


# ---- the WAL store ----


def drive(store, sid="g"):
    store.open_session(sid)
    store.append_move(sid, BLACK, x=3, y=3)
    store.append_move(sid, WHITE, x=15, y=15)
    store.append_move(sid, BLACK, x=4, y=3)
    return store.get(sid).digest()


@pytest.mark.parametrize("writer,reader", [
    (jax_sessions.SessionStore, SessionStore),
    (SessionStore, jax_sessions.SessionStore)],
    ids=["jax-to-port", "port-to-jax"])
def test_store_written_by_one_package_recovers_in_the_other(
        tmp_path, writer, reader):
    w = writer(str(tmp_path), checkpoint_every=5)
    for sid in ("a", "b", "c"):
        drive(w, sid)  # 12 records: two checkpoints, then a WAL tail
    w.append_move("b", WHITE, is_pass=True, elapsed_s=0.25)
    w.close_session("c")
    digests = {sid: w.get(sid).digest() for sid in ("a", "b")}
    w.close(final_checkpoint=False)
    assert [n for n in os.listdir(tmp_path) if n.startswith("wal-")]
    r = reader(str(tmp_path))
    assert r.recovery["checkpoint_seq"] == 10
    assert r.recovery["wal_records_applied"] == 4
    assert r.recovery["sessions"] == 2
    assert {sid: r.get(sid).digest() for sid in ("a", "b")} == digests
    assert r.stats()["seq"] == w.stats()["seq"]


class TestSessionStore:
    def test_acked_is_durable_without_checkpoint(self, tmp_path):
        s1 = SessionStore(str(tmp_path), checkpoint_every=1000)
        digest = drive(s1)
        s1.close(final_checkpoint=False)
        s2 = SessionStore(str(tmp_path), checkpoint_every=1000)
        assert s2.recovery["wal_records_applied"] == 4
        assert s2.recovery["sessions"] == 1
        assert s2.get("g").digest() == digest
        assert s2.append_move("g", WHITE, x=16, y=16) == 5

    def test_torn_wal_tail_is_dropped(self, tmp_path):
        s1 = SessionStore(str(tmp_path), checkpoint_every=1000)
        digest = drive(s1)
        s1.close(final_checkpoint=False)
        (_, wal), = [(q, p) for q, p in s1._wal_paths()]
        with open(wal, "ab") as f:
            f.write(b'{"kind":"session_move","seq":5,"ses')
        s2 = SessionStore(str(tmp_path), checkpoint_every=1000)
        assert s2.recovery["torn_tail"] is True
        assert s2.get("g").digest() == digest
        assert not s2.stats()["corrupt_sessions"]

    def test_checkpoint_compacts_wal_and_prunes(self, tmp_path):
        s = SessionStore(str(tmp_path), checkpoint_every=2,
                         keep_checkpoints=2)
        drive(s)
        names = sorted(os.listdir(tmp_path))
        assert not [n for n in names if n.startswith("wal-")]
        ckpts = [n for n in names if n.startswith("ckpt-")]
        assert 1 <= len(ckpts) <= 2
        for i in range(4):
            sid = f"x{i}"
            s.open_session(sid)
            s.append_move(sid, BLACK, x=i, y=0)
        ckpts = [n for n in os.listdir(tmp_path) if n.startswith("ckpt-")]
        assert len(ckpts) <= 2
        s.close()

    def test_corrupt_checkpoint_falls_back_to_older(self, tmp_path):
        s = SessionStore(str(tmp_path), checkpoint_every=1000,
                         keep_checkpoints=3)
        digest_a = drive(s)
        s.checkpoint()
        s.append_move("g", WHITE, x=16, y=16)
        s.checkpoint()
        s.close(final_checkpoint=False)
        newest = s._ckpt_paths()[0][1]
        with open(newest, "r+b") as f:
            f.seek(20)
            f.write(b"XXXXXX")
        s2 = SessionStore(str(tmp_path))
        assert s2.recovery["checkpoints_skipped"] == 1
        assert s2.recovery["checkpoint_seq"] == 4
        assert s2.get("g").digest() == digest_a

    def test_unreplayable_wal_falls_back_to_checkpoint(self, tmp_path):
        s = SessionStore(str(tmp_path), checkpoint_every=1000)
        digest_ckpt = drive(s)
        s.checkpoint()
        s.append_move("g", WHITE, x=16, y=16)
        s.close(final_checkpoint=False)
        (_, wal), = [(q, p) for q, p in s._wal_paths()]
        bad = {"kind": "session_move", "seq": 6, "session": "g",
               "player": WHITE, "x": 3, "y": 3}
        with open(wal, "ab") as f:
            f.write((json.dumps(bad) + "\n").encode())
        s2 = SessionStore(str(tmp_path))
        assert s2.recovery["restored_from_checkpoint"] == ["g"]
        assert not s2.stats()["corrupt_sessions"]
        assert s2.get("g").digest() == digest_ckpt

    def test_move_for_unopened_session_is_corrupt(self, tmp_path):
        s = SessionStore(str(tmp_path), checkpoint_every=1000)
        drive(s)
        s.close(final_checkpoint=False)
        (_, wal), = [(q, p) for q, p in s._wal_paths()]
        bad = {"kind": "session_move", "seq": 5, "session": "ghost",
               "player": BLACK, "x": 0, "y": 0}
        with open(wal, "ab") as f:
            f.write((json.dumps(bad) + "\n").encode())
        s2 = SessionStore(str(tmp_path))
        assert s2.recovery["corrupt"] == ["ghost"]
        with pytest.raises(SessionCorrupt):
            s2.get("ghost")
        assert s2.get("g") is not None

    def test_wal_transient_absorbed_hard_fault_unacked(self, tmp_path):
        s = SessionStore(str(tmp_path), checkpoint_every=1000)
        s.open_session("g")
        faults.install("session_wal:transient@2")
        assert s.append_move("g", BLACK, x=3, y=3) == 2
        assert s.stats()["wal_retries"] == 2
        faults.reset()
        faults.install("session_wal:fail@1")
        with pytest.raises(faults.InjectedFailure):
            s.append_move("g", WHITE, x=4, y=4)
        assert s.seq == 2
        assert len(s.get("g").moves) == 1
        faults.reset()
        assert s.append_move("g", WHITE, x=4, y=4) == 3
        s.close(final_checkpoint=False)
        s2 = SessionStore(str(tmp_path))
        assert s2.get("g").digest() == s.get("g").digest()

    def test_typed_lookup_errors(self, tmp_path):
        s = SessionStore(str(tmp_path))
        with pytest.raises(SessionNotFound):
            s.get("nope")
        with pytest.raises(SessionNotFound):
            s.append_move("nope", BLACK, x=0, y=0)
        s.open_session("g")
        with pytest.raises(IllegalMove):
            s.append_move("g", WHITE, x=0, y=0)
        s.close()


# ---- the services, over the JAX tests' stub fleet ----


def make_service(tmp_path, **kw):
    fleet = kw.pop("fleet", StubFleet())
    store = SessionStore(os.path.join(str(tmp_path), "store"),
                         checkpoint_every=1000)
    svc = GameService(fleet, store, sleep=lambda d: None,
                      rng=random.Random(1), **kw)
    return fleet, store, svc


class TestGameService:
    def test_play_acks_then_engine_replies(self, tmp_path):
        fleet, store, svc = make_service(tmp_path)
        sid = svc.new_game("live")
        out = svc.play(sid, 3, 3)
        assert out["seq"] == 2 and "reply" in out
        assert (out["reply"]["x"], out["reply"]["y"]) == (0, 0)
        assert store.get(sid).moves[-1] == {"player": WHITE, "x": 0, "y": 0}
        call, = fleet.calls
        assert call["tier"] == "interactive"
        assert call["session"] == sid
        assert call["timeout_s"] == svc.budgets_s[0]
        svc.close()

    def test_illegal_client_move_changes_nothing(self, tmp_path):
        fleet, store, svc = make_service(tmp_path)
        sid = svc.new_game()
        svc.play(sid, 3, 3)
        before = store.get(sid).digest()
        game_to_play = store.get(sid).to_play
        with pytest.raises(IllegalMove):
            store.append_move(sid, game_to_play, x=3, y=3)
        assert store.get(sid).digest() == before
        assert not fleet.calls[1:]
        svc.close()

    def test_deadline_tiers_escalate_then_succeed(self, tmp_path):
        fleet = StubFleet(errors=[EngineOverloaded("door"),
                                  TimeoutError("deadline")])
        fleet, store, svc = make_service(tmp_path, fleet=fleet)
        sid = svc.new_game()
        out = svc.play(sid, 3, 3)
        assert "reply" in out
        assert svc.reply_retries == 2
        assert [c["timeout_s"] for c in fleet.calls] == \
            list(svc.budgets_s)
        svc.close()

    def test_reply_exhausted_leaves_session_retriable(self, tmp_path):
        fleet = StubFleet(errors=[EngineOverloaded("x")] * 3)
        fleet, store, svc = make_service(tmp_path, fleet=fleet)
        sid = svc.new_game()
        store.append_move(sid, BLACK, x=3, y=3)
        before = store.get(sid).digest()
        with pytest.raises(ReplyExhausted):
            svc.engine_reply(sid)
        assert store.get(sid).digest() == before
        out = svc.engine_reply(sid)
        assert out["player"] == WHITE
        svc.close()

    def test_reply_fault_site_burns_one_tier(self, tmp_path):
        fleet, store, svc = make_service(tmp_path)
        sid = svc.new_game()
        store.append_move(sid, BLACK, x=3, y=3)
        faults.install("session_reply:transient@1")
        out = svc.engine_reply(sid)
        assert out["player"] == WHITE
        assert svc.reply_retries == 1
        assert [c["timeout_s"] for c in fleet.calls] == \
            [svc.budgets_s[1]]
        svc.close()

    def test_health_composes(self, tmp_path):
        fleet, store, svc = make_service(tmp_path)
        svc.new_game("a")
        h = svc.health()
        assert h["healthy"] is True and h["open_sessions"] == 1
        store.corrupt["ghost"] = "damaged"
        assert svc.health()["healthy"] is False
        svc.close()


def corpus(tmp_path) -> str:
    d = os.path.join(str(tmp_path), "sgf")
    os.makedirs(d)
    with open(PINNED_SGF, "rb") as f:
        body = f.read()
    with open(os.path.join(d, "a.sgf"), "wb") as f:
        f.write(body)
    return d


class TestSgfAnalysis:
    def test_scan_annotates_and_flags_blunders(self, tmp_path):
        d = corpus(tmp_path)
        fleet = StubFleet(row=np.full(361, -10.0, np.float64))
        svc = SgfAnalysisService(fleet, os.path.join(str(tmp_path), "out"),
                                 blunder_top=0, sleep=lambda d: None)
        report = svc.run(d)
        assert report["files_done"] == 1
        assert report["positions"] == report["annotated"] > 50
        assert report["blunders"] == report["annotated"]
        assert all(c["tier"] == "batch" and c["session"] == "scan:a.sgf"
                   for c in fleet.calls)
        with open(svc.sink.path, encoding="utf-8") as f:
            kinds = [json.loads(line)["kind"] for line in f]
        assert kinds.count("session_scan") == 1
        assert kinds.count("session_annotation") == report["annotated"]
        svc.close()

    def test_cursor_resumes_and_never_reannotates(self, tmp_path):
        d = corpus(tmp_path)
        out = os.path.join(str(tmp_path), "out")
        svc = SgfAnalysisService(StubFleet(), out, sleep=lambda d: None)
        first = svc.run(d, limit_positions=50)
        assert first["stopped_early"] and first["positions"] == 50
        svc.close()
        svc2 = SgfAnalysisService(StubFleet(), out, sleep=lambda d: None)
        second = svc2.run(d)
        assert second["files_done"] == 1
        total = sum(1 for _ in replay_positions(parse_file(PINNED_SGF)))
        assert first["annotated"] + second["annotated"] == total
        third = svc2.run(d)
        assert third["positions"] == 0 and third["files_resumed_past"] == 1
        svc2.close()

    def test_sheds_are_absorbed_outcomes(self, tmp_path):
        d = corpus(tmp_path)

        class SheddingFleet(StubFleet):
            def submit(self, *a, **kw):
                raise EngineOverloaded("door")

        svc = SgfAnalysisService(SheddingFleet(),
                                 os.path.join(str(tmp_path), "out"),
                                 attempts=1, sleep=lambda d: None)
        report = svc.run(d, limit_positions=20)
        assert report["outcomes"] == {"shed": 20}
        assert report["annotated"] == 0
        svc.close()

    def test_bogus_cursor_is_typed(self, tmp_path):
        out = os.path.join(str(tmp_path), "out")
        os.makedirs(out)
        with open(os.path.join(out, "cursor.json"), "w",
                  encoding="utf-8") as f:
            f.write("[1, 2, 3]")
        svc = SgfAnalysisService(StubFleet(), out, sleep=lambda d: None)
        with pytest.raises(AnalysisCursorError):
            svc.run(str(tmp_path))
        svc.close()


def test_annotations_equal_the_jax_service(tmp_path):
    d = corpus(tmp_path)
    rows = np.random.default_rng(2).normal(-6.0, 2.0, size=361)
    lines = []
    for name, cls in (("jax", jax_sessions.SgfAnalysisService),
                      ("port", SgfAnalysisService)):
        svc = cls(StubFleet(row=rows), os.path.join(str(tmp_path), name),
                  sleep=lambda d: None)
        svc.run(d)
        svc.close()
        with open(svc.sink.path, encoding="utf-8") as f:
            lines.append([{k: v for k, v in json.loads(line).items()
                           if k != "time"} for line in f])
    assert lines[0] == lines[1] and len(lines[0]) > 50


# ---- the workload observatory's session label ----


def test_characterize_reports_per_session_burstiness():
    recs = []
    t = 0.0
    for i in range(12):
        t += 0.04
        recs.append({"digest": f"d{i}", "tier": "interactive",
                     "session": "live-0", "t": t})
    rng = random.Random(7)
    t = 0.0
    for i in range(40):
        t += rng.choice((0.001, 0.001, 0.001, 0.3))
        recs.append({"digest": f"s{i}", "tier": "batch",
                     "session": "scan:a.sgf", "t": t})
    recs.append({"digest": "x", "tier": "batch", "t": 1.0})
    sess = workload_mod.characterize(recs)["sessions"]
    assert sess["count"] == 2
    assert sess["labeled_requests"] == 52
    assert sess["top"]["live-0"]["requests"] == 12
    assert sess["top"]["live-0"]["burstiness"] < 0
    assert sess["top"]["scan:a.sgf"]["burstiness"] > 0


# ---- the crash-resume child ----


def run_child(store, extra, kill_after=None):
    cmd = [sys.executable, "-m", "deepgo_tpu_torch.sessions.child",
           "--store", str(store), "--games", "2", "--moves", "5",
           "--checkpoint-every", "4", *extra]
    if kill_after is not None:
        cmd += ["--kill-after-acks", str(kill_after)]
    env = {k: v for k, v in os.environ.items() if k != "DEEPGO_FAULTS"}
    return subprocess.run(cmd, cwd=REPO_ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def protocol(stdout: str, key: str) -> list:
    return [line.split()[1:] for line in stdout.splitlines()
            if line.startswith(key + " ")]


@pytest.mark.parametrize("extra", [["--no-engine"], ["--device", "cpu"]],
                         ids=["no-engine", "cpu-fleet"])
def test_child_sigkill_loses_no_acked_move(tmp_path, extra):
    killed = run_child(tmp_path / "killed", extra, kill_after=7)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    acked = protocol(killed.stdout, "SESSION_ACK")
    assert len(acked) == 7
    # every acked move is durable: the store recovers exactly those moves
    store = SessionStore(str(tmp_path / "killed"))
    assert sum(len(g.moves) for g in store.games.values()) == len(acked)
    assert store.seq >= max(int(seq) for _, seq in acked)
    store.close(final_checkpoint=False)
    resumed = run_child(tmp_path / "killed", extra)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert protocol(resumed.stdout, "SESSION_RESUMED") == [["1"]]
    clean = run_child(tmp_path / "clean", extra)
    assert clean.returncode == 0, clean.stderr[-2000:]
    digests = protocol(clean.stdout, "SESSION_DIGEST")
    assert len(digests) == 2
    assert protocol(resumed.stdout, "SESSION_DIGEST") == digests


def test_child_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    r = run_child(tmp_path, [])
    assert r.returncode != 0 and "CUDA" in r.stderr
