"""The port's expert-iteration loop against the JAX package's, and inside
itself.

* Replay buffer: one ingest sequence writes byte-identical segment and
  index files in both packages, a buffer written by either opens in the
  other, and the scenarios of ``tests/test_loop.py::TestReplayBuffer`` run
  against the port's class.
* Learner: one float32 window from one JAX-written seed checkpoint over the
  same buffer agrees with the JAX learner's within ``PARAM_TOL``; inside
  the port, windows are bitwise deterministic, ``replay_window`` recomputes
  each live digest, a learner killed mid-window (in process, and by
  SIGKILL in a child run from this file) resumes bit-exactly despite
  buffer growth, and the fleet's rows do not move under a learner window.
* Gate, actors and loop turn: the ``TestStandardGate`` / ``TestGatekeeper``
  scenarios, ``game_records`` byte-equal to JAX's, and whole loop turns on
  ``device="cpu"`` with no acked game lost.

Run as a script (``python tests/test_torch_loop.py --dir D``), this file is
the learner child of the SIGKILL test.
"""

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # the child: no conftest puts the repo on the path
    sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepgo_tpu_torch import match, selfplay  # noqa: E402
from deepgo_tpu_torch.agents import RandomAgent  # noqa: E402
from deepgo_tpu_torch.experiments import ExperimentConfig  # noqa: E402
from deepgo_tpu_torch.experiments import checkpoint as ckpt  # noqa: E402
from deepgo_tpu_torch.loop import (ArenaGatekeeper,  # noqa: E402
                                   ContinuousLearner, ExpertIterationLoop,
                                   GateRejected, LoopConfig, LoopStalled,
                                   ReplayBuffer, ReplayError,
                                   SelfplayActor, count_durable_games,
                                   game_records,
                                   params_digest, read_windows,
                                   replay_window)
from deepgo_tpu_torch.loop.replay import GAMES_DIR  # noqa: E402
from deepgo_tpu_torch.models import convert, policy_cnn  # noqa: E402
from deepgo_tpu_torch.models.serving import (load_policy,  # noqa: E402
                                             make_log_prob_fn)
from deepgo_tpu_torch.serving import (EngineConfig,  # noqa: E402
                                      fleet_policy_engine)
from deepgo_tpu_torch.utils import faults  # noqa: E402

torch.set_num_threads(2)

TINY = ExperimentConfig(name="loop-test", num_layers=2, channels=8,
                        batch_size=8, rate=0.05, seed=3)
# the JAX learner and the port's, float32, from one seed checkpoint
F32 = TINY.replace(name="loop-parity", compute_dtype="float32")
PARAM_TOL = 1e-5
EWMA_RTOL = 1e-5
CPU = "cpu"


def synth_game(gid: int, moves: int = 10):
    """Deterministic synthetic records keyed on gid alone (as
    ``tests/loop_learner_child.py`` draws them), so two buffers fed the
    same schedule hold byte-identical segments."""
    r = np.random.default_rng(gid + 1000)
    packed = r.integers(0, 3, size=(moves, 9, 19, 19)).astype(np.uint8)
    meta = np.zeros((moves, 6), np.int32)
    meta[:, 0] = r.integers(1, 3, size=moves)
    meta[:, 1] = r.integers(0, 19, size=moves)
    meta[:, 2] = r.integers(0, 19, size=moves)
    meta[:, 3] = 8
    meta[:, 4] = 8
    return packed, meta


def fill(buffer, start: int, n: int, winner_of=None) -> None:
    for g in range(start, start + n):
        winner = winner_of(g) if winner_of else 1 + g % 2
        buffer.ingest_game(*synth_game(g), winner=winner)


def child_main(argv=None) -> None:
    """The SIGKILL test's learner child: before window w the buffer grows
    to a game count that is a pure function of durable state, then the
    window trains; ``DEEPGO_FAULTS=kill:step@K`` kills it mid-window and
    rerunning the same command resumes. Prints the window digests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--games-per-window", type=int, default=4)
    args = ap.parse_args(argv)
    buffer = ReplayBuffer(os.path.join(args.dir, "buf"), segment_games=2)
    config = ExperimentConfig(name="loop-child", num_layers=2, channels=8,
                              batch_size=8, rate=0.05, seed=7)
    learner = ContinuousLearner(
        buffer, os.path.join(args.dir, "run"), config,
        steps_per_window=args.steps, min_window_positions=8, device=CPU)
    while learner.window < args.windows:
        target = args.games_per_window * (learner.window + 1)
        while buffer.total_games < target:
            buffer.ingest_game(*synth_game(buffer.total_games))
        learner.train_window()
    digests = [r["digest"] for r in read_windows(os.path.join(args.dir,
                                                              "run"))]
    print("CHILD_DONE " + json.dumps(digests), flush=True)


if __name__ == "__main__":
    child_main()
    sys.exit(0)

import jax  # noqa: E402

from deepgo_tpu import loop as jax_loop  # noqa: E402
from deepgo_tpu.experiments import ExperimentConfig as JaxConfig  # noqa: E402
from deepgo_tpu.experiments import checkpoint as jax_ckpt  # noqa: E402
from deepgo_tpu.loop import actors as jax_actors  # noqa: E402
from deepgo_tpu.models import policy_cnn as jax_policy  # noqa: E402
from deepgo_tpu.training.optimizers import \
    OPTIMIZERS as JAX_OPTIMIZERS  # noqa: E402
from deepgo_tpu.utils import faults as jax_faults  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.install("")
    jax_faults.install("")


def jax_checkpoint(path: str, config=TINY, seed: int = 0,
                   step: int = 0) -> dict:
    """A JAX-written policy checkpoint of ``config`` with seed-``seed``
    weights; returns the JAX params."""
    cfg = JaxConfig.from_dict(config.replace(seed=seed).to_dict())
    params = jax_policy.init(jax.random.key(seed), cfg.model_config())
    optimizer = JAX_OPTIMIZERS[cfg.optimizer](cfg.rate, cfg.rate_decay,
                                              cfg.momentum)
    jax_ckpt.save_checkpoint(path, params, optimizer.init(params), {
        "id": f"test-{seed}", "step": step, "validation_history": [],
        "config": cfg.to_dict()})
    return params


def tree_files(root) -> dict:
    """relative path -> bytes of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


# ---------------------------------------------------------------------------
# replay buffer: across packages


def test_ingest_sequence_writes_byte_identical_files(tmp_path):
    dirs = {}
    for name, cls in (("jax", jax_loop.ReplayBuffer), ("port", ReplayBuffer)):
        buf = cls(str(tmp_path / name), segment_games=3)
        fill(buf, 0, 7, winner_of=lambda g: g % 3)
        buf.seal()
        dirs[name] = tree_files(tmp_path / name)
    assert set(dirs["port"]) == set(dirs["jax"])
    assert "index.json" in dirs["port"]
    assert sum(n.endswith("planes.bin") for n in dirs["port"]) == 3
    for name, data in dirs["jax"].items():
        assert dirs["port"][name] == data, name


def test_open_game_files_hold_the_same_arrays(tmp_path):
    for name, cls in (("jax", jax_loop.ReplayBuffer), ("port", ReplayBuffer)):
        fill(cls(str(tmp_path / name), segment_games=10), 0, 2)
    for g in ("g-00000000.npz", "g-00000001.npz"):
        with np.load(tmp_path / "jax" / GAMES_DIR / g) as a, \
                np.load(tmp_path / "port" / GAMES_DIR / g) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("writer,reader", [
    (jax_loop.ReplayBuffer, ReplayBuffer),
    (ReplayBuffer, jax_loop.ReplayBuffer)], ids=["jax-to-port",
                                                 "port-to-jax"])
def test_buffer_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                          reader):
    wbuf = writer(str(tmp_path), segment_games=2)
    fill(wbuf, 0, 5)
    rbuf = reader(str(tmp_path), segment_games=2)
    assert rbuf.stats() == wbuf.stats()
    lo, hi, _ = rbuf.extent()
    a, b = wbuf.view(lo, hi), rbuf.view(lo, hi)
    for scheme in ("game", "uniform", "winner"):
        ia = a.sample_indices(np.random.default_rng(5), 32, scheme)
        ib = b.sample_indices(np.random.default_rng(5), 32, scheme)
        np.testing.assert_array_equal(ia, ib)
        for x, y in zip(a.batch_at(ia), b.batch_at(ib)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert count_durable_games(str(tmp_path)) == \
        jax_loop.count_durable_games(str(tmp_path)) == 5


# ---------------------------------------------------------------------------
# replay buffer: the scenarios of tests/test_loop.py against the port


class TestReplayBuffer:
    def test_ingest_seal_version_and_gather(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path), segment_games=2)
        fill(buf, 0, 5)
        assert buf.version == 2
        assert buf.stats()["open_games"] == 1
        lo, hi, version = buf.extent()
        assert (lo, version) == (0, 2)
        view = buf.view(lo, hi)
        assert len(view) == hi - lo
        packed0, meta0 = synth_game(0)
        start, count = view.game_ranges[0]
        assert count == packed0.shape[0]
        got_packed, player, rank, target = view.batch_at(
            np.arange(start, start + count))
        np.testing.assert_array_equal(got_packed, packed0)
        np.testing.assert_array_equal(player, meta0[:, 0])
        np.testing.assert_array_equal(rank, np.full(count, 8))
        np.testing.assert_array_equal(
            target, meta0[:, 1] * 19 + meta0[:, 2])

    def test_reopen_recovers_sealed_and_open(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path), segment_games=2)
        fill(buf, 0, 5)
        stats = buf.stats()
        buf2 = ReplayBuffer(str(tmp_path), segment_games=2)
        assert buf2.stats() == stats
        assert buf2.total_games == 5
        buf2.seal()
        assert buf2.stats()["open_games"] == 0
        assert buf2.extent()[1] > stats["sealed_hi"]

    def test_torn_seal_and_stale_game_recovery(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path), segment_games=2)
        fill(buf, 0, 4)
        os.makedirs(tmp_path / "seg-000099")
        (tmp_path / "seg-000099" / "planes.bin").write_bytes(b"torn")
        packed, meta = synth_game(0)
        stale = tmp_path / GAMES_DIR / "g-00000001.npz"
        np.savez(stale, packed=packed, meta=meta, winner=np.int32(0))
        buf2 = ReplayBuffer(str(tmp_path), segment_games=2)
        assert not (tmp_path / "seg-000099").exists()
        assert not stale.exists()
        assert buf2.total_games == 4
        assert count_durable_games(str(tmp_path)) == 4

    def test_ingest_fault_site(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path), segment_games=10)
        faults.install("loop_ingest:fail@1")
        with pytest.raises(faults.InjectedFailure):
            buf.ingest_game(*synth_game(0))
        assert buf.total_games == 0
        assert count_durable_games(str(tmp_path)) == 0
        buf.ingest_game(*synth_game(0))
        assert buf.total_games == 1

    def test_ingest_transient_absorbed(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path), segment_games=10)
        faults.install("loop_ingest:transient@2")
        buf.ingest_game(*synth_game(0))
        assert buf.total_games == 1

    def test_eviction_respects_protect_lo(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path), segment_games=2,
                           capacity_positions=30)
        fill(buf, 0, 8)
        lo, hi, _ = buf.extent()
        protect = buf._segments[1].lo
        buf.evict(protect_lo=protect)
        assert buf.base_lo == protect
        buf.view(protect, hi)
        with pytest.raises(ReplayError):
            buf.view(lo, hi)

    def test_winner_scheme_filters(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path), segment_games=4)
        fill(buf, 0, 4, winner_of=lambda g: 1)
        buf.seal()
        view = buf.view(*buf.extent()[:2])
        cand = view.winner_positions()
        _, player, _, _ = view.batch_at(cand)
        assert (player == 1).all() and cand.size > 0
        idx = view.sample_indices(np.random.default_rng(0), 16, "winner")
        assert np.isin(idx, cand).all()

    def test_rejects_malformed_games(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path))
        with pytest.raises(ValueError):
            buf.ingest_game(np.zeros((0, 9, 19, 19), np.uint8),
                            np.zeros((0, 6), np.int32))
        with pytest.raises(ValueError):
            buf.ingest_game(np.zeros((3, 9, 19, 19), np.float32),
                            np.zeros((3, 6), np.int32))


# ---------------------------------------------------------------------------
# learner: against the JAX package


def jax_leaves(model) -> list:
    return ckpt.tree_leaves(convert.params_to_jax(model))


def test_params_digest_of_a_jax_checkpoint_is_jax_digest(tmp_path):
    path = str(tmp_path / "seed.npz")
    params = jax_checkpoint(path, F32, seed=4)
    model = ckpt.load_model_like(
        policy_cnn.PolicyCNN(F32.model_config()), path)
    assert params_digest(model) == jax_loop.params_digest(params)


def test_one_window_matches_the_jax_learner(tmp_path):
    seed = str(tmp_path / "seed.npz")
    jax_checkpoint(seed, F32, seed=2)
    learners = {}
    for name, buf_cls, learner_cls, cfg, kw in (
            ("jax", jax_loop.ReplayBuffer, jax_loop.ContinuousLearner,
             JaxConfig.from_dict(F32.to_dict()), {}),
            ("port", ReplayBuffer, ContinuousLearner, F32,
             {"device": CPU})):
        buf = buf_cls(str(tmp_path / f"buf-{name}"), segment_games=4)
        fill(buf, 0, 4)
        learner = learner_cls(buf, str(tmp_path / f"run-{name}"), cfg,
                              steps_per_window=4, min_window_positions=16,
                              seed_checkpoint=seed, **kw)
        learner.train_window()
        learners[name] = learner
    jl, pl = learners["jax"], learners["port"]
    for got, want in zip(jax_leaves(pl.model), jax.tree.leaves(jl.params)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=PARAM_TOL)
    assert pl.step == jl.step == 4
    assert pl.ewma == pytest.approx(jl.ewma, rel=EWMA_RTOL)
    cursors = [json.loads((tmp_path / f"run-{n}" / "cursor.json")
                          .read_text()) for n in ("jax", "port")]
    assert cursors[0] == cursors[1]
    (jrec,), (prec,) = (read_windows(str(tmp_path / f"run-{n}"))
                        for n in ("jax", "port"))
    # floats agree within the tolerance above, files and digests differ
    skip = {"digest", "seconds", "checkpoint", "ewma", "loss"}
    assert set(jrec) == set(prec)
    assert {k: v for k, v in prec.items() if k not in skip} == \
        {k: v for k, v in jrec.items() if k not in skip}
    assert prec["loss"] == pytest.approx(jrec["loss"], rel=EWMA_RTOL)
    # the port's window checkpoint loads in the JAX package
    meta, leaves, o_leaves = jax_ckpt.load_checkpoint(prec["checkpoint"])
    assert meta["step"] == 4 and meta["loop"]["window"] == 1
    template = jax_policy.init(jax.random.key(0),
                               JaxConfig.from_dict(meta["config"])
                               .model_config())
    params = jax_ckpt.unflatten_like(template, leaves, prec["checkpoint"])
    assert jax_loop.params_digest(params) == prec["digest"]
    assert len(o_leaves) == len(jax.tree.leaves(jl.opt_state))


# ---------------------------------------------------------------------------
# learner: inside the port


def make_learner(buf, run_dir, **kw):
    kw.setdefault("steps_per_window", 3)
    kw.setdefault("min_window_positions", 16)
    kw.setdefault("device", CPU)
    return ContinuousLearner(buf, str(run_dir), TINY, **kw)


class TestLearner:
    def test_windows_deterministic_across_learners(self, tmp_path):
        digests = []
        for side in ("a", "b"):
            buf = ReplayBuffer(str(tmp_path / f"buf-{side}"),
                               segment_games=4)
            fill(buf, 0, 4)
            learner = make_learner(buf, tmp_path / f"run-{side}")
            rec1 = learner.train_window()
            fill(buf, 4, 4)
            rec2 = learner.train_window()
            digests.append((rec1["digest"], rec2["digest"]))
        assert digests[0] == digests[1]
        assert digests[0][0] != digests[0][1]

    def test_offline_replay_matches_live_digests(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path / "buf"), segment_games=4)
        fill(buf, 0, 4)
        learner = make_learner(buf, tmp_path / "run")
        learner.train_window()
        fill(buf, 4, 4)
        learner.train_window()
        records = read_windows(str(tmp_path / "run"))
        assert len(records) == 2
        for rec in records:
            assert replay_window(str(tmp_path / "run"), buf, rec,
                                 device=CPU) == rec["digest"]

    def test_crash_mid_window_resumes_bit_exact_despite_growth(
            self, tmp_path):
        buf_a = ReplayBuffer(str(tmp_path / "buf-a"), segment_games=4)
        fill(buf_a, 0, 4)
        ref = make_learner(buf_a, tmp_path / "run-a")
        ref.train_window()
        fill(buf_a, 4, 4)
        rec_a = ref.train_window()
        buf_b = ReplayBuffer(str(tmp_path / "buf-b"), segment_games=4)
        fill(buf_b, 0, 4)
        victim = make_learner(buf_b, tmp_path / "run-b")
        victim.train_window()
        fill(buf_b, 4, 4)
        faults.install("train_step:fail@2")
        with pytest.raises(faults.InjectedFailure):
            victim.train_window()
        faults.install("")
        fill(buf_b, 8, 4)
        resumed = make_learner(buf_b, tmp_path / "run-b")
        assert resumed.resumed_from is not None
        rec_b = resumed.train_window()
        assert rec_b["extent"] == rec_a["extent"]
        assert rec_b["digest"] == rec_a["digest"]
        assert params_digest(resumed.model) == params_digest(ref.model)

    def test_clean_boundary_resume_freezes_fresh_extent(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path / "buf"), segment_games=4)
        fill(buf, 0, 4)
        learner = make_learner(buf, tmp_path / "run")
        rec1 = learner.train_window()
        fill(buf, 4, 4)
        resumed = make_learner(buf, tmp_path / "run")
        rec2 = resumed.train_window()
        assert rec2["extent"][1] > rec1["extent"][1]

    def test_publish_is_loadable_and_verified(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path / "buf"), segment_games=4)
        fill(buf, 0, 4)
        challenger = tmp_path / "challenger.npz"
        learner = make_learner(buf, tmp_path / "run",
                               publish_path=str(challenger))
        rec = learner.train_window()
        assert rec["published"] == str(challenger)
        ckpt.verify_checkpoint(str(challenger))
        _, model, _ = load_policy(str(challenger), device=CPU)
        assert params_digest(model) == rec["digest"]

    def test_starved_buffer_raises_typed_stall(self, tmp_path):
        buf = ReplayBuffer(str(tmp_path / "buf"), segment_games=4)
        fill(buf, 0, 1)
        t = [0.0]

        def clock():
            return t[0]

        def sleep(s):
            t[0] += s

        learner = ContinuousLearner(
            buf, str(tmp_path / "run"), TINY, steps_per_window=3,
            min_window_positions=10_000, stall_timeout_s=5.0,
            clock=clock, sleep=sleep, device=CPU)
        with pytest.raises(LoopStalled):
            learner.train_window()

    def test_sigkill_resume_matches_uninterrupted_subprocess(
            self, tmp_path):
        """The learner child is SIGKILLed mid-window (kill:step@6: no
        cleanup, no atexit); rerunning the same command resumes, and every
        window digest equals a never-killed run of the same schedule."""

        def run(workdir, faults_spec=None):
            env = {k: v for k, v in os.environ.items()
                   if k != "DEEPGO_FAULTS"}
            if faults_spec:
                env["DEEPGO_FAULTS"] = faults_spec
            return subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--dir",
                 str(workdir), "--windows", "3", "--steps", "4"],
                env=env, capture_output=True, text=True, timeout=300)

        r = run(tmp_path / "killed", faults_spec="kill:step@6")
        assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr)
        r = run(tmp_path / "killed")
        assert r.returncode == 0, r.stderr[-2000:]
        killed = json.loads(r.stdout.split("CHILD_DONE ", 1)[1])
        r = run(tmp_path / "clean")
        assert r.returncode == 0, r.stderr[-2000:]
        clean = json.loads(r.stdout.split("CHILD_DONE ", 1)[1])
        assert killed == clean and len(killed) == 3


def test_fleet_rows_do_not_move_under_a_learner_window(tmp_path):
    """The learner trains a module of its own: the fleet serving the
    champion answers bitwise the same rows across a learner window, and
    takes the new weights only through a gate pass's reload."""
    champ = str(tmp_path / "champion.npz")
    jax_checkpoint(champ, F32, seed=1)
    _, model, cfg = load_policy(champ, device=CPU)
    fleet = fleet_policy_engine(model, cfg, replicas=1,
                                config=EngineConfig(buckets=(8,)),
                                device=CPU, name="guard")
    boards = synth_game(99, moves=8)[0]
    players = np.ones(8, np.int32)
    ranks = np.full(8, 8, np.int32)
    try:
        before = fleet.evaluate(boards, players, ranks)
        buf = ReplayBuffer(str(tmp_path / "buf"), segment_games=4)
        fill(buf, 0, 4)
        challenger = str(tmp_path / "challenger.npz")
        learner = ContinuousLearner(buf, str(tmp_path / "run"), F32,
                                    steps_per_window=4,
                                    min_window_positions=16,
                                    publish_path=challenger,
                                    seed_checkpoint=champ, device=CPU)
        assert all(p.data_ptr() != q.data_ptr() for p, q in zip(
            learner.model.parameters(), model.parameters()))
        rec = learner.train_window()
        assert rec["digest"] != params_digest(model)
        np.testing.assert_array_equal(
            fleet.evaluate(boards, players, ranks), before)
        gk = ArenaGatekeeper(champ, games=2, threshold=0.0, max_moves=8,
                             fleet=fleet, device=CPU)
        gk.evaluate(challenger)
        after = fleet.evaluate(boards, players, ranks)
        want = make_log_prob_fn(cfg, device=CPU)(learner.model, boards,
                                                 players, ranks)
        np.testing.assert_array_equal(after, want)
        assert not np.array_equal(after, before)
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# gate and actors


class TestStandardGate:
    def test_protocol_pins_match_the_jax_package(self):
        assert match.GATE_GAMES == 1000
        assert match.GATE_OPENING_PLIES == 8
        assert match.GATE_SEED == 29
        assert match.GATE_RANK == 8

    def test_standard_gate_records_protocol(self):
        _, _, stats = match.standard_gate(RandomAgent(), RandomAgent(),
                                          n_games=2, max_moves=10)
        assert stats["protocol"]["opening_plies"] == 8
        assert stats["protocol"]["seed"] == 29
        assert 0.0 <= stats["win_rate_a"] <= 1.0


class _FakeFleet:
    def __init__(self):
        self.reloaded = []

    def reload(self, path):
        self.reloaded.append(path)
        return {"replicas": 2, "seconds": 0.0}


class TestGatekeeper:
    def test_identical_agents_split_the_pairs_and_reject(self, tmp_path):
        champ = tmp_path / "champion.npz"
        chal = tmp_path / "challenger.npz"
        jax_checkpoint(str(champ), seed=1)
        jax_checkpoint(str(chal), seed=1)
        gk = ArenaGatekeeper(str(champ), games=4, threshold=0.55,
                             max_moves=20, device=CPU)
        with pytest.raises(GateRejected) as err:
            gk.evaluate(str(chal))
        assert err.value.win_rate == pytest.approx(0.5)
        assert gk.gates_rejected == 1

    def test_pass_publishes_champion_and_reloads_fleet(self, tmp_path):
        champ = tmp_path / "champion.npz"
        chal = tmp_path / "challenger.npz"
        jax_checkpoint(str(champ), seed=1, step=0)
        jax_checkpoint(str(chal), seed=2, step=11)
        fleet = _FakeFleet()
        gk = ArenaGatekeeper(str(champ), games=2, threshold=0.0,
                             max_moves=16, fleet=fleet, device=CPU)
        record = gk.evaluate(str(chal))
        assert record["outcome"] == "passed"
        assert fleet.reloaded == [str(champ)]
        assert ckpt.load_meta(str(champ))["step"] == 11
        assert record["champion_step"] == 11
        assert gk.gates_passed == 1

    def test_corrupt_challenger_never_reaches_the_fleet(self, tmp_path):
        champ = tmp_path / "champion.npz"
        chal = tmp_path / "challenger.npz"
        jax_checkpoint(str(champ), seed=1)
        jax_checkpoint(str(chal), seed=2)
        data = bytearray(chal.read_bytes())
        data[len(data) // 2] ^= 0xFF
        chal.write_bytes(bytes(data))
        fleet = _FakeFleet()
        gk = ArenaGatekeeper(str(champ), games=2, threshold=0.0,
                             max_moves=16, fleet=fleet, device=CPU)
        with pytest.raises(ckpt.CheckpointError):
            gk.evaluate(str(chal))
        assert fleet.reloaded == []
        assert ckpt.load_meta(str(champ))["id"] == "test-1"

    def test_loop_gate_fault_site(self, tmp_path):
        champ = tmp_path / "champion.npz"
        jax_checkpoint(str(champ), seed=1)
        gk = ArenaGatekeeper(str(champ), games=2, threshold=0.0,
                             device=CPU)
        faults.install("loop_gate:fail@1")
        with pytest.raises(faults.InjectedFailure):
            gk.evaluate(str(champ))


def test_game_records_equal_the_jax_package():
    model = policy_cnn.init(torch.Generator().manual_seed(0),
                            TINY.model_config(), device=CPU)
    games, _ = selfplay.self_play(model, TINY.model_config(), n_games=3,
                                  max_moves=40, temperature=1.0, seed=5,
                                  device=CPU)
    assert sum(len(g.moves) for g in games) > 0
    for g in games:
        got = game_records(g, 7, 6)
        want = jax_actors.game_records(g, 7, 6)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_search_actor_ingests_its_games(tmp_path):
    """An actor with ``search_sims > 0`` plays each move by a PUCT search
    over the fleet (the port's ``make_move_selector``) and ingests every
    finished game."""
    model = policy_cnn.init(torch.Generator().manual_seed(0),
                            TINY.model_config(), device=CPU)
    fleet = fleet_policy_engine(model, TINY.model_config(), replicas=1,
                                config=EngineConfig(buckets=(1, 8)),
                                device=CPU, name="search-actor")
    buf = ReplayBuffer(str(tmp_path), segment_games=10)
    try:
        actor = SelfplayActor(0, buf, fleet, games_per_round=2,
                              max_moves=6, search_sims=4)
        record = actor.run_round()
    finally:
        fleet.close()
    assert record["games"] == actor.games_acked == 2
    assert record["positions"] == buf.open_positions > 0
    assert count_durable_games(str(tmp_path)) == 2


# ---------------------------------------------------------------------------
# whole loop turns on the CPU


TURN = LoopConfig(actors=1, fleet=2, games_per_round=2, max_moves=16,
                  temperature=0.5, steps_per_window=4,
                  min_window_positions=24, segment_games=2, gate_games=4,
                  gate_threshold=0.0, windows=1, stall_timeout_s=180.0)


class TestLoopTurn:
    def test_one_full_turn_selfplay_to_champion(self, tmp_path):
        loop = ExpertIterationLoop(str(tmp_path / "run"), TURN,
                                   TINY.replace(name="loop-turn"),
                                   device=CPU)
        summary = loop.run()
        assert summary["fatal"] == {}
        assert summary["windows_trained"] == 1
        assert summary["gates_passed"] == 1
        # no acked game lost: every game the actors acked is on disk
        assert summary["games_acked"] == summary["games_durable"] > 0
        assert summary["champion_step"] == summary["learner_step"] == 4
        assert summary["fleet_reloads"] >= 1
        ckpt.verify_checkpoint(str(tmp_path / "run" / "champion.npz"))
        # the champion the port bootstraps and publishes loads in the JAX
        # package
        jax_ckpt.verify_checkpoint(str(tmp_path / "run" / "champion.npz"))
        events = [json.loads(line)["kind"]
                  for line in (tmp_path / "run" / "loop.jsonl")
                  .read_text().splitlines() if line.strip()]
        for kind in ("loop_start", "loop_ingest", "loop_window",
                     "loop_gate", "loop_close"):
            assert kind in events, (kind, set(events))

    def test_rerun_resumes_and_extends(self, tmp_path):
        ExpertIterationLoop(str(tmp_path / "run"), TURN,
                            TINY.replace(name="loop-turn"),
                            device=CPU).run()
        summary = ExpertIterationLoop(
            str(tmp_path / "run"), dataclasses.replace(TURN, windows=2),
            TINY.replace(name="loop-turn"), device=CPU).run()
        assert summary["windows_trained"] == 2
        assert summary["learner_step"] == 8
        assert summary["champion_step"] == 8
        assert summary["games_acked"] <= summary["games_durable"]

    def test_bootstrap_champion_loads_in_the_jax_package(self, tmp_path):
        loop = ExpertIterationLoop(str(tmp_path / "run"), TURN, TINY,
                                   device=CPU)
        try:
            meta, leaves, _ = jax_ckpt.load_checkpoint(loop.champion_path)
            assert meta["id"] == "loop-seed" and meta["step"] == 0
            template = jax_policy.init(jax.random.key(0),
                                       JaxConfig.from_dict(meta["config"])
                                       .model_config())
            params = jax_ckpt.unflatten_like(template, leaves, "champion")
            want = policy_cnn.init(torch.Generator().manual_seed(TINY.seed),
                                   TINY.model_config(), device=CPU)
            assert jax_loop.params_digest(params) == params_digest(want)
        finally:
            loop.fleet.close()
            loop.metrics.close()


def test_telemetry_waits_for_the_observability_port(tmp_path):
    with pytest.raises(ValueError, match="ROADMAP A7"):
        ExpertIterationLoop(str(tmp_path), LoopConfig(telemetry=True),
                            TINY, device=CPU)


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    buf = ReplayBuffer(str(tmp_path / "buf"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousLearner(buf, str(tmp_path / "run"), TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_window(str(tmp_path / "run"), buf, {"step0": 0})
    with pytest.raises(RuntimeError, match="CUDA"):
        ArenaGatekeeper(str(tmp_path / "champion.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ExpertIterationLoop(str(tmp_path / "loop"), TURN, TINY)
