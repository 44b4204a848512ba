"""The port's runtime sanitizers (``deepgo_tpu_torch/analysis``) against
the JAX package's, on the CPU.

* ``lockcheck`` is a copy: the same scripted acquisitions (one source line
  each, so the reported sites agree) give equal reports in both packages,
  cycles, edges and hazards alike, on a fake clock; and the serving stack's
  locks carry the JAX package's names.
* ``cudacheck`` is the counterpart of ``xlacheck``: off, everything is the
  identity; armed, a watched forward's budget of new signatures is zero
  after warm-up (a storm names the signature), the transfer guard refuses
  an input that is not staged on the forward's device, an engine's armed
  dispatch is guard-clean and returns the unarmed rows bitwise, and
  ``check_sharding`` returns the JAX package's findings (kind, path,
  problem) on the mismatch cases of tests/test_xlacheck.py, while the
  tensor-parallel and ZeRO placements verify clean.
"""

import contextlib
import random
import threading

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from deepgo_tpu import serving as jax_serving
from deepgo_tpu.analysis import lockcheck as jax_lockcheck
from deepgo_tpu.analysis import xlacheck
from deepgo_tpu.obs import registry as jax_registry
from deepgo_tpu.obs import sentinel as jax_sentinel

from deepgo_tpu_torch import serving
from deepgo_tpu_torch.analysis import cudacheck, lockcheck
from deepgo_tpu_torch.models import policy_cnn
from deepgo_tpu_torch.models.serving import make_log_prob_fn
from deepgo_tpu_torch.obs import registry as port_registry
from deepgo_tpu_torch.obs import sentinel
from deepgo_tpu_torch.parallel import make_mesh, reshard, tensor, zero
from deepgo_tpu_torch.parallel.mesh import RankDevice

torch.set_num_threads(2)

LOCKCHECKS = {"jax": jax_lockcheck, "port": lockcheck}
SERVING = {"jax": jax_serving, "port": serving}
WAIT_S = 20.0


@pytest.fixture(scope="module", autouse=True)
def private_jax_registry():
    """The JAX package's calls in this file count into a metrics registry
    of their own. Its process-wide one feeds the ``obs_snapshot`` of every
    later JAX run in this worker, and tests/test_attribution.py holds its
    run's train-step total to its own 30 steps."""
    saved = jax_registry._default
    jax_registry._default = jax_registry.MetricsRegistry()
    yield
    jax_registry._default = saved


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# lockcheck: the same scripts, the same reports


def _ab_ba(lc, clock):
    a, b = lc.make_lock("A"), lc.make_lock("B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def _three_cycle(lc, clock):
    a, b, c = (lc.make_lock(n) for n in "ABC")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with a:
            pass


def _rlock_reentry(lc, clock):
    r = lc.make_rlock("R")
    other = lc.make_lock("O")
    with r:
        with r:
            with other:
                pass


def _long_hold(lc, clock):
    a, b = lc.make_lock("A"), lc.make_lock("B")
    with a:
        clock.advance(0.5)
    with b:
        clock.advance(0.1)
    with a:
        clock.advance(0.7)


def _cross_thread(lc, clock):
    a, b = lc.make_lock("A"), lc.make_lock("B")
    first = threading.Event()

    def forward():
        with a:
            with b:
                pass
        first.set()

    def backward():
        first.wait(WAIT_S)
        with b:
            with a:
                pass

    threads = [threading.Thread(target=forward, name="lk-forward"),
               threading.Thread(target=backward, name="lk-backward")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive()


SCRIPTS = {"ab_ba": _ab_ba, "three_cycle": _three_cycle,
           "rlock_reentry": _rlock_reentry, "long_hold": _long_hold,
           "cross_thread": _cross_thread}


@pytest.fixture
def both_armed():
    # each package's flight recorder exists before the scripts run: a
    # script's first inversion dumps through it, and a recorder made then
    # registers its "obs.flight" lock in that package's report alone when
    # an earlier test in the process already made the other package's
    jax_sentinel.get_flight_recorder()
    sentinel.get_flight_recorder()
    for lc in LOCKCHECKS.values():
        lc.enable(True)
    yield
    for lc in LOCKCHECKS.values():
        lc.enable(None)
        lc.reset()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_lockcheck_reports_like_jax(script, both_armed):
    reports = {}
    for name, lc in LOCKCHECKS.items():
        clock = FakeClock()
        lc.reset(clock=clock, hold_warn_s=0.2)
        SCRIPTS[script](lc, clock)
        reports[name] = lc.report()
    assert reports["port"] == reports["jax"]
    if script in ("ab_ba", "three_cycle", "cross_thread"):
        assert len(reports["port"]["cycles"]) == 1
    if script == "long_hold":
        held = [h["held_s"] for h in reports["port"]["hazards"]]
        assert held == [0.5, 0.7]


def test_lockcheck_off_returns_plain_locks():
    lockcheck.enable(False)
    try:
        assert not isinstance(lockcheck.make_lock("x"),
                              lockcheck.TrackedLock)
        assert not isinstance(lockcheck.make_rlock("y"),
                              lockcheck.TrackedLock)
    finally:
        lockcheck.enable(None)


def test_lockcheck_env_var_enables(monkeypatch):
    lockcheck.enable(None)
    monkeypatch.setenv("DEEPGO_LOCKCHECK", "1")
    assert isinstance(lockcheck.make_lock("env"), lockcheck.TrackedLock)
    monkeypatch.setenv("DEEPGO_LOCKCHECK", "0")
    assert not lockcheck.enabled()


def _stub_forward(params, packed, player, rank):
    return np.asarray(packed, np.float32).sum(axis=(1, 2, 3)) \
        + 1000.0 * np.asarray(player, np.float32)


def _drive_stub_fleet(s):
    ecfg = s.EngineConfig(buckets=(1, 4), max_wait_ms=0.0)

    def make_replica(i):
        return s.SupervisedEngine(
            lambda: s.InferenceEngine(_stub_forward, None, ecfg,
                                      name=f"lk-{i}"),
            name=f"lk-{i}")

    fleet = s.FleetRouter(make_replica, 2, name="lk",
                          config=s.FleetConfig(respawn_base_s=0.001,
                                               respawn_cap_s=0.005),
                          rng=random.Random(0))
    try:
        board = np.ones((9, 19, 19), np.uint8)
        futures = [fleet.submit(board, 1, 5) for _ in range(8)]
        return [float(f.result(timeout=WAIT_S)) for f in futures]
    finally:
        fleet.close()


def test_serving_locks_carry_the_jax_names(both_armed, monkeypatch):
    """A stub fleet's supervisor, engine, fleet and registry locks are
    made under the JAX package's names, and the fleet's traffic closes no
    lock-order cycle in either package."""
    monkeypatch.setattr(port_registry, "_default",
                        port_registry.MetricsRegistry())
    monkeypatch.setattr(jax_registry, "_default",
                        jax_registry.MetricsRegistry())
    reports, rows = {}, {}
    for name, lc in LOCKCHECKS.items():
        lc.reset()
        rows[name] = _drive_stub_fleet(SERVING[name])
        reports[name] = lc.report()
    assert rows["port"] == rows["jax"]
    names = {n: {lock for lock in r["locks"]
                 if not lock.startswith("obs.metric.")}
             for n, r in reports.items()}
    assert names["port"] == names["jax"]
    assert {"fleet.lk", "fleet.lk.reload", "engine.lk-0",
            "supervisor.lk-1"} <= names["port"]
    assert reports["port"]["cycles"] == reports["jax"]["cycles"] == []


# ---------------------------------------------------------------------------
# cudacheck: off is free


def test_cudacheck_off_is_identity():
    cudacheck.enable(False)
    try:
        fn = _stub_forward
        assert cudacheck.watch_compiles(fn, "f") is fn
        assert isinstance(cudacheck.transfer_guard("t", "cpu", (1,)),
                          contextlib.nullcontext)
        board = np.zeros((2, 9, 19, 19), np.uint8)
        assert cudacheck.stage_h2d(board, device="cpu")[0] is board
        assert cudacheck.check_sharding("x", {}, {}, None) == []
        t = torch.arange(6.0)
        np.testing.assert_array_equal(cudacheck.stage_d2h(t), t.numpy())
        with cudacheck.transfer_guard("off", "cpu", (board,)):
            pass  # not armed: nothing is checked
    finally:
        cudacheck.enable(None)


@pytest.mark.parametrize("on", [False, True])
def test_place_moves_arrays_tensors_and_modules(on):
    """``place`` is ``.to(device)`` off the card, armed or not: arrays
    become tensors of the same shape (0-d included), tensors and modules
    already there come back as they are."""
    cudacheck.enable(on)
    try:
        for array in (np.array(0.5, np.float32), np.arange(6.0)[::2],
                      np.zeros((2, 9, 19, 19), np.uint8)):
            t = cudacheck.place(array, "cpu")
            assert isinstance(t, torch.Tensor) and t.shape == array.shape
            np.testing.assert_array_equal(t.numpy(), array)
        t = torch.arange(3)
        assert cudacheck.place(t, "cpu") is t
        model = policy_cnn.init(torch.Generator().manual_seed(0),
                                policy_cnn.ModelConfig(num_layers=2,
                                                       channels=4),
                                device="cpu")
        assert cudacheck.place(model, "cpu") is model
    finally:
        cudacheck.enable(None)


@pytest.fixture
def armed():
    cudacheck.enable(True)
    cudacheck.reset()
    yield
    cudacheck.enable(None)
    cudacheck.reset()


def test_watch_counts_signatures_and_storms(armed):
    calls = []
    w = cudacheck.watch_compiles(lambda *a: calls.append(a) or len(calls),
                                 "fwd")
    one = np.zeros((1, 9, 19, 19), np.uint8)
    ints = np.ones(1, np.int32)
    w(None, one, ints, ints)
    w(None, one, ints, ints)
    assert w.compiles == 1 and w.cache_size() == 1
    # a staged tensor of the same shape and dtype is the same signature
    w(None, torch.from_numpy(one), torch.from_numpy(ints),
      torch.from_numpy(ints))
    assert w.compiles == 1
    cudacheck.mark_warm(w)
    four = np.zeros((4, 9, 19, 19), np.uint8)
    w(None, four, np.ones(4, np.int32), np.ones(4, np.int32))
    rep = cudacheck.report()
    assert rep["steady_state_compiles"] == 1
    assert rep["watched"]["fwd"] == {"compiles": 2,
                                     "steady_state_compiles": 1,
                                     "warm": True}
    storm = rep["storms"][0]
    assert storm["kind"] == "recompile_storm"
    assert storm["shapes"] == ["NoneType", "uint8[4,9,19,19]",
                               "int32[4]", "int32[4]"]
    assert (storm["cache_before"], storm["cache_after"]) == (1, 2)
    assert len(calls) == 4


def test_mark_warm_on_an_unwatched_fn_is_a_no_op(armed):
    cudacheck.mark_warm(_stub_forward)
    assert cudacheck.report()["watched"] == {}


def test_warm_engine_holds_zero_budget_then_storms_on_a_new_dtype(armed):
    with serving.InferenceEngine(_stub_forward, None,
                                 serving.EngineConfig(buckets=(1, 4),
                                                      max_wait_ms=0.0),
                                 name="xc-warm") as eng:
        eng.warmup()
        for n in (1, 3, 4, 2):
            futures = [eng.submit(np.zeros((9, 19, 19), np.uint8), 1, 1)
                       for _ in range(n)]
            for f in futures:
                f.result(timeout=WAIT_S)
        assert cudacheck.report()["steady_state_compiles"] == 0
        # a board of another dtype stacks into a new signature
        eng.submit(np.zeros((9, 19, 19), np.int32), 1, 1).result(
            timeout=WAIT_S)
    rep = cudacheck.report()
    assert rep["steady_state_compiles"] == 1
    assert rep["storms"][0]["fn"] == "xc-warm"
    assert "int32[1,9,19,19]" in rep["storms"][0]["shapes"]


def test_guard_refuses_an_unstaged_input(armed):
    staged = cudacheck.stage_h2d(np.zeros((2, 9, 19, 19), np.uint8),
                                 np.ones(2, np.int32), device="cpu")
    assert all(isinstance(t, torch.Tensor) for t in staged)
    with cudacheck.transfer_guard("staged", "cpu", staged):
        pass
    assert cudacheck.report()["transfers"] == []
    with pytest.raises(cudacheck.ImplicitTransfer, match="not staged"):
        with cudacheck.transfer_guard(
                "planted", "cpu", (staged[0], np.ones(2, np.int32))):
            pass
    (rec,) = cudacheck.report()["transfers"]
    assert rec["kind"] == "implicit_transfer" and rec["tag"] == "planted"
    assert "input 1" in rec["error"]


def test_armed_engine_dispatch_is_guard_clean_and_bitwise(armed):
    cfg = policy_cnn.ModelConfig(num_layers=2, channels=8,
                                 compute_dtype="float32")
    model = policy_cnn.init(torch.Generator().manual_seed(3), cfg,
                            device="cpu")
    rng = np.random.default_rng(4)
    boards = rng.integers(0, 3, size=(6, 9, 19, 19), dtype=np.uint8)
    rows = {}
    for arm in (True, False):
        cudacheck.enable(arm)
        forward = make_log_prob_fn(cfg, device="cpu")
        with serving.InferenceEngine(forward, model,
                                     serving.EngineConfig(buckets=(1, 8),
                                                          max_wait_ms=0.0),
                                     name=f"xc-guard-{arm}") as eng:
            eng.warmup()
            futures = [eng.submit(b, 1, 5) for b in boards]
            rows[arm] = np.stack([f.result(timeout=WAIT_S)
                                  for f in futures])
    cudacheck.enable(True)
    rep = cudacheck.report()
    assert rep["transfers"] == [] and rep["steady_state_compiles"] == 0
    assert rep["watched"]["xc-guard-True"]["warm"]
    np.testing.assert_array_equal(rows[True], rows[False])


# ---------------------------------------------------------------------------
# check_sharding against xlacheck on the mismatch cases

CFG = policy_cnn.ModelConfig(num_layers=2, channels=8)
LEAF = "layers.0.weight"


def _port_placement(zero_opt=False):
    mesh = make_mesh(4, 2, devices=[RankDevice(r, r) for r in range(8)])
    return reshard.Placement.for_model(CFG, mesh, tensor_parallel=2,
                                       zero_opt=zero_opt)


def _port_case(case):
    placement = _port_placement()
    spec = placement.param_specs[LEAF]
    full = torch.zeros(placement.shapes[LEAF])
    leaf = {"match": placement.local_param(LEAF, full),
            "replicated": full,
            "host": full.numpy(),
            "misplaced": full[:, :1]}[case]
    return cudacheck.check_sharding("case", {LEAF: leaf}, {LEAF: spec},
                                    placement)


def _jax_case(case):
    from deepgo_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mesh = jax_make_mesh(4, 2)
    x = np.zeros((8, 16), np.float32)
    declared = NamedSharding(mesh, P(None, "model"))
    leaf = {"match": lambda: jax.device_put(x, declared),
            "replicated": lambda: jax.device_put(
                x, NamedSharding(mesh, P())),
            "host": lambda: x,
            "misplaced": lambda: jax.device_put(
                x, NamedSharding(mesh, P("data")))}[case]()
    return xlacheck.check_sharding("case", {LEAF: leaf}, {LEAF: declared})


@pytest.fixture
def both_checkers():
    for mod in (cudacheck, xlacheck):
        mod.enable(True)
        mod.reset()
    yield
    for mod in (cudacheck, xlacheck):
        mod.enable(None)
        mod.reset()


@pytest.mark.parametrize("case", ["match", "replicated", "host",
                                  "misplaced"])
def test_check_sharding_findings_like_jax(case, both_checkers):
    def key(records):
        return [(r["kind"], r["tag"], r["path"], r["problem"])
                for r in records]

    got, want = key(_port_case(case)), key(_jax_case(case))
    assert got == want
    assert bool(got) == (case != "match")
    assert key(cudacheck.report()["sharding"]) == \
        key(xlacheck.report()["sharding"])


def test_check_sharding_reports_once_per_tag_and_leaf(both_checkers):
    _port_case("replicated")
    _port_case("replicated")
    assert len(cudacheck.report()["sharding"]) == 1


def test_tensor_and_zero_placements_verify_clean(both_checkers):
    model = policy_cnn.init(torch.Generator().manual_seed(0), CFG,
                            device="cpu")
    placement = _port_placement(zero_opt=True)
    tp = tensor.shard_params(model, placement.mesh)
    assert tp is not model
    state = {"rate": torch.tensor(0.1),
             "velocity": {n: torch.zeros_like(p)
                          for n, p in tp.named_parameters()}}
    sharded = zero.shard_opt_state(state, placement)
    assert cudacheck.report()["sharding"] == []
    # the placements did shard: the first conv is split over "model",
    # and some momentum leaves over "data" as well
    full = placement.shapes[LEAF]
    local = dict(tp.named_parameters())
    assert local[LEAF].shape[0] == full[0] // 2
    assert any(sharded["velocity"][n].numel() < p.numel()
               for n, p in local.items())
