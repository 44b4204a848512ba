"""The port's serving stack behind the engine: engine taps, supervisor,
fleet router, position cache, CUDA + CPU surge tier, and the copies of
the JAX package's jax-free modules they reach.

Two kinds of test:

  * copies held to their originals — fault plans and their due/not-due
    sequences, cache keys, ``simulate`` and the dihedral map-back, the
    breaker and the backoff jitter, the bench gate, request-trace
    records, workload captures read across both packages. Equal means
    equal: same values, same types.
  * behaviour, mirroring the JAX package's tests on the port: most
    scenarios run on BOTH packages' serving classes over the same numpy
    stub forwards (or scripted replicas whose futures the test resolves)
    and assert the same outcome, so the port is held to the reference's
    behaviour, not only to expectations written here. Timing-dependent
    paths wait on events, never on sleeps with thin margins.

Numbers: fleet rows on the CPU are bitwise equal to the port's direct
forward at the rung they dispatched on (the direct forward is tied to the
JAX package in ``test_torch_policy.py``); the int8+sym ensemble's rows,
whose CPU arithmetic depends on a board's place in the batch, within
1e-5."""

import os
import random
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepgo_tpu import serving as jax_serving
from deepgo_tpu.experiments.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from deepgo_tpu.obs import sentinel as jax_sentinel
from deepgo_tpu.obs import spans as jax_spans
from deepgo_tpu.obs import tracing as jax_tracing
from deepgo_tpu.obs import workload as jax_workload
from deepgo_tpu.serving import cache as jax_cache
from deepgo_tpu.serving import resilience as jax_resilience
from deepgo_tpu.utils import faults as jax_faults

from deepgo_tpu_torch import serving
from deepgo_tpu_torch.experiments import checkpoint as ckpt
from deepgo_tpu_torch.models import convert, policy_cnn, quant
from deepgo_tpu_torch.models.serving import make_log_prob_fn
from deepgo_tpu_torch.obs import get_registry, sentinel, spans, tracing
from deepgo_tpu_torch.obs import workload
from deepgo_tpu_torch.obs.exporter import JsonlSink
from deepgo_tpu_torch.serving import cache, resilience
from deepgo_tpu_torch.utils import faults

from test_torch_policy import boards, numpy_tree
from test_torch_variants import FAST_TOL, grid_net, he_normal_net

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

PKGS = {
    "jax": SimpleNamespace(serving=jax_serving, faults=jax_faults,
                           tracing=jax_tracing, workload=jax_workload,
                           cache=jax_cache, resilience=jax_resilience,
                           sentinel=jax_sentinel, spans=jax_spans),
    "port": SimpleNamespace(serving=serving, faults=faults, tracing=tracing,
                            workload=workload, cache=cache,
                            resilience=resilience, sentinel=sentinel,
                            spans=spans),
}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))

CFG = policy_cnn.ModelConfig(num_layers=2, channels=8)
ECFG = serving.EngineConfig(buckets=(1, 4), max_wait_ms=0.0)
POISON_BOARD = np.full((9, 19, 19), 255, dtype=np.uint8)
WAIT_S = 20.0  # every bounded wait in this file


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """Each test starts and ends with no fault plan, no tracing and no
    workload capture, in either package."""
    monkeypatch.delenv("DEEPGO_FAULTS", raising=False)
    for p in PKGS.values():
        p.faults.reset()
    yield
    for p in PKGS.values():
        p.faults.reset()
        p.tracing.disable_tracing()
        p.workload.disable_workload()


# ---------------------------------------------------------------------------
# stub forwards and replicas (numpy only, so both packages run them)


def ok_forward(params, packed, player, rank):
    return np.asarray(packed, np.float32).sum(axis=(1, 2, 3)) \
        + 1000.0 * np.asarray(player, np.float32)


def marker_forward(params, packed, player, rank):
    """Detonates iff the all-255 poison board rides the batch."""
    if (np.asarray(packed) == 255).all(axis=(1, 2, 3)).any():
        raise ValueError("poison row in batch")
    return ok_forward(params, packed, player, rank)


def point_forward(params, packed, player, rank):
    """out[b, p] depends only on the channel column at p: equivariant
    under any spatial permutation and bitwise stable (the canonical-key
    remap's precondition)."""
    flat = np.asarray(packed, np.float32).reshape(len(packed), 9, 361)
    return flat.sum(axis=1) * 0.125 + np.asarray(player, np.float32)[:, None]


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class ScriptedReplica:
    """Duck-typed replica whose futures the TEST resolves (or that
    resolve at once with ``auto_value``), stamped with a platform."""

    def __init__(self, idx, platform=None, est=None, pkg="port"):
        self.idx = idx
        self.est = est
        self.futs = []
        self.fail_next = 0
        self.auto_value = None
        self.closed_type = PKGS[pkg].serving.EngineClosed
        if platform is not None:
            self.platform = platform

    def submit(self, packed, player, rank, timeout_s=None, block=True,
               **_):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise self.closed_type("scripted submit failure")
        f = Future()
        if self.auto_value is not None:
            f.set_result(self.auto_value)
        self.futs.append(f)
        return f

    def estimated_wait_s(self):
        return self.est

    def health(self):
        return {"state": "serving", "estimated_wait_s": self.est,
                "breaker": {"state": "closed"}}

    def stats(self):
        return {"boards": len(self.futs)}

    def warmup(self):
        return 0

    def compile_cache_size(self):
        return None

    def set_params(self, params):
        pass

    @property
    def params(self):
        return None

    def close(self, drain=True, timeout=1.0):
        pass


def scripted_fleet(pkg, reps, fleet_config=None, **kw):
    kw.setdefault("rng", random.Random(0))
    return PKGS[pkg].serving.FleetRouter(
        lambda i: reps[i], len(reps), config=fleet_config,
        name=kw.pop("name", "scripted"), **kw)


def stub_fleet(pkg, forward=ok_forward, replicas=2, fleet_config=None,
               sup_config=None, engine_config=None, name="stub", **kw):
    s = PKGS[pkg].serving
    ecfg = engine_config or s.EngineConfig(buckets=(1, 4), max_wait_ms=0.0)
    fcfg = fleet_config or s.FleetConfig(respawn_base_s=0.001,
                                         respawn_cap_s=0.005)

    def make_replica(i):
        return s.SupervisedEngine(
            lambda: s.InferenceEngine(forward, None, ecfg,
                                      name=f"{name}-{i}"),
            config=sup_config, name=f"{name}-{i}")

    kw.setdefault("rng", random.Random(0))
    return s.FleetRouter(make_replica, replicas, config=fcfg, name=name,
                         **kw)


def make_sup(pkg, forward, engine_config=None, sup_config=None, **kw):
    s = PKGS[pkg].serving
    ecfg = engine_config or s.EngineConfig(buckets=(1, 4), max_wait_ms=0.0)
    kw.setdefault("rng", random.Random(0))
    return s.SupervisedEngine(
        lambda: s.InferenceEngine(forward, None, ecfg, name="inner"),
        config=sup_config, name="test", **kw)


def one_board(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, size=(9, 19, 19), dtype=np.uint8), 1, 5)


def wait_until(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


def port_model(seed=0, cfg=CFG):
    return convert.model_from_jax(numpy_tree(cfg, seed=seed), cfg,
                                  device="cpu")


def direct_rows(forward, model, ladder, packed, player, rank, buckets):
    """Each board alone through ``forward``, padded to its rung."""
    return np.stack([
        forward(model, *ladder.pad(packed[i:i + 1], player[i:i + 1],
                                   rank[i:i + 1], b))[0]
        for i, b in enumerate(buckets)])


# ---------------------------------------------------------------------------
# the copies, held to their originals


FAULT_PLANS = [
    "serving_forward:fail@2,serving_slow.r0:slow@5,serving_corrupt:corrupt@2",
    "serving_dispatch:transient@3,serving_corrupt.r1:corrupt@1,"
    "serving_slow:slow@1",
    "fleet_route:transient@1,fleet_reload:fail@1,serving_dispatch.r0:fail@1",
]


def _drive_faults(mod, text):
    """A fixed sequence over every kind of site call; what each returned
    or raised, in order."""
    out = [[(s.site, s.kind, s.arg) for s in mod.install(text).specs]]
    slept = []
    sites = ("serving_forward", "serving_dispatch", "serving_dispatch.r0",
             "fleet_route", "fleet_reload")
    for step in range(4):
        for site in sites:
            try:
                mod.check(site)
                out.append((site, None))
            except mod.FaultError as e:
                out.append((site, type(e).__name__, str(e)))
        for name in (None, "r0", "r1"):
            out.append(("slow", name, mod.maybe_slow("serving_slow", name,
                                                     sleep=slept.append)))
            out.append(("corrupt", name,
                        mod.corrupt_due("serving_corrupt", name)))
        if step == 1:
            out.append(("added", [(s.site, s.kind, s.arg) for s in
                                  mod.add("serving_forward:transient@1")]))
            out.append(("removed", mod.remove("serving_slow", "slow")))
    out.append(("slept", slept))
    return out


@pytest.mark.parametrize("text", FAULT_PLANS)
def test_fault_sequences_like_jax(text):
    assert _drive_faults(faults, text) == _drive_faults(jax_faults, text)


def test_fault_remove_without_plan_like_jax():
    for mod in (faults, jax_faults):
        mod.reset()
        assert mod.remove("serving_slow") == 0
        assert mod.maybe_slow("serving_slow", "x") == 0.0
        assert mod.corrupt_due("serving_corrupt", "x") is False


@pytest.mark.parametrize("keying", ["exact", "canonical"])
def test_cache_keys_and_map_back_like_jax(keying):
    ours = cache.PositionCache(cache.CacheConfig(keying=keying))
    ref = jax_cache.PositionCache(jax_cache.CacheConfig(keying=keying))
    packed, player, rank = boards(3, seed=21)
    row = np.random.default_rng(1).standard_normal(361).astype(np.float32)
    from deepgo_tpu_torch.utils import digest

    for i in range(3):
        for view in digest.dihedral_views(packed[i]):
            a = ours.prepare(view, int(player[i]), int(rank[i]))
            b = ref.prepare(view, int(player[i]), int(rank[i]))
            assert a[0] == b[0] and a[2] == b[2]
            assert np.array_equal(a[1], b[1])
            assert np.array_equal(ours._remap(row, a[2]),
                                  ref._remap(row, b[2]))
    with pytest.raises(cache.CacheKeyingError):
        ours._remap(np.zeros(7, np.float32), 3)


def test_simulate_like_jax():
    rng = np.random.default_rng(2)
    keys = [f"k{int(k)}" for k in rng.zipf(1.3, size=400) % 50]
    for capacity in (0, 1, 4, 16, 64):
        assert cache.simulate(keys, capacity) \
            == jax_cache.simulate(keys, capacity)
    with pytest.raises(ValueError):
        cache.simulate(keys, -1)


def test_breaker_and_jitter_like_jax():
    def drive(mod):
        clk = FakeClock()
        moves = []
        br = mod.CircuitBreaker(failures=2, reset_timeout_s=10, clock=clk,
                                on_transition=lambda a, b: moves.append(
                                    (a, b)))
        seen = []
        for op, arg in [("fail", 0), ("ok", 0), ("fail", 0), ("fail", 0),
                        ("allow", 5), ("allow", 6), ("allow", 0),
                        ("cancel", 0), ("allow", 0), ("fail", 0),
                        ("allow", 11), ("ok", 0)]:
            clk.advance(arg)
            if op == "fail":
                br.record_failure()
            elif op == "ok":
                br.record_success()
            elif op == "cancel":
                br.cancel_probe()
            else:
                seen.append(br.allow())
            seen.append(br.state)
        rng = random.Random(5)
        jitter = [mod.full_jitter_delay(a, 0.05, 2.0, rng) for a in range(8)]
        return moves, seen, br.snapshot(), jitter

    assert drive(resilience) == drive(jax_resilience)


def test_gate_and_flight_like_jax(tmp_path):
    base = {"metric": "boards_per_sec", "value": 100.0, "device": "x",
            "spread": 2.0}
    cases = [({**base, "value": v}, base) for v in (100.0, 96.0, 80.0)]
    cases += [({**base, "device": "y"}, base), (base, None)]
    for fresh, last in cases:
        assert sentinel.evaluate_gate(fresh, last) \
            == jax_sentinel.evaluate_gate(fresh, last)
    dumps = {}
    for name, mod in (("port", sentinel), ("jax", jax_sentinel)):
        rec = mod.FlightRecorder().configure(str(tmp_path / name))
        rec.tick()
        path = rec.dump("serving_restart", engine="e", attempt=1)
        rec.close()
        import json

        with open(path) as f:
            dumps[name] = json.load(f)
    assert set(dumps["port"]) == set(dumps["jax"])
    assert dumps["port"]["detail"] == dumps["jax"]["detail"]


def test_spans_like_jax():
    def drive(mod):
        got = []
        mod.add_span_listener(got.append)
        try:
            with mod.span("outer", step=1):
                with mod.span("inner"):
                    pass
                with pytest.raises(KeyError):
                    with mod.span("broken"):
                        raise KeyError("x")
        finally:
            mod.remove_span_listener(got.append)
        ids = {r["span_id"]: r["name"] for r in got}
        return [(r["name"], r["status"], ids.get(r["parent_id"]),
                 sorted(k for k in r if k not in ("t_start", "duration_s")))
                for r in got]

    assert drive(spans) == drive(jax_spans)


class ListSink:
    def __init__(self):
        self.records = []

    def write(self, kind, **fields):
        self.records.append({"kind": kind, **fields})


def _trace_scenario(pkg):
    """Three sequential fleet requests with tracing armed: a clean one, one
    whose first placement hits an injected route fault (one hop), one
    that is poison. Returns the recorder's records and stats."""
    p = PKGS[pkg]
    sink = ListSink()
    rec = p.tracing.configure_tracing(sink=sink, slowest_k=100)
    fleet = stub_fleet(pkg, forward=marker_forward, name="tr")
    try:
        packed, player, rank = boards(2, seed=3)
        fleet.submit(packed[0], int(player[0]), int(rank[0])) \
            .result(timeout=WAIT_S)
        p.faults.install("fleet_route:transient@1")
        fleet.submit(packed[1], int(player[1]), int(rank[1])) \
            .result(timeout=WAIT_S)
        p.faults.reset()
        with pytest.raises(p.serving.PoisonedRequest):
            fleet.submit(POISON_BOARD, 1, 5).result(timeout=WAIT_S)
    finally:
        fleet.close()
    assert wait_until(lambda: rec.stats()["finished"] == 3)
    return sink.records, rec.stats()


def test_trace_records_like_jax(tmp_path):
    runs = {pkg: _trace_scenario(pkg) for pkg in PKGS}

    def shape(records):
        return [(r["kind"], r["status"], r.get("tier"), r.get("error"),
                 len(r["hops"]), [e["name"] for e in r["events"]],
                 sorted(r)) for r in records]

    assert shape(runs["port"][0]) == shape(runs["jax"][0])
    assert runs["port"][1] == runs["jax"][1]
    assert runs["port"][1]["multi_hop"] == 1
    # a record written by the port renders the same in either package
    for r in runs["port"][0]:
        body = {k: v for k, v in r.items() if k != "kind"}
        assert tracing.format_waterfall(body) \
            == jax_tracing.format_waterfall(body)
    # and a port-written trace stream reads back through the JAX reader
    with JsonlSink(str(tmp_path / "trace.jsonl")) as sink:
        for r in runs["port"][0]:
            sink.write(r["kind"], **{k: v for k, v in r.items()
                                     if k != "kind"})
    tid = runs["port"][0][1]["trace_id"]
    assert jax_tracing.trace_report(str(tmp_path), tid) \
        == tracing.trace_report(str(tmp_path), tid)


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_workload_captures_read_across_packages(writer, tmp_path):
    p = PKGS[writer]
    cap = str(tmp_path / "cap")
    p.workload.configure_workload(capture_dir=cap)
    fleet = stub_fleet(writer, name="wl")
    try:
        packed, player, rank = boards(6, seed=4)
        for i in (0, 1, 2, 0, 0, 3, 1, 4, 5):
            fleet.submit(packed[i], int(player[i]), int(rank[i]),
                         tier=("interactive", "batch")[i % 2]) \
                .result(timeout=WAIT_S)
    finally:
        fleet.close()
    p.workload.disable_workload()
    ours, ref = workload.load_capture(cap), jax_workload.load_capture(cap)
    assert ours == ref
    assert len(ours["requests"]) == 9 and len(ours["positions"]) == 6
    assert {r["bucket"] for r in ours["requests"]} == {1}
    assert workload.analyze_capture(cap) == jax_workload.analyze_capture(cap)


# ---------------------------------------------------------------------------
# engine taps


def test_solo_lane_dispatches_strictly_alone():
    sizes = []

    def recording(params, packed, player, rank):
        sizes.append(len(packed))
        return np.zeros(len(packed), np.float32)

    engine = serving.InferenceEngine(recording, None, serving.EngineConfig(
        buckets=(1, 8), max_wait_ms=200.0))
    try:
        futs = [engine.submit(*one_board(i), solo=True) for i in range(3)]
        for f in futs:
            f.result(timeout=WAIT_S)
        assert sizes == [1, 1, 1]
    finally:
        engine.close()


@pytest.mark.parametrize("armed", [False, True])
def test_warmup_stages_its_boards_when_the_sanitizer_is_armed(armed):
    """Armed, the warm-up forwards take tensors staged at the declared
    host-to-device point, as a live dispatch does: the sanitizer's sync
    check is process-wide on a card, so a fleet respawn warming up beside
    another engine's guarded dispatch must not copy from pageable memory.
    Off, the boards pass through as numpy arrays."""
    from deepgo_tpu_torch.analysis import cudacheck

    kinds = []

    def recording(params, packed, player, rank):
        kinds.append({type(packed), type(player), type(rank)})
        return np.zeros(len(packed), np.float32)

    recording.device = torch.device("cpu")
    cudacheck.enable(armed)
    try:
        engine = serving.InferenceEngine(recording, None,
                                         serving.EngineConfig(buckets=(1, 8)))
        try:
            assert engine.warmup() == 2
        finally:
            engine.close()
    finally:
        cudacheck.enable(None)
    assert kinds == [{torch.Tensor if armed else np.ndarray}] * 2


def test_set_params_swaps_the_reference_only():
    seen = []
    entered, release = threading.Event(), threading.Event()

    def forward(params, packed, player, rank):
        seen.append(params)
        if len(seen) == 1:
            entered.set()
            assert release.wait(WAIT_S)
        return np.full(len(packed), params["w"], np.float32)

    old, new = {"w": 1.0}, {"w": 2.0}
    engine = serving.InferenceEngine(forward, old, ECFG)
    try:
        first = engine.submit(*one_board())
        assert entered.wait(WAIT_S)
        engine.set_params(new)   # mid-forward: the forward keeps `old`
        assert engine.params is new
        release.set()
        assert first.result(timeout=WAIT_S) == 1.0
        assert engine.submit(*one_board(1)).result(timeout=WAIT_S) == 2.0
        assert seen == [old, new] and old == {"w": 1.0}
    finally:
        release.set()
        engine.close()


def test_latency_estimates_and_queue_depth():
    engine = serving.InferenceEngine(ok_forward, None, serving.EngineConfig(
        buckets=(1, 4), max_wait_ms=0.0))
    try:
        assert engine.dispatch_p50_s() is None
        assert engine.window_p50_s() is None
        assert engine.compile_cache_size() is None
        assert engine.warmup() == 2
        assert engine.dispatch_p50_s() is not None
        assert engine.window_p50_s() is not None
        assert engine.queue_depth() == 0
        engine._dispatch_secs.clear()
        engine._window_secs.clear()
        engine._dispatch_secs.extend([0.1, 0.2, 0.3])
        assert engine.dispatch_p50_s() == pytest.approx(0.2)
        assert engine.window_p50_s() == pytest.approx(0.2)  # fallback
        engine._window_secs.extend([0.5, 0.7])
        assert engine.window_p50_s() == pytest.approx(0.6)
    finally:
        engine.close()


def test_gray_fault_sites_on_the_engine():
    faults.install("serving_corrupt.g:corrupt@1,serving_slow.g:slow@1")
    with serving.InferenceEngine(point_forward, None, ECFG,
                                 name="g") as engine:
        board = one_board(2)
        want = point_forward(None, board[0][None], [1], [5])[0]
        bad = engine.submit(*board).result(timeout=WAIT_S)
        assert np.array_equal(bad, 1.0 - want)   # rows perturbed on the host
        assert np.array_equal(engine.submit(*board).result(timeout=WAIT_S),
                              want)
    specs = {s.site: s.hits for s in faults.active_plan().specs}
    assert specs == {"serving_corrupt.g": 2, "serving_slow.g": 2}


@BOTH
def test_dispatch_fault_kills_only_the_named_engine(pkg):
    s, f = PKGS[pkg].serving, PKGS[pkg].faults
    f.install("serving_dispatch.victim:fail@1")
    victim = s.InferenceEngine(ok_forward, None,
                               s.EngineConfig(buckets=(1,), max_wait_ms=0.0),
                               name="victim")
    peer = s.InferenceEngine(ok_forward, None,
                             s.EngineConfig(buckets=(1,), max_wait_ms=0.0),
                             name="peer")
    try:
        with pytest.raises(f.InjectedFailure):
            victim.submit(*one_board()).result(timeout=WAIT_S)
        with pytest.raises(s.EngineError, match="died"):
            victim.submit(*one_board())
        assert peer.submit(*one_board()).result(timeout=WAIT_S) is not None
    finally:
        victim.close()
        peer.close()


def test_engine_publishes_registry_metrics_and_traces():
    rec = tracing.configure_tracing(slowest_k=100)
    with serving.InferenceEngine(ok_forward, None, ECFG,
                                 name="metered") as engine:
        engine.evaluate(*boards(3, seed=8))
        dispatches = engine.stats()["dispatches"]
    assert wait_until(lambda: rec.stats()["finished"] == 3)
    assert rec.stats()["incomplete"] == 0
    names = [e["name"] for e in rec.exemplars()[0]["events"]]
    assert names == ["queued", "coalesced", "dispatched", "resolved"]
    snap = get_registry().snapshot()["metrics"]
    assert snap["deepgo_serving_boards_total"]["series"][
        "engine=metered"] == 3.0
    assert snap["deepgo_serving_dispatches_total"]["series"][
        "engine=metered"] == float(dispatches) >= 1


# ---------------------------------------------------------------------------
# supervisor


def test_restart_replays_bitwise_on_the_port_forward():
    model = port_model(seed=1)
    forward = make_log_prob_fn(CFG, device="cpu")
    packed, player, rank = boards(4, seed=5)
    direct = forward(model, packed, player, rank)
    faults.install("serving_dispatch:fail@1")
    delays = []
    sup = serving.SupervisedEngine(
        lambda: serving.InferenceEngine(forward, model, ECFG),
        name="t", sleep=delays.append, rng=random.Random(0))
    try:
        got = sup.evaluate(packed, player, rank)
        assert np.array_equal(got, direct)   # one 4-board dispatch
        h = sup.health()
        assert h["restarts"] == 1 and h["replayed"] >= 1
        assert h["consecutive_restarts"] == 0 and h["state"] == "serving"
        assert delays == [random.Random(0).uniform(0.0, 0.05)]
    finally:
        sup.close()


@BOTH
def test_restart_backoff_and_exhaustion_like_jax(pkg):
    s, f = PKGS[pkg].serving, PKGS[pkg].faults
    f.install("serving_dispatch:transient@3")
    delays = []
    sup = make_sup(pkg, ok_forward, sleep=delays.append, rng=random.Random(3))
    try:
        assert sup.submit(*one_board()).result(timeout=WAIT_S) is not None
        ref = random.Random(3)
        assert delays == [ref.uniform(0, 0.05), ref.uniform(0, 0.1),
                          ref.uniform(0, 0.2)]
        assert sup.health()["restarts"] == 3
    finally:
        sup.close()
    f.install("serving_dispatch:transient@100")
    sup = make_sup(pkg, ok_forward, sleep=lambda d: None,
                   sup_config=s.SupervisorConfig(max_restarts=2))
    try:
        with pytest.raises(s.RestartsExhausted):
            sup.submit(*one_board()).result(timeout=WAIT_S)
        with pytest.raises(s.RestartsExhausted):
            sup.submit(*one_board())
        assert sup.health()["state"] == "failed"
    finally:
        sup.close()


@BOTH
def test_poison_bisected_through_solo_lane_and_quarantined(pkg, tmp_path):
    s = PKGS[pkg].serving
    qdir = str(tmp_path / "quarantine")
    sup = make_sup(pkg, marker_forward,
                   engine_config=s.EngineConfig(buckets=(1, 8),
                                                max_wait_ms=100.0),
                   sup_config=s.SupervisorConfig(quarantine_dir=qdir))
    try:
        packed, player, rank = boards(3, seed=9)
        innocents = [sup.submit(packed[i], int(player[i]), int(rank[i]))
                     for i in range(3)]
        bad = sup.submit(POISON_BOARD, 2, 7)
        want = marker_forward(None, packed, player, rank)
        for i, f in enumerate(innocents):
            assert f.result(timeout=WAIT_S) == want[i]
        with pytest.raises(s.PoisonedRequest) as ei:
            bad.result(timeout=WAIT_S)
        assert isinstance(ei.value.__cause__, s.BatchDispatchError)
        h = sup.health()
        assert h["poisoned"] == 1 and h["restarts"] == 0
        [qpath] = h["quarantined"]
        dump = np.load(qpath)
        assert np.array_equal(dump["packed"], POISON_BOARD)
        assert int(dump["player"]) == 2 and int(dump["rank"]) == 7
        assert sorted(os.listdir(qdir)) == ["poison-0001.npz"]
    finally:
        sup.close()


@BOTH
def test_breaker_opens_sheds_and_recovers(pkg):
    s, f = PKGS[pkg].serving, PKGS[pkg].faults
    clk = FakeClock()
    f.install("serving_forward:transient@6")
    sup = make_sup(pkg, ok_forward,
                   engine_config=s.EngineConfig(buckets=(1,),
                                                max_wait_ms=0.0),
                   sup_config=s.SupervisorConfig(breaker_failures=2,
                                                 breaker_reset_s=30.0,
                                                 poison_threshold=1000),
                   clock=clk)
    try:
        first = sup.submit(*one_board())
        assert wait_until(lambda: sup._breaker.state == "open")
        with pytest.raises(s.CircuitOpen):
            sup.submit(*one_board(1))
        assert sup.health()["shed_breaker"] == 1
        clk.advance(31)
        assert sup.submit(*one_board(2)).result(timeout=WAIT_S) is not None
        assert first.result(timeout=WAIT_S) is not None
        assert sup._breaker.state == "closed"
    finally:
        sup.close()


@BOTH
def test_admission_sheds_past_the_deadline(pkg):
    s = PKGS[pkg].serving
    release, entered = threading.Event(), threading.Event()

    def blocked(params, packed, player, rank):
        entered.set()
        assert release.wait(WAIT_S)
        return np.zeros(len(packed), np.float32)

    sup = make_sup(pkg, blocked, engine_config=s.EngineConfig(
        buckets=(1,), max_wait_ms=0.0))
    try:
        inflight = sup.submit(*one_board())
        assert entered.wait(WAIT_S)
        queued = [sup.submit(*one_board(i)) for i in range(1, 4)]
        sup._engine._dispatch_secs.extend([0.2] * 5)
        assert sup.estimated_wait_s() == pytest.approx(0.6)
        with pytest.raises(s.EngineOverloaded):
            sup.submit(*one_board(9), timeout_s=0.5)
        ok = sup.submit(*one_board(10), timeout_s=30.0)
        assert sup.health()["shed_overload"] == 1
        release.set()
        for f in (inflight, *queued, ok):
            assert f.result(timeout=WAIT_S) is not None
    finally:
        release.set()
        sup.close()


# ---------------------------------------------------------------------------
# fleet: tiers, hedging, ejection, surge tier, failover, reload


class ShedReplica(ScriptedReplica):
    def __init__(self, idx, est, pkg):
        super().__init__(idx, est=est, pkg=pkg)
        self.auto_value = np.float32(idx)


@BOTH
def test_cheap_tier_sheds_first(pkg):
    s = PKGS[pkg].serving
    fleet = scripted_fleet(pkg, [ShedReplica(0, 0.5, pkg)])
    board = np.zeros((9, 19, 19), np.uint8)
    try:
        with pytest.raises(s.EngineOverloaded):
            fleet.submit(board, 1, 5, tier="batch", timeout_s=1.0)
        fleet.submit(board, 1, 5, tier="selfplay",
                     timeout_s=1.0).result(timeout=WAIT_S)
        fleet.submit(board, 1, 5, tier="interactive",
                     timeout_s=1.0).result(timeout=WAIT_S)
        assert fleet.health()["shed"] == {"interactive": 0, "selfplay": 0,
                                          "batch": 1}
        fleet._replicas[0].engine.est = 0.8  # past selfplay's headroom
        with pytest.raises(s.EngineOverloaded):
            fleet.submit(board, 1, 5, tier="selfplay", timeout_s=1.0)
        fleet.submit(board, 1, 5, tier="interactive",
                     timeout_s=1.0).result(timeout=WAIT_S)
        fleet._replicas[0].engine.est = 2.0  # past every deadline
        with pytest.raises(s.EngineOverloaded):
            fleet.submit(board, 1, 5, tier="interactive", timeout_s=1.0)
        assert fleet.health()["shed"] == {"interactive": 1, "selfplay": 1,
                                          "batch": 1}
        with pytest.raises(ValueError, match="tier"):
            fleet.submit(board, 1, 5, tier="platinum")
    finally:
        fleet.close()


@BOTH
def test_hedge_copy_wins_over_a_stalled_replica(pkg):
    s = PKGS[pkg].serving
    stalled = ScriptedReplica(0, pkg=pkg)          # never answers by itself
    fast = ScriptedReplica(1, pkg=pkg)
    fast.auto_value = np.float32(7)
    cfg = s.FleetConfig(hedge_tiers=("interactive",), hedge_min_delay_s=0.01,
                        hedge_max_frac=1.0)
    fleet = scripted_fleet(pkg, [stalled, fast], fleet_config=cfg)
    try:
        futs = [fleet.submit(*one_board(i), tier="interactive")
                for i in range(4)]
        assert [f.result(timeout=WAIT_S) for f in futs] == [7.0] * 4
        assert stalled.futs, "round-robin placed nothing on replica 0"
        h = fleet.health()
        assert h["hedges"] >= 1 and h["hedge_wins"] >= 1
        # a batch request is never hedged: it waits for its replica
        before = fleet.health()["hedges"]
        slow = fleet.submit(*one_board(9), tier="batch")
        for fut in stalled.futs:
            if not fut.done():
                fut.set_result(np.float32(3))
        slow.result(timeout=WAIT_S)
        assert fleet.health()["hedges"] == before
    finally:
        for fut in stalled.futs:
            if not fut.done():
                fut.set_result(np.float32(3))
        fleet.close()


@BOTH
def test_ejection_baseline_is_platform_scoped(pkg):
    s = PKGS[pkg].serving
    # max_respawns=0: an ejected replica stays down, so its state is read
    # without racing a respawn that would bring it back
    cfg = s.FleetConfig(max_respawns=0, eject_stragglers=True,
                        eject_min_samples=4, eject_consecutive=1,
                        eject_factor=3.0)
    # a slow CPU replica among fast CUDA peers: no same-platform peer, so
    # it is not an outlier
    reps = [ScriptedReplica(0, "cuda", pkg=pkg),
            ScriptedReplica(1, "cuda", pkg=pkg),
            ScriptedReplica(2, "cpu", pkg=pkg)]
    fleet = scripted_fleet(pkg, reps, fleet_config=cfg)
    try:
        for rep, lat in zip(fleet._replicas, (0.01, 0.01, 0.5)):
            rep.lat.extend([lat] * 8)
        fleet._eject_outliers()
        assert fleet._ejections == 0
        assert all(r.state == "serving" for r in fleet._replicas)
    finally:
        fleet.close()
    reps = [ScriptedReplica(i, "cpu", pkg=pkg) for i in range(3)]
    fleet = scripted_fleet(pkg, reps, fleet_config=cfg)
    try:
        for rep, lat in zip(fleet._replicas, (0.01, 0.01, 0.5)):
            rep.lat.extend([lat] * 8)
        fleet._eject_outliers()
        assert fleet._ejections == 1
        assert fleet._replicas[2].state != "serving"
    finally:
        fleet.close()


@BOTH
def test_surge_preference_and_failover(pkg):
    card = ScriptedReplica(0, "cuda", pkg=pkg)
    surge = ScriptedReplica(1, "cpu", pkg=pkg)
    card.auto_value, surge.auto_value = np.float32(0), np.float32(1)
    fleet = scripted_fleet(pkg, [card, surge])
    try:
        for i in range(4):
            board = one_board(i)
            assert fleet.submit(*board, tier="batch") \
                .result(timeout=WAIT_S) == 1.0
            assert fleet.submit(*board, tier="interactive") \
                .result(timeout=WAIT_S) == 0.0
            assert fleet.submit(*board, tier="selfplay") \
                .result(timeout=WAIT_S) == 0.0
        assert len(surge.futs) == 4 and len(card.futs) == 8
        card.fail_next = 10   # the card replica is dead at submit time
        assert fleet.submit(*one_board(5), tier="interactive") \
            .result(timeout=WAIT_S) == 1.0
        assert fleet.health()["failovers"] >= 1
    finally:
        fleet.close()


@BOTH
def test_replica_death_fails_over_and_respawns(pkg):
    s, f = PKGS[pkg].serving, PKGS[pkg].faults
    f.install("serving_dispatch:fail@2")
    fleet = stub_fleet(pkg, sup_config=s.SupervisorConfig(
        max_restarts=0, backoff_base_s=0.001, backoff_cap_s=0.005))
    try:
        packed, player, rank = boards(12, seed=2)
        futs = [fleet.submit(packed[i], int(player[i]), int(rank[i]))
                for i in range(12)]
        got = np.array([fut.result(timeout=WAIT_S) for fut in futs])
        assert np.array_equal(got, ok_forward(None, packed, player, rank))
        assert fleet.health()["failovers"] >= 1
        assert wait_until(lambda: fleet.health()["respawns"] >= 1
                          and fleet.health()["state"] == "serving")
    finally:
        fleet.close()


@BOTH
def test_integrity_check_turns_corruption_into_failover(pkg):
    s, f = PKGS[pkg].serving, PKGS[pkg].faults
    cfg = s.FleetConfig(respawn_base_s=0.001, respawn_cap_s=0.005,
                        integrity_check=lambda row: bool(
                            np.all(np.asarray(row) <= 0.0)))

    def negative(params, packed, player, rank):
        return -1.0 - ok_forward(params, packed, player, rank)

    fleet = stub_fleet(pkg, forward=negative, fleet_config=cfg, name="integ")
    try:
        f.install("serving_corrupt.integ-0:corrupt@100")
        packed, player, rank = boards(8, seed=7)
        for i in range(8):
            got = fleet.submit(packed[i], int(player[i]), int(rank[i])) \
                .result(timeout=WAIT_S)
            assert got == negative(None, packed[i:i + 1], player[i:i + 1],
                                   None)[0]
        assert fleet.health()["integrity_failures"] >= 1
    finally:
        fleet.close()


def test_cached_fleet_rows_bitwise_and_hits_map_back():
    """Exact keying on the port's policy forward: leader rows equal the
    direct forward at their rung; repeats are hits equal to the leader's
    row. Canonical keying over an equivariant forward: every dihedral
    view is served bitwise equal to its own direct forward."""
    model = port_model(seed=2)
    forward = make_log_prob_fn(CFG, device="cpu")
    fleet = serving.fleet_policy_engine(
        model, CFG, replicas=2, config=serving.EngineConfig(
            buckets=(1, 4), max_wait_ms=2.0), device="cpu",
        cache=serving.CacheConfig(capacity=64))
    try:
        packed, player, rank = boards(6, seed=13)
        order = [0, 1, 2, 3, 0, 4, 1, 5, 0]
        futs = [fleet.submit(packed[i], int(player[i]), int(rank[i]))
                for i in order]
        rows = [f.result(timeout=WAIT_S) for f in futs]
        first = {}
        for i, f, row in zip(order, futs, rows):
            if f.cache == "leader":
                assert f.replica in (0, 1) and f.bucket in (1, 4)
                want = direct_rows(forward, model, fleet.ladder,
                                   packed[i:i + 1], player[i:i + 1],
                                   rank[i:i + 1], [f.bucket])[0]
                assert np.array_equal(row, want)
                first[i] = row
            else:
                assert np.array_equal(row, first[i])
        stats = fleet.stats()["fleet"]["cache"]
        assert stats["hits"] + stats["coalesced"] == 3
    finally:
        fleet.close()

    fleet = stub_fleet("port", forward=point_forward, name="canon",
                       cache=serving.CacheConfig(keying="canonical"))
    try:
        from deepgo_tpu_torch.utils import digest

        base = one_board(3)[0]
        for view in digest.dihedral_views(base):
            got = fleet.submit(view, 1, 5).result(timeout=WAIT_S)
            assert np.array_equal(
                got, point_forward(None, view[None], [1], [5])[0])
        assert fleet.stats()["fleet"]["cache"]["hits"] >= 1
    finally:
        fleet.close()


def test_fleet_restart_loses_no_request():
    model = port_model(seed=3)
    forward = make_log_prob_fn(CFG, device="cpu")
    # replica 0's dispatcher dies at its first coalescing window; rounds
    # of 8 requests run until it has taken one (placement alternates
    # between equally idle replicas, so the first round reaches it)
    faults.install("serving_dispatch.policy-fleet-0:fail@1")
    fleet = serving.fleet_policy_engine(
        model, CFG, replicas=2, config=serving.EngineConfig(
            buckets=(1, 4), max_wait_ms=2.0), device="cpu",
        supervisor=serving.SupervisorConfig(backoff_base_s=0.001,
                                            backoff_cap_s=0.002))
    try:
        packed, player, rank = boards(8 * 10, seed=14)
        for start in range(0, len(packed), 8):
            part = slice(start, start + 8)
            futs = [fleet.submit(packed[i], int(player[i]), int(rank[i]))
                    for i in range(start, start + 8)]
            rows = np.stack([f.result(timeout=WAIT_S) for f in futs])
            assert np.array_equal(rows, direct_rows(
                forward, model, fleet.ladder, packed[part], player[part],
                rank[part], [f.bucket for f in futs]))
            restarts = [r["supervisor"]["restarts"]
                        for r in fleet.stats()["replicas"]]
            if restarts[0]:
                break
        assert restarts == [1, 0]
    finally:
        fleet.close()


@pytest.mark.parametrize("source", ["module", "port_path", "jax_path"])
def test_reload_serves_the_new_weights(source, tmp_path):
    old, new = port_model(seed=4), port_model(seed=5)
    forward = make_log_prob_fn(CFG, device="cpu")
    fleet = serving.fleet_policy_engine(old, CFG, replicas=2, config=ECFG,
                                        device="cpu")
    try:
        target = new
        if source == "port_path":
            target = str(tmp_path / "new.npz")
            ckpt.save_checkpoint(target, convert.params_to_jax(new), {},
                                 {"config": {}})
        elif source == "jax_path":
            target = str(tmp_path / "new.npz")
            jax_save_checkpoint(target, jax.tree.map(
                jnp.asarray, numpy_tree(CFG, seed=5)), {}, {"config": {}})
        assert fleet.reload(target)["replicas"] == 2
        assert all(e.params is not old for _, e in
                   ((r.idx, r.engine) for r in fleet._replicas))
        packed, player, rank = boards(8, seed=15)
        futs = [fleet.submit(packed[i], int(player[i]), int(rank[i]))
                for i in range(8)]
        rows = np.stack([f.result(timeout=WAIT_S) for f in futs])
        assert np.array_equal(rows, direct_rows(
            forward, new, fleet.ladder, packed, player, rank,
            [f.bucket for f in futs]))
        assert torch.equal(old.layers[0].weight,
                           port_model(seed=4).layers[0].weight)
    finally:
        fleet.close()


def test_reload_rejects_a_checkpoint_of_another_shape(tmp_path):
    fleet = serving.fleet_policy_engine(port_model(), CFG, replicas=1,
                                        config=ECFG, device="cpu")
    other = policy_cnn.ModelConfig(num_layers=3, channels=8)
    path = str(tmp_path / "other.npz")
    ckpt.save_checkpoint(path, convert.params_to_jax(
        policy_cnn.PolicyCNN(other)), {}, {"config": {}})
    try:
        with pytest.raises(ckpt.CheckpointError):
            fleet.reload(path)
    finally:
        fleet.close()


def test_mixed_variant_fleet_behind_its_gate():
    model = grid_net()
    fleet = serving.fleet_policy_engine(
        model, CFG, replicas=2, config=ECFG, device="cpu",
        variants=("f32", "int8+sym"), tolerance=FAST_TOL)
    try:
        assert [r.engine.variant for r in fleet._replicas] \
            == ["f32", "int8+sym"]
        assert fleet._replicas[1].engine.prepare_params \
            is quant.quantize_params
        forwards = {0: (make_log_prob_fn(CFG, device="cpu"), model),
                    1: (quant.make_fused_sym_policy_fn(CFG, quant=True,
                                                       device="cpu"),
                        quant.quantize_params(model))}
        packed, player, rank = boards(10, seed=16)
        futs = [fleet.submit(packed[i], int(player[i]), int(rank[i]))
                for i in range(10)]
        for i, f in enumerate(futs):
            row = f.result(timeout=WAIT_S)
            fwd, params = forwards[f.replica]
            want = direct_rows(fwd, params, fleet.ladder, packed[i:i + 1],
                               player[i:i + 1], rank[i:i + 1], [f.bucket])
            if f.replica == 0:
                assert np.array_equal(row, want[0]), i
            else:
                # the ensemble's log-sum-exp over the views runs one
                # elementwise exp over the whole (S, B, 361) block, and the
                # CPU computes its vectorised body and its scalar tail
                # differently in the last bit: a board's row depends on
                # its position in the batch here (not on the card, where
                # chip_smoke.py holds these rows bitwise)
                assert np.abs(row - want[0]).max() <= 1e-5, i
        assert {f.replica for f in futs} == {0, 1}
    finally:
        fleet.close()
    with pytest.raises(serving.VariantToleranceError):
        serving.fleet_policy_engine(
            he_normal_net(), CFG, replicas=2, config=ECFG, device="cpu",
            variants=("f32", "int8"),
            tolerance=serving.ToleranceConfig(boards=64))


def test_platform_fleet_places_replicas_on_their_devices():
    model = port_model(seed=6)
    fleet = serving.fleet_policy_engine(
        model, CFG, replicas=2, config=ECFG, platforms=("cpu", "cpu"),
        cache=serving.CacheConfig(capacity=16))
    try:
        detail = fleet.health()["replicas"]
        assert [d["platform"] for d in detail] == ["cpu", "cpu"]
        assert all(d["platform_realized"] for d in detail)
        assert fleet._replicas[0].engine.params is model  # already there
        row = fleet.submit(*one_board(), tier="batch").result(
            timeout=WAIT_S)
        assert row.shape == (361,)
        assert fleet.eject_replica(0, reason="test-kill")
        assert fleet.submit(*one_board(1), tier="interactive") \
            .result(timeout=WAIT_S).shape == (361,)
    finally:
        fleet.close()
    with pytest.raises(ValueError):
        serving.fleet_policy_engine(model, CFG, replicas=2,
                                    platforms=("cpu",), variants=("int8",))


def test_cuda_platform_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = port_model()
    for platforms in (("cuda", "cpu"), ("cpu", "cuda"), ("cuda",)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serving.fleet_policy_engine(model, CFG, replicas=2,
                                        platforms=platforms)
    for factory in (serving.fleet_policy_engine,
                    serving.supervised_policy_engine,
                    serving.shared_policy_engine):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory(model, CFG)


def test_shared_engines_memoize_and_close():
    model = port_model(seed=7)
    a = serving.shared_policy_engine(model, CFG, config=ECFG, device="cpu")
    b = serving.shared_policy_engine(model, CFG, config=ECFG, device="cpu")
    sup = serving.shared_policy_engine(model, CFG, config=ECFG,
                                       supervised=True, device="cpu")
    fleet = serving.shared_policy_engine(model, CFG, config=ECFG, fleet=2,
                                         device="cpu")
    try:
        assert a is b and sup is not a and fleet is not sup
        assert isinstance(sup, serving.SupervisedEngine)
        assert isinstance(fleet, serving.FleetRouter) and fleet.replicas == 2
        board = one_board(4)
        rows = [e.submit(*board).result(timeout=WAIT_S)
                for e in (a, sup, fleet)]
        assert np.array_equal(rows[0], rows[1])
        assert np.array_equal(rows[0], rows[2])
    finally:
        serving.close_shared_engines()
    with pytest.raises(serving.EngineClosed):
        a.submit(*one_board())
    assert serving.shared_policy_engine(model, CFG, config=ECFG,
                                        device="cpu") is not a
    serving.close_shared_engines()


def test_ladder_for_like_jax():
    for n in (1, 2, 8, 9, 32, 100, 512, 5000):
        assert serving.ladder_for(n).buckets \
            == jax_serving.ladder_for(n).buckets
