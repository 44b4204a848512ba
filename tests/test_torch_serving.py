"""The port's serving layer: bucket ladder and micro-batching engine.

The ladder is held equal to the JAX package's; the port's CPU engine
answers concurrent requests with the JAX engine's rows (float32, max-abs
<= 1e-4), bitwise equal within a rung to the direct forward of the same
board padded to that rung."""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepgo_tpu.models import policy_cnn as jax_policy
from deepgo_tpu.serving import EngineConfig as JaxEngineConfig
from deepgo_tpu.serving import policy_engine as jax_policy_engine
from deepgo_tpu.serving.buckets import BucketLadder as JaxLadder
from deepgo_tpu.serving.buckets import bucketed_forward as jax_bucketed

from deepgo_tpu_torch import resolve_device
from deepgo_tpu_torch.models import convert, policy_cnn
from deepgo_tpu_torch.models.serving import (load_policy, make_log_prob_fn,
                                             make_policy_fn)
from deepgo_tpu_torch.serving import (BatchDispatchError, BucketLadder,
                                      EngineBusy, EngineClosed, EngineConfig,
                                      EngineError, InferenceEngine,
                                      bucketed_forward, policy_engine)
from deepgo_tpu_torch.serving import buckets as port_buckets
from deepgo_tpu.serving import buckets as jax_buckets

from test_torch_policy import boards, numpy_tree

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

LADDERS = [(1, 8, 32, 128, 512), (1, 4, 16), (3, 2, 2, 7)]


def tiny(compute_dtype="float32"):
    jcfg = jax_policy.ModelConfig(num_layers=3, channels=8,
                                  compute_dtype=compute_dtype)
    cfg = policy_cnn.ModelConfig(num_layers=3, channels=8,
                                 compute_dtype=compute_dtype)
    tree = numpy_tree(jcfg, seed=11)
    return jcfg, cfg, tree, convert.model_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("rungs", LADDERS)
def test_ladder_matches_jax(rungs):
    port, ref = BucketLadder(rungs), JaxLadder(rungs)
    assert port.buckets == ref.buckets and port.max_bucket == ref.max_bucket
    for n in range(1, 2 * ref.max_bucket + 3):
        assert port.plan(n) == ref.plan(n)
        if n <= ref.max_bucket:
            assert port.bucket_for(n) == ref.bucket_for(n)
    packed, player, rank = boards(3, seed=1)
    bucket = ref.bucket_for(3)
    for got, want in zip(port.pad(packed, player, rank, bucket),
                         ref.pad(packed, player, rank, bucket)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (port_buckets.DEFAULT_BUCKETS, port_buckets.PAD_PLAYER,
            port_buckets.PAD_RANK) == (jax_buckets.DEFAULT_BUCKETS,
                                       jax_buckets.PAD_PLAYER,
                                       jax_buckets.PAD_RANK)


def test_ladder_rejects_what_jax_rejects():
    for bad in ((), (0, 4)):
        with pytest.raises(ValueError):
            BucketLadder(bad)
    with pytest.raises(ValueError):
        BucketLadder((1, 4)).bucket_for(5)
    with pytest.raises(ValueError):
        BucketLadder((1, 4)).bucket_for(0)


def test_bucketed_forward_matches_jax():
    ladder, ref = BucketLadder((1, 4)), JaxLadder((1, 4))
    packed, player, rank = boards(11, seed=2)
    seen = []

    def fn(p, pl, rk):
        seen.append(len(p))
        return p.reshape(len(p), -1)[:, :5].astype(np.int32) + pl[:, None]

    got = bucketed_forward(fn, packed, player, rank, ladder)
    assert seen == [4, 4, 4]
    assert np.array_equal(got, jax_bucketed(fn, packed, player, rank, ref))


def test_cpu_engine_matches_jax_engine_concurrently():
    jcfg, cfg, tree, model = tiny()
    packed, player, rank = boards(48, seed=3)
    with jax_policy_engine({"layers": [{k: jnp.asarray(v) for k, v in
                                        layer.items()}
                                       for layer in tree["layers"]]}, jcfg,
                           config=JaxEngineConfig(buckets=(1, 8, 32))) as je:
        want = je.evaluate(packed, player, rank)
    rows = [None] * len(packed)
    engine = policy_engine(model, cfg, config=EngineConfig(
        buckets=(1, 8, 32), max_wait_ms=5.0), device="cpu")
    try:
        assert engine.warmup() == 3

        def worker(idx):
            futures = [(i, engine.submit(packed[i], player[i], rank[i]))
                       for i in idx]
            for i, f in futures:
                rows[i] = f.result(timeout=60)

        threads = [threading.Thread(target=worker, args=(range(k, 48, 8),))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        engine.close()
    got = np.stack(rows)
    assert got.shape == (48, 361) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4
    stats = engine.stats()
    assert stats["boards"] == 48
    assert stats["forwards"] == stats["dispatches"] + 3


def test_rows_bitwise_equal_direct_forward_at_their_rung():
    _, cfg, _, model = tiny(compute_dtype="bfloat16")
    forward = make_log_prob_fn(cfg, device="cpu")
    ladder = BucketLadder((1, 4, 16))
    packed, player, rank = boards(21, seed=4)
    with policy_engine(model, cfg, config=EngineConfig(
            buckets=ladder.buckets, max_wait_ms=20.0),
            device="cpu") as engine:
        futures = [engine.submit(packed[i], player[i], rank[i])
                   for i in range(21)]
        rows = [f.result(timeout=60) for f in futures]
        buckets = [f.bucket for f in futures]
    assert set(buckets) <= set(ladder.buckets)
    for i, (row, bucket) in enumerate(zip(rows, buckets)):
        # board i alone, padded with filler rows up to its rung
        direct = forward(model, *ladder.pad(packed[i:i + 1], player[i:i + 1],
                                            rank[i:i + 1], bucket))[0]
        assert np.array_equal(row, direct), (i, bucket)


def slow_forward(delay, entered=None):
    """A forward that takes ``delay`` seconds; it sets ``entered`` (a
    threading.Event) as it starts."""
    def forward(params, packed, player, rank):
        if entered is not None:
            entered.set()
        time.sleep(delay)
        return np.zeros((len(packed), 361), np.float32)

    return forward


def test_close_without_drain_fails_pending_futures():
    entered = threading.Event()
    engine = InferenceEngine(slow_forward(0.3, entered), None,
                             config=EngineConfig(buckets=(1,),
                                                 max_wait_ms=0.0))
    packed, player, rank = boards(4)
    futures = [engine.submit(packed[i], player[i], rank[i]) for i in range(4)]
    assert entered.wait(timeout=30)  # the first request is in the forward
    engine.close(drain=False)
    assert all(f.done() for f in futures)
    failed = [f for f in futures if f.exception() is not None]
    assert failed and all(isinstance(f.exception(), EngineClosed)
                          for f in failed)
    with pytest.raises(EngineClosed):
        engine.submit(packed[0], 1, 1)


def test_close_drains_pending_futures():
    engine = InferenceEngine(slow_forward(0.02), None, config=EngineConfig(
        buckets=(1, 2), max_wait_ms=0.0))
    packed, player, rank = boards(6)
    futures = [engine.submit(packed[i], player[i], rank[i]) for i in range(6)]
    engine.close(drain=True)
    assert all(f.result().shape == (361,) for f in futures)


def test_forward_error_fails_only_its_batch():
    calls = []

    def flaky(params, packed, player, rank):
        calls.append(len(packed))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return np.ones((len(packed), 361), np.float32)

    packed, player, rank = boards(2)
    with InferenceEngine(flaky, None, config=EngineConfig(
            buckets=(1,), max_wait_ms=0.0)) as engine:
        with pytest.raises(BatchDispatchError) as ei:
            engine.submit(packed[0], 1, 1).result(timeout=10)
        assert ei.value.batch_size == 1
        assert isinstance(ei.value.__cause__, RuntimeError)
        assert engine.submit(packed[1], 1, 1).result(timeout=10).sum() == 361
        assert engine.stats()["dispatch_failures"] == 1


def test_dispatcher_death_surfaces_on_next_submit():
    engine = InferenceEngine(slow_forward(0.0), None, config=EngineConfig(
        buckets=(1,), max_wait_ms=0.0))
    packed, _, _ = boards(1)

    def die(batch):
        raise SystemExit("dispatcher killed")

    engine._dispatch = die
    f = engine.submit(packed[0], 1, 1)
    with pytest.raises(SystemExit):
        f.result(timeout=10)
    with pytest.raises(EngineError, match="died"):
        engine.submit(packed[0], 1, 1)
    engine.close()


def test_expired_request_times_out():
    packed, _, _ = boards(3)
    with InferenceEngine(slow_forward(0.2), None, config=EngineConfig(
            buckets=(1,), max_wait_ms=0.0)) as engine:
        first = engine.submit(packed[0], 1, 1)
        late = engine.submit(packed[1], 1, 1, timeout_s=0.01)
        assert first.result(timeout=10).shape == (361,)
        with pytest.raises(TimeoutError):
            late.result(timeout=10)
        assert engine.stats()["timeouts"] == 1


def test_full_queue_pushes_back():
    packed, _, _ = boards(1)
    entered = threading.Event()
    with InferenceEngine(slow_forward(0.3, entered), None, config=EngineConfig(
            buckets=(1,), max_wait_ms=0.0, max_queue=2)) as engine:
        engine.submit(packed[0], 1, 1)
        # the dispatcher holds the first; the queue is empty
        assert entered.wait(timeout=30)
        engine.submit(packed[0], 1, 1, block=False)
        engine.submit(packed[0], 1, 1, block=False)
        with pytest.raises(EngineBusy):
            engine.submit(packed[0], 1, 1, block=False)


def test_stats_accounting():
    _, cfg, _, model = tiny()
    packed, player, rank = boards(5, seed=5)
    with policy_engine(model, cfg, config=EngineConfig(
            buckets=(1, 8), max_wait_ms=0.0), device="cpu") as engine:
        engine.warmup()
        engine.evaluate(packed, player, rank)
        stats = engine.stats()
    assert stats["boards"] == 5 and stats["warm_shapes"] == 2
    assert stats["forwards"] == stats["dispatches"] + 2
    assert sum(stats["bucket_hits"].values()) == stats["dispatches"]
    assert 0 < stats["occupancy"] <= 1 and stats["p50_ms"] is not None


def test_without_cuda_entry_points_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg, _, model = tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        policy_engine(model, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_log_prob_fn(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_policy_fn(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        policy_cnn.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_policy(str(tmp_path / "absent.npz"))
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")
