"""The port's hot spans (``obs.spans.hot_span``) and where they open, on
the CPU.

* the hot form: it observes into ``deepgo_span_seconds{name, status}`` of
  the registry current at its exit, or into the histogram it is given,
  shows by name among a CPU ``torch.profiler`` capture's host events,
  records ``status=error`` and re-raises, and writes no sink line and
  calls no listener; ``hot_laps`` observes back-to-back spans from the
  caller's stamps into the registry current when it was made;
* every serving forward (``models/serving.py``, ``models/quant.py``) runs
  one each of ``serve.h2d``, ``serve.net`` and ``serve.d2h`` a call,
  captured or not, in that order and without overlap;
* a 2-worker ``AsyncLoader`` records ``loader.sample`` for every batch it
  delivered and one ``deepgo_loader_wait_seconds`` observation a ``get()``;
* a train step's ``train.*`` ranges lie inside its ``train.step``.
"""

import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepgo_tpu_torch.data.dataset import DatasetWriter, GoDataset
from deepgo_tpu_torch.data.loader import AsyncLoader
from deepgo_tpu_torch.models import policy_cnn, quant, serving, value_cnn
from deepgo_tpu_torch.obs import (MetricsRegistry, add_span_listener,
                                  get_registry, hot_laps, hot_span,
                                  registry, remove_span_listener, trace_to)
from deepgo_tpu_torch.training import optimizers, steps

torch.set_num_threads(2)

SERVE = ("serve.h2d", "serve.net", "serve.d2h")


def span_count(name: str, status: str = "ok") -> int:
    snap = get_registry().histogram("deepgo_span_seconds").snapshot(
        name=name, status=status)
    return 0 if snap is None else snap["count"]


def host_ranges(prof, names) -> dict:
    """name -> [(start_ns, end_ns, thread)] of the capture's host events."""
    out = {n: [] for n in names}
    for e in prof.profiler.kineto_results.events():
        if e.name() in out and e.device_type() != torch.autograd.DeviceType.CUDA:
            out[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                  e.start_thread_id()))
    return out


def test_hot_span_observes_into_the_span_histogram():
    before = span_count("test.hot")
    with hot_span("test.hot"):
        pass
    snap = get_registry().histogram("deepgo_span_seconds").snapshot(
        name="test.hot", status="ok")
    assert snap["count"] == before + 1 and snap["min"] >= 0.0


def test_hot_span_observes_into_the_histogram_it_is_given():
    hist = MetricsRegistry().histogram("deepgo_h2d_seconds")
    before = span_count("test.given")
    for _ in range(3):
        with hot_span("test.given", hist, path="inline"):
            pass
    assert hist.snapshot(path="inline")["count"] == 3
    assert hist.snapshot() is None
    assert span_count("test.given") == before


def test_hot_span_observes_into_the_registry_current_at_its_exit(
        monkeypatch):
    with hot_span("test.swapped"):
        pass
    mine = MetricsRegistry()
    monkeypatch.setattr(registry, "_default", mine)
    with hot_span("test.swapped"):
        pass
    assert mine.histogram("deepgo_span_seconds").snapshot(
        name="test.swapped", status="ok")["count"] == 1
    monkeypatch.undo()
    before = span_count("test.swapped")
    with hot_span("test.swapped"):
        pass
    assert span_count("test.swapped") == before + 1


def test_hot_laps_observe_back_to_back_spans(monkeypatch):
    mine = MetricsRegistry()
    monkeypatch.setattr(registry, "_default", mine)
    laps = hot_laps("a", "b", "c")
    monkeypatch.undo()  # bound when made
    laps.observe([1.0, 1.25, 2.0, 2.5])
    laps.observe([3.0, 3.5, 3.75, 4.0])
    laps.failed([5.0, 5.5, 6.0])  # "b" raised
    hist = mine.histogram("deepgo_span_seconds")
    got = {(n, st): (snap["count"], snap["sum"]) for n in "abc"
           for st in ("ok", "error")
           if (snap := hist.snapshot(name=n, status=st)) is not None}
    assert got == {("a", "ok"): (3, 1.25), ("b", "ok"): (2, 1.0),
                   ("b", "error"): (1, 0.5), ("c", "ok"): (2, 0.75)}
    assert span_count("a") == 0


def test_a_bound_observer_counts_as_observe_does():
    bound, plain = MetricsRegistry(), MetricsRegistry()
    observe = bound.histogram("deepgo_span_seconds").observer(
        name="x", status="ok")
    assert bound.histogram("deepgo_span_seconds").collect() == {}
    for v in (3e-4, 0.02, 0.02, 7.0, 100.0):
        observe(v)
        plain.histogram("deepgo_span_seconds").observe(v, name="x",
                                                       status="ok")
    assert bound.snapshot()["metrics"] == plain.snapshot()["metrics"]


def test_hot_span_on_a_raise_records_error_and_re_raises():
    before = span_count("test.raise", "error")
    with pytest.raises(KeyError, match="boom"):
        with hot_span("test.raise"):
            raise KeyError("boom")
    assert span_count("test.raise", "error") == before + 1
    hist = MetricsRegistry().histogram("deepgo_loader_wait_seconds")
    with pytest.raises(KeyError):
        with hot_span("test.raise", hist):
            raise KeyError("boom")
    assert hist.snapshot() is None


def test_hot_span_writes_no_sink_line_and_calls_no_listener():
    class Sink:
        lines = []

        def write(self, kind, **fields):
            self.lines.append((kind, fields))

    heard = []
    add_span_listener(heard.append)
    try:
        with trace_to(Sink()) as sink:
            with hot_span("test.quiet"):
                pass
    finally:
        remove_span_listener(heard.append)
    assert sink.lines == [] and heard == []


def test_hot_span_shows_in_a_cpu_capture():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with hot_span("test.captured"):
            with hot_span("test.inner"):
                torch.ones(4).sum()
    got = host_ranges(prof, ("test.captured", "test.inner"))
    (outer,), (inner,) = got["test.captured"], got["test.inner"]
    assert outer[0] <= inner[0] and inner[1] <= outer[1]
    names = {e.name(): e.is_user_annotation()
             for e in prof.profiler.kineto_results.events()}
    assert names["test.captured"] and names["test.inner"]


def policy_model(**kw):
    cfg = policy_cnn.ModelConfig(num_layers=2, channels=8,
                                 compute_dtype="float32", **kw)
    return cfg, policy_cnn.PolicyCNN(cfg)


def forward(kind: str):
    """(forward fn, params) of one serving forward on the CPU."""
    if kind == "value":
        cfg = value_cnn.ValueConfig(num_layers=2, channels=8, head_hidden=8,
                                    compute_dtype="float32")
        return serving.make_value_fn(cfg, device="cpu"), \
            value_cnn.ValueCNN(cfg)
    cfg, model = policy_model()
    if kind == "log_prob":
        return serving.make_log_prob_fn(cfg, device="cpu"), model
    if kind == "policy":
        return serving.make_policy_fn(cfg, top_k=3, device="cpu"), model
    if kind == "sym":
        return serving.make_sym_policy_fn(cfg, device="cpu"), model
    qmodel = quant.quantize_params(model)
    if kind == "quant":
        return quant.make_quant_log_prob_fn(cfg, device="cpu"), qmodel
    return quant.make_fused_sym_policy_fn(cfg, quant=True, symmetries=2,
                                          device="cpu"), qmodel


def boards(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, size=(n, 9, 19, 19), dtype=np.uint8),
            rng.integers(1, 3, size=n).astype(np.int32),
            rng.integers(1, 10, size=n).astype(np.int32))


@pytest.mark.parametrize("kind", ["log_prob", "policy", "sym", "value",
                                  "quant", "fused_sym"])
def test_a_serving_forward_runs_its_three_spans_once_a_call(kind):
    fn, params = forward(kind)
    before = {n: span_count(n) for n in SERVE}
    out = fn(params, *boards(4))
    leaves = out.values() if isinstance(out, dict) else [out]
    assert all(isinstance(v, np.ndarray) and len(v) == 4 for v in leaves)
    assert {n: span_count(n) - before[n] for n in SERVE} == \
        dict.fromkeys(SERVE, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        again = fn(params, *boards(4))
    leaves_again = again.values() if isinstance(again, dict) else [again]
    assert all(np.array_equal(a, b) for a, b in zip(leaves, leaves_again))
    assert {n: span_count(n) - before[n] for n in SERVE} == \
        dict.fromkeys(SERVE, 2)
    got = host_ranges(prof, SERVE)
    assert all(len(got[n]) == 1 for n in SERVE)
    (h2d,), (net,), (d2h,) = (got[n] for n in SERVE)
    assert h2d[1] <= net[0] and net[1] <= d2h[0]


def test_serve_holds_no_reference_to_the_staged_inputs():
    """The net pops the staged inputs: once it drops them they are freed,
    before the network runs, as in a forward without spans."""
    freed = []

    def net(params, staged):
        refs = [weakref.ref(t) for t in staged.pop()]
        freed.append(all(r() is None for r in refs))
        return torch.zeros(2)

    serving.serve(serving.serve_laps(), torch.device("cpu"), net, None,
                  *boards(2))
    assert freed == [True]


def test_a_serving_call_that_raises_records_its_span_as_an_error():
    def net(params, staged):
        raise RuntimeError("boom")

    before = {(n, s): span_count(n, s) for n in SERVE
              for s in ("ok", "error")}
    with pytest.raises(RuntimeError, match="boom"):
        serving.serve(serving.serve_laps(), torch.device("cpu"), net, None,
                      *boards(2))
    assert {k: span_count(*k) - v for k, v in before.items()} == {
        ("serve.h2d", "ok"): 1, ("serve.h2d", "error"): 0,
        ("serve.net", "ok"): 0, ("serve.net", "error"): 1,
        ("serve.d2h", "ok"): 0, ("serve.d2h", "error"): 0}


def test_a_refused_model_opens_no_serving_span():
    fn, _ = forward("log_prob")
    _, other = policy_model(kernel=5)
    before = {n: span_count(n, s) for n in SERVE for s in ("ok", "error")}
    with pytest.raises(ValueError, match="forward config"):
        fn(other, *boards(2))
    assert {n: span_count(n, s) for n in SERVE
            for s in ("ok", "error")} == before


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A split of 8 games x 16 random positions."""
    root = tmp_path_factory.mktemp("spans")
    rng = np.random.default_rng(0)
    w = DatasetWriter(str(root / "train"))
    for g in range(8):
        meta = np.stack([rng.integers(1, 3, 16), rng.integers(0, 19, 16),
                         rng.integers(0, 19, 16), rng.integers(1, 10, 16),
                         rng.integers(1, 10, 16), np.zeros(16)], axis=1)
        w.add_game(f"g{g}", rng.integers(0, 3, size=(16, 9, 19, 19),
                                         dtype=np.uint8), meta)
    w.finalize()
    return str(root)


@pytest.mark.parametrize("device_prefetch", [0, 2])
def test_a_threaded_loader_spans_its_workers_and_times_each_get_once(
        tiny_root, device_prefetch):
    wait = get_registry().histogram("deepgo_loader_wait_seconds")
    h2d = get_registry().histogram("deepgo_h2d_seconds")
    path = "uploader" if device_prefetch else "inline"

    def count(hist, **labels):
        snap = hist.snapshot(**labels)
        return 0 if snap is None else snap["count"]

    waits, uploads = count(wait), count(h2d, path=path)
    samples, puts = span_count("loader.sample"), span_count("loader.put_wait")
    with AsyncLoader(GoDataset(tiny_root, "train"), 8, seed=1,
                     num_threads=2, prefetch=2, device="cpu", wire="nibble",
                     device_prefetch=device_prefetch) as ld:
        for _ in range(6):
            assert ld.get()["packed"].shape == (8, 1625)
    assert count(wait) - waits == 6
    assert span_count("loader.sample") - samples >= 6
    assert span_count("loader.put_wait") - puts >= 6
    assert count(h2d, path=path) - uploads >= 6
    for name in ("loader.get", "loader.upload"):
        assert span_count(name) == 0  # timed into the loader's own families


def test_a_train_step_runs_its_parts_inside_train_step():
    cfg, model = policy_model()
    optimizer = optimizers.sgd(0.01)
    step = steps.make_train_step(cfg, optimizer, augment=True)
    rng = np.random.default_rng(0)
    packed, player, rank = boards(4)
    batch = {"packed": torch.from_numpy(packed),
             "player": torch.from_numpy(player),
             "rank": torch.from_numpy(rank),
             "target": torch.from_numpy(
                 rng.integers(0, 361, 4).astype(np.int32)),
             "sym": torch.from_numpy(rng.integers(0, 8, 4).astype(np.int32))}
    opt_state = optimizer.init(model)
    parts = ("train.unwire", "train.augment", "train.expand",
             "train.forward", "train.loss", "train.backward",
             "train.optimizer")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, opt_state, batch)
    got = host_ranges(prof, ("train.step",) + parts)
    ((s0, s1, thread),) = got["train.step"]
    for name in parts:
        ((p0, p1, t),) = got[name]
        assert t == thread and s0 <= p0 and p1 <= s1, name
