"""The port's data path and its copies of the JAX package's helpers.

The bundled ``data/sgf`` splits are transcribed with the port (byte-equal
to the JAX package's shards, tests/test_torch_games.py) and read by both. The dataset, the sync loader
and the host batch builders give bitwise the JAX package's arrays for the
same seeds; ``DatasetWriter`` output is byte-equal. The copies under
``deepgo_tpu_torch/utils`` (atomicio, retry, faults, metrics, gitinfo)
behave like their originals.
"""

import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from deepgo_tpu.data import dataset as jax_dataset
from deepgo_tpu.data import loader as jax_loader
from deepgo_tpu.utils import atomicio as jax_atomicio
from deepgo_tpu.utils import faults as jax_faults
from deepgo_tpu.utils import gitinfo as jax_gitinfo
from deepgo_tpu.utils import metrics as jax_metrics
from deepgo_tpu.utils import retry as jax_retry

from deepgo_tpu_torch.data import dataset, loader
from deepgo_tpu_torch.data.transcribe import transcribe_split
from deepgo_tpu_torch.obs import get_registry
from deepgo_tpu_torch.utils import atomicio, faults, gitinfo, metrics, retry

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

B = 8


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("processed")
    for split in ("validation", "test"):
        transcribe_split(os.path.join(REPO_ROOT, "data/sgf", split),
                         str(root / split), workers=1, verbose=False)
    return str(root)


def both(data_root, split="validation"):
    return (dataset.GoDataset(data_root, split),
            jax_dataset.GoDataset(data_root, split))


def assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        a = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        b = np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


# ---- dataset ----


def test_dataset_reads_like_jax(data_root):
    ds, jds = both(data_root)
    assert len(ds) == len(jds) > 100 and ds.num_games == jds.num_games
    assert ds.game_names == jds.game_names
    assert np.array_equal(ds.game_ranges, jds.game_ranges)
    idx = np.array([0, 5, len(ds) - 1, 17, 5])
    for a, b in zip(ds.batch_at(idx), jds.batch_at(idx)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for n in (1, 7, 40, 10_000):
        assert np.array_equal(ds.even_indices(n), jds.even_indices(n))
        for a, b in zip(ds.even_n(n), jds.even_n(n)):
            assert np.array_equal(a, b)
    for a, b in zip(ds.first_n(9), jds.first_n(9)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("scheme", ["game", "uniform", "winner"])
def test_sampling_like_jax(data_root, tmp_path, scheme):
    ds, jds = both(data_root)
    if scheme == "winner":
        winner = np.random.default_rng(0).integers(0, 3, size=len(ds))
        for d in (ds, jds):
            d.winner = winner.astype(np.int32)
    for a, b in zip(ds.sample_batch(np.random.default_rng(4), 33, scheme),
                    jds.sample_batch(np.random.default_rng(4), 33, scheme)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="scheme"):
        ds.sample_indices(np.random.default_rng(0), 2, "nope")


def test_dataset_writer_byte_equal(data_root, tmp_path):
    src = jax_dataset.GoDataset(data_root, "test")
    writers = (dataset.DatasetWriter(str(tmp_path / "port")),
               jax_dataset.DatasetWriter(str(tmp_path / "jax")))
    for name, (start, count) in zip(src.game_names, src.game_ranges):
        part = slice(start, start + count)
        meta = src.meta[part].copy()
        meta[:, dataset.M_GAME] = 99  # rewritten by the writer
        for w in writers:
            w.add_game(name, np.asarray(src.planes[part]), meta)
    for w in writers:
        w.add_game("empty", np.zeros((0, 9, 19, 19), np.uint8),
                   np.zeros((0, 6), np.int32))
    assert [w.finalize() for w in writers] == [len(src)] * 2
    for name in ("planes.bin", "meta.npy", "games.json"):
        assert (open(tmp_path / "port" / name, "rb").read()
                == open(tmp_path / "jax" / name, "rb").read()), name
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    with pytest.raises(ValueError):
        dataset.DatasetWriter(str(tmp_path / "bad")).add_game(
            "x", np.zeros((1, 9, 19, 18), np.uint8), np.zeros((1, 6)))


def test_missing_split_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        dataset.GoDataset(str(tmp_path), "train")


# ---- loader ----


@pytest.mark.parametrize("augment,wire,stack", [
    (False, "packed", 0), (True, "nibble", 0), (True, "packed", 3),
    (False, "nibble", 2)])
def test_step_batch_bitwise_jax(data_root, augment, wire, stack):
    ds, jds = both(data_root)
    for step in (0, 1, 57):
        got = loader.make_step_batch(ds, 7, step, B, "game", augment, wire,
                                     stack=stack)
        want = jax_loader.make_step_batch(jds, 7, step, B, "game", augment,
                                          wire, stack=stack)
        assert_batches_equal(got, want)


@pytest.mark.parametrize("augment,wire", [(False, "packed"),
                                          (True, "nibble")])
def test_host_batches_bitwise_jax(data_root, augment, wire):
    ds, jds = both(data_root)
    assert_batches_equal(
        loader.make_host_batch(ds, np.random.default_rng(3), B, "uniform",
                               augment, wire),
        jax_loader.make_host_batch(jds, np.random.default_rng(3), B,
                                   "uniform", augment, wire))
    assert_batches_equal(
        loader.make_host_superbatch(ds, np.random.default_rng(3), B, 4,
                                    "game", augment, wire),
        jax_loader.make_host_superbatch(jds, np.random.default_rng(3), B, 4,
                                        "game", augment, wire))


def test_superbatch_equals_its_single_batches(data_root):
    ds, _ = both(data_root)
    k = 4
    sb = loader.make_step_batch(ds, 1, 10, B, augment=True, wire="nibble",
                                stack=k)
    for i in range(k):
        one = loader.make_step_batch(ds, 1, 10 + i, B, augment=True,
                                     wire="nibble")
        for name, v in one.items():
            assert np.array_equal(sb[name][i], v)


def test_sync_loader_is_step_indexed(data_root):
    ds, jds = both(data_root)
    with loader.AsyncLoader(ds, B, seed=5, start_step=3, num_threads=0,
                            device="cpu", stack=2, wire="nibble") as ld:
        first = ld.get()
        single = ld.get(stack=0)
        third = ld.get()
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in first.values())
    assert_batches_equal(first, jax_loader.make_step_batch(
        jds, 5, 3, B, wire="nibble", stack=2))
    assert_batches_equal(single, jax_loader.make_step_batch(
        jds, 5, 5, B, wire="nibble"))
    assert_batches_equal(third, jax_loader.make_step_batch(
        jds, 5, 6, B, wire="nibble", stack=2))


@pytest.mark.parametrize("device_prefetch", [0, 2])
def test_threaded_loader_batches(data_root, device_prefetch):
    ds, _ = both(data_root)
    with loader.AsyncLoader(ds, B, seed=3, num_threads=2, prefetch=2,
                            device="cpu", stack=3, augment=True,
                            wire="nibble",
                            device_prefetch=device_prefetch) as ld:
        batches = [ld.get() for _ in range(4)] + [ld.get(stack=0)]
    for b in batches[:4]:
        assert b["packed"].shape == (3, B, 1625)
        assert b["sym"].shape == (3, B) and b["sym"].dtype == torch.int32
        assert ((b["target"] >= 0) & (b["target"] < 361)).all()
    assert batches[4]["packed"].shape == (B, 1625)
    reg = get_registry()
    for name in ("deepgo_loader_wait_seconds", "deepgo_h2d_seconds"):
        assert reg.histogram(name).snapshot(**(
            {"path": "inline"} if name == "deepgo_h2d_seconds"
            else {}))["count"] >= 1
    assert reg.gauge("deepgo_loader_queue_depth").value(queue="host") >= 0


def test_worker_error_surfaces_in_get(data_root, monkeypatch):
    def boom(*args, **kwargs):
        raise ValueError("synthetic sampler failure")

    monkeypatch.setattr(loader, "make_host_batch", boom)
    ds, _ = both(data_root)
    with loader.AsyncLoader(ds, B, seed=3, num_threads=2, prefetch=2,
                            device="cpu", device_prefetch=1) as ld:
        with pytest.raises(RuntimeError, match="worker thread died") as ei:
            ld.get()
        assert "synthetic sampler failure" in str(ei.value.__cause__)


def test_close_returns_promptly(data_root):
    ds, _ = both(data_root)
    ld = loader.AsyncLoader(ds, B, num_threads=3, prefetch=1, device="cpu",
                            stack=2, device_prefetch=1)
    ld.get()
    time.sleep(0.2)  # let every queue fill and every thread block on put
    t0 = time.monotonic()
    ld.close(timeout=2.0)
    assert time.monotonic() - t0 < 3.0
    assert not any(t.is_alive() for t in ld._threads)
    with pytest.raises(loader.LoaderClosed):
        ld.get()


def test_cuda_loader_raises_without_cuda(data_root):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is of a CPU-only host")
    ds, _ = both(data_root)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loader.AsyncLoader(ds, B, num_threads=0)


def test_step_rng_is_jax_s():
    for seed, step in ((0, 0), (3, 17), (12345, 99999)):
        assert np.array_equal(loader.step_rng(seed, step).integers(0, 1 << 30,
                                                                   8),
                              jax_loader.step_rng(seed, step).integers(
                                  0, 1 << 30, 8))


# ---- copies of the JAX package's helpers ----


@pytest.mark.parametrize("mod", [atomicio, jax_atomicio])
def test_atomic_write(tmp_path, mod):
    path = tmp_path / "f.bin"
    with mod.atomic_write(str(path)) as f:
        f.write(b"old")
    with pytest.raises(RuntimeError):
        with mod.atomic_write(str(path)) as f:
            f.write(b"new but torn")
            raise RuntimeError("crash mid-write")
    assert path.read_bytes() == b"old"
    assert os.listdir(tmp_path) == ["f.bin"]
    with mod.atomic_write(str(path), mode="w") as f:
        f.write("new")
    assert path.read_text() == "new"


def test_retry_schedule_like_jax():
    def run(mod, jitter):
        calls, slept, seen = [0], [], []

        def fn():
            calls[0] += 1
            if calls[0] < 4:
                raise OSError(f"flaky {calls[0]}")
            return "done"

        out = mod.retry_with_backoff(
            fn, attempts=5, base_delay=0.1, factor=3.0, max_delay=0.5,
            sleep=slept.append, jitter=jitter, rng=random.Random(1),
            on_retry=lambda e, a, d: seen.append((str(e), a, d)))
        return out, slept, seen

    for jitter in (False, True):
        assert run(retry, jitter) == run(jax_retry, jitter)
    for mod in (retry, jax_retry):
        with pytest.raises(OSError):
            mod.retry_with_backoff(lambda: (_ for _ in ()).throw(OSError()),
                                   attempts=2, sleep=lambda s: None,
                                   on_retry=lambda *a: None)
        with pytest.raises(KeyError):
            mod.retry_with_backoff(lambda: {}["x"], sleep=lambda s: None)
        with pytest.raises(ValueError):
            mod.retry_with_backoff(lambda: 1, attempts=0)


@pytest.mark.parametrize("text", [
    "", "ckpt_write:fail@2", " loader_io:transient@5 , kill:step@7 ,",
    "train_step:fail@1,dist_collective:transient@3",
    "serving_slow:slow@40,serving_forward:corrupt@2"])
def test_fault_grammar_like_jax(text):
    got = faults.FaultPlan.parse(text).specs
    want = jax_faults.FaultPlan.parse(text).specs
    assert [(s.site, s.kind, s.arg) for s in got] == \
        [(s.site, s.kind, s.arg) for s in want]


@pytest.mark.parametrize("text", [
    "ckpt_write", "ckpt_write:boom@1", "ckpt_write:fail@x",
    "ckpt_write:fail@0", "kill:fail@1", "loader_io:step@3", ":fail@1"])
def test_bad_fault_specs_raise_like_jax(text):
    with pytest.raises(ValueError) as got:
        faults.FaultPlan.parse(text)
    with pytest.raises(ValueError) as want:
        jax_faults.FaultPlan.parse(text)
    assert str(got.value) == str(want.value)


def test_fault_check_fires_like_jax():
    def trace(mod):
        plan = mod.FaultPlan.parse(
            "ckpt_write:fail@2,loader_io:transient@2,kill:step@100,"
            "train_step:slow@5")
        out = []
        for site in ["ckpt_write"] * 3 + ["loader_io"] * 3 + ["train_step"]:
            try:
                plan.check(site, step=1)
                out.append((site, "ok"))
            except OSError as e:
                out.append((site, "transient", str(e)))
            except RuntimeError as e:
                out.append((site, "fail", str(e)))
        return out

    assert trace(faults) == trace(jax_faults)
    assert issubclass(faults.TransientFault, OSError)
    assert issubclass(faults.InjectedFailure, RuntimeError)


def test_fault_plan_from_env(monkeypatch):
    monkeypatch.setenv("DEEPGO_FAULTS", "loader_io:fail@1")
    faults.reset()
    try:
        with pytest.raises(faults.InjectedFailure):
            faults.check("loader_io")
        faults.check("loader_io")  # later hits succeed
        faults.install("")
        faults.check("loader_io")
    finally:
        faults.reset()


def test_loader_io_transients_absorbed(data_root, capsys):
    ds, jds = both(data_root)
    faults.install("loader_io:transient@2")
    try:
        got = ds.batch_at(np.arange(4))
    finally:
        faults.reset()
    assert all(np.array_equal(a, b) for a, b in zip(got, jds.batch_at(
        np.arange(4))))
    assert capsys.readouterr().err.count("; retry ") == 2


def test_metrics_like_jax(tmp_path):
    records = []
    for mod, name in ((metrics, "port"), (jax_metrics, "jax")):
        path = str(tmp_path / name / "metrics.jsonl")
        with mod.MetricsWriter(path) as w:
            w.write("train", step=10, loss=1.5, ewma=None)
            w.write("summary", step=10, values=[1, 2])
        w.close()  # idempotent
        with pytest.raises(ValueError):
            w.write("late")
        got = mod.read_jsonl(path)
        records.append([{k: v for k, v in r.items() if k != "time"}
                        for r in got])
        assert all(isinstance(r["time"], float) for r in got)
        reg = str(tmp_path / name / "sub" / "registry.jsonl")
        mod.append_registry(reg, {"id": "a"})
        mod.append_registry(reg, {"id": "b"})
        records.append(mod.read_jsonl(reg))
    assert records[:2] == records[2:]


def test_metrics_writer_is_thread_safe(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    with metrics.MetricsWriter(path) as w:
        threads = [threading.Thread(target=lambda i=i: [
            w.write("train", step=i * 100 + j, pad="x" * 500)
            for j in range(100)]) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    steps = sorted(r["step"] for r in metrics.read_jsonl(path))
    assert steps == list(range(800))


def test_git_sha_like_jax(tmp_path):
    assert gitinfo.git_sha() == jax_gitinfo.git_sha()
    assert gitinfo.git_sha(cwd=str(tmp_path)) is None
