"""The serving forward's chunked copy/compute pipeline (``models/serving.py``:
``_chunk_plan``, ``_pipeline_plan``, ``_serve_chunks``, ``_stitch``).

On the CPU: the plan (no chunking below two chunks, near-equal chunks, none
under ``CARD_MIN_ROWS``), which calls take it, the host copy into staging
(any array the whole path takes), the stitching of chunk results (bitwise
each of the six forwards that reach ``serve``, owning its memory), the
three laps of a call and the chunk counter's whole calls.

On the card (skipped without CUDA; ``python -m pytest --noconftest
tests/test_torch_serving_pipeline.py`` runs them there, since the tests'
conftest imports JAX): the pipelined ``full`` forward at B = 8,192 bitwise
the whole-batch call, the six forwards' pipelined rows, inputs the numpy
copy has to take, the laps of a call and of a failing middle chunk, engine
rungs on today's path, two threads, the call under ``DEEPGO_XLACHECK=1``
with the sync check armed, and a profiler capture in which the copies
overlap kernels.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepgo_tpu_torch.analysis import cudacheck
from deepgo_tpu_torch.models import policy_cnn, quant, serving, value_cnn
from deepgo_tpu_torch.obs import get_registry

torch.set_num_threads(2)

SERVE = ("serve.h2d", "serve.net", "serve.d2h")
KINDS = ("log_prob", "policy", "sym", "value", "quant", "fused_sym")


def span_count(name: str, status: str = "ok") -> int:
    snap = get_registry().histogram("deepgo_span_seconds").snapshot(
        name=name, status=status)
    return 0 if snap is None else snap["count"]


@pytest.fixture
def pipelined(monkeypatch):
    """The chunk counts of the calls that take the pipeline from here on."""
    counts = []
    take = serving._serve_chunks

    def counted(laps, device, net, params, packed, player, rank, plan):
        counts.append(len(plan))
        return take(laps, device, net, params, packed, player, rank, plan)

    monkeypatch.setattr(serving, "_serve_chunks", counted)
    return counts


def forward(kind: str, device="cpu"):
    """(forward fn, params) of one of the six forwards that reach
    ``serve``, at a small width."""
    if kind == "value":
        cfg = value_cnn.ValueConfig(num_layers=2, channels=8, head_hidden=8,
                                    compute_dtype="float32")
        return serving.make_value_fn(cfg, device=device), \
            value_cnn.ValueCNN(cfg).to(device)
    cfg = policy_cnn.ModelConfig(num_layers=2, channels=8,
                                 compute_dtype="float32")
    model = policy_cnn.PolicyCNN(cfg).to(device)
    if kind == "log_prob":
        return serving.make_log_prob_fn(cfg, device=device), model
    if kind == "policy":
        return serving.make_policy_fn(cfg, top_k=3, device=device), model
    if kind == "sym":
        return serving.make_sym_policy_fn(cfg, device=device), model
    qmodel = quant.quantize_params(model)
    if kind == "quant":
        return quant.make_quant_log_prob_fn(cfg, device=device), qmodel
    return quant.make_fused_sym_policy_fn(cfg, quant=True, symmetries=2,
                                          device=device), qmodel


def boards(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, size=(n, 9, 19, 19), dtype=np.uint8),
            rng.integers(1, 3, size=n).astype(np.int32),
            rng.integers(1, 10, size=n).astype(np.int32))


def leaves(out) -> dict:
    return out if isinstance(out, dict) else {None: out}


def cuts(stops) -> list[slice]:
    """Slices of consecutive boards ending at ``stops``."""
    return [slice(a, b) for a, b in zip([0, *stops[:-1]], stops)]


# -- the plan -----------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 64, 128, 1000, 2048, 4096])
@pytest.mark.parametrize("batch", [1, 127, 255, 256, 257, 4095, 4096, 4097,
                                   6143, 8192, 8193, 20001])
def test_chunk_plan(batch, chunk):
    plan = serving._chunk_plan(batch, chunk)
    least = max(chunk, 2 * serving.CARD_MIN_ROWS)
    if batch < 2 * least:
        assert plan == []
        return
    assert len(plan) == -(-batch // least) >= 2
    assert [s.start for s in plan] == [0, *(s.stop for s in plan[:-1])]
    assert plan[-1].stop == batch and all(s.step is None for s in plan)
    sizes = [s.stop - s.start for s in plan]
    assert max(sizes) - min(sizes) <= 1
    assert min(sizes) >= serving.CARD_MIN_ROWS and max(sizes) <= least


def test_the_chunk_is_a_module_constant_that_splits_the_bulk_cell_in_four():
    assert len(serving._chunk_plan(8192, serving.SERVE_CHUNK_BOARDS)) == 4
    assert serving.SERVE_CHUNK_BOARDS >= 2 * serving.CARD_MIN_ROWS


@pytest.mark.parametrize("batch", [1, 512, 4095, 4096, 8192])
def test_pipeline_plan_takes_bulk_host_arrays_on_the_card_alone(batch):
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    arrays = boards(batch)
    bulk = batch >= 2 * serving.SERVE_CHUNK_BOARDS
    assert serving._pipeline_plan(cuda, *arrays) == (
        serving._chunk_plan(batch, serving.SERVE_CHUNK_BOARDS) if bulk
        else [])
    assert serving._pipeline_plan(cpu, *arrays) == []
    tensors = [torch.from_numpy(a) for a in arrays]
    assert serving._pipeline_plan(cuda, *tensors) == []
    assert serving._pipeline_plan(cuda, arrays[0], tensors[1],
                                  arrays[2]) == []


def _odd(case: str) -> np.ndarray:
    """An int32-valued (2, 12) array in a layout or dtype the whole path's
    ``np.ascontiguousarray`` takes."""
    base = np.arange(48, dtype=np.int32).reshape(4, 12)
    if case == "plain":
        return base[:2].copy()
    if case == "read_only":
        src = base[:2].copy()
        src.flags.writeable = False
        return src
    if case == "reversed":
        return base[::-1][:2]
    if case == "strided":
        return base[::2]
    if case == "columns_reversed":
        return base[:2, ::-1]
    if case == "big_endian":
        return base[:2].astype(">i4")
    if case == "int64":
        return base[:2].astype(np.int64)
    return base[:2].astype(np.float64)  # float64


@pytest.mark.parametrize("case", ["plain", "read_only", "reversed",
                                  "strided", "columns_reversed",
                                  "big_endian", "int64", "float64"])
def test_host_copy_takes_what_the_whole_path_takes(case):
    src = _odd(case)
    dst = torch.zeros(2, 12, dtype=torch.int32)
    serving._host_copy(dst, src)
    assert np.array_equal(dst.numpy(), np.ascontiguousarray(src, np.int32))


# -- the stitching of chunk results on the CPU -------------------------------


def stitched(fn, params, arrays, plan):
    """The forward of each chunk of ``plan`` stitched as the pipeline
    stitches them."""
    result = {}
    for where in plan:
        serving._stitch(result, leaves(fn(params, *(a[where]
                                                    for a in arrays))),
                        where, plan[-1].stop)
    return result


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("stops", [(3, 7, 10), (4, 9), (1, 2, 3, 4, 5, 6,
                                                        7, 8, 9, 10)])
def test_stitched_chunks_are_the_forwards_rows(kind, stops):
    """The rows of each chunk's forward, stitched in order, are the whole
    forward's, of its dtype and shape (dict, 2-D and 1-D outputs; a batch
    that is no multiple of the chunk)."""
    fn, params = forward(kind)
    arrays = boards(stops[-1], seed=len(stops))
    whole = leaves(fn(params, *arrays))
    got = stitched(fn, params, arrays, cuts(list(stops)))
    assert list(got) == list(whole)
    for key, rows in got.items():
        assert rows.dtype == whole[key].dtype
        assert rows.shape == whole[key].shape
        if kind not in ("sym", "fused_sym"):
            # a row's result is its own on the CPU; the view mixtures' exp
            # rounds by position (a vectorised body and a scalar tail)
            assert np.array_equal(rows, whole[key])
        else:
            np.testing.assert_allclose(rows, whole[key], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["policy", "value"])
def test_a_stitched_result_owns_its_memory(kind):
    fn, params = forward(kind)
    for rows in stitched(fn, params, boards(9), cuts([5, 9])).values():
        assert rows.base is None and rows.flags.owndata
        assert rows.flags.writeable and rows.flags.c_contiguous


def test_a_call_runs_one_lap_of_each_span():
    fn, params = forward("log_prob")
    before = {n: span_count(n) for n in SERVE}
    fn(params, *boards(8))
    assert {n: span_count(n) - before[n] for n in SERVE} == \
        dict.fromkeys(SERVE, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(params, *boards(8))
    assert {n: span_count(n) - before[n] for n in SERVE} == \
        dict.fromkeys(SERVE, 2)
    ranges = {n: [] for n in SERVE}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ranges:
            ranges[e.name()].append((e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
    assert all(len(r) == 1 for r in ranges.values())
    (h2d,), (net,), (d2h,) = (ranges[n] for n in SERVE)
    assert h2d[1] <= net[0] and net[1] <= d2h[0]


@pytest.mark.parametrize("part", [0, 1, 2])
def test_a_part_that_raises_fails_its_lap(part):
    def step(i):
        def run(x=None):
            if i == part:
                raise RuntimeError("boom")
            return x
        return run

    before = {(n, s): span_count(n, s) for n in SERVE
              for s in ("ok", "error")}
    with pytest.raises(RuntimeError, match="boom"):
        serving._in_laps(serving.serve_laps(), step(0), step(1), step(2))
    want = {}
    for i, n in enumerate(SERVE):
        want[n, "ok"], want[n, "error"] = int(i < part), int(i == part)
    assert {k: span_count(*k) - v for k, v in before.items()} == want


def test_cpu_calls_and_staged_tensors_are_served_whole(pipelined):
    fn, params = forward("log_prob")
    arrays = boards(2 * serving.SERVE_CHUNK_BOARDS)
    fn(params, *arrays)
    fn(params, *(torch.from_numpy(a) for a in arrays))
    assert pipelined == []


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pipeline's streams and pinned "
                    "memory have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _full(device):
    cfg = policy_cnn.CONFIGS["full"]
    model = policy_cnn.init(torch.Generator().manual_seed(7), cfg)
    return cfg, model.to(device)


def _whole(fn, model, arrays, device):
    """The forward served whole: its inputs staged on the card first."""
    return fn(model, *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in arrays))


@pytest.mark.parametrize("chunk", [1024, 2048, 4096])
def test_card_pipelined_full_forward_is_the_whole_batch(chunk):
    device = _card()
    cfg, model = _full(device)
    fn = serving.make_log_prob_fn(cfg, device=device)
    arrays = boards(8192, seed=3)
    whole = _whole(fn, model, arrays, device)
    net = serving._log_probs_net(cfg, device)
    plan = serving._chunk_plan(8192, chunk)
    assert len(plan) == 8192 // chunk
    with torch.inference_mode():
        got = serving._serve_chunks(serving.serve_laps(), device, net, model,
                                    *arrays, plan)
    assert got.shape == whole.shape and got.dtype == whole.dtype
    assert np.array_equal(got, whole)


def test_card_bulk_call_takes_the_pipeline(pipelined):
    device = _card()
    cfg, model = _full(device)
    fn = serving.make_log_prob_fn(cfg, device=device)
    arrays = boards(8192, seed=4)
    fn(model, *arrays)
    got = fn(model, *arrays)
    assert pipelined == [4, 4]
    assert got.flags.owndata and got.flags.writeable
    assert np.array_equal(got, _whole(fn, model, arrays, device))


@pytest.mark.parametrize("kind", KINDS)
def test_card_each_forward_pipelines_to_its_chunks_rows(kind, pipelined):
    """Dict, 2-D and 1-D outputs of each forward that reaches ``serve``,
    at a batch that is no multiple of the chunk: bitwise the rows of each
    chunk served whole, in order."""
    device = _card()
    fn, params = forward(kind, device)
    batch = 2 * serving.SERVE_CHUNK_BOARDS + 3
    arrays = boards(batch, seed=10)
    plan = serving._chunk_plan(batch, serving.SERVE_CHUNK_BOARDS)
    got = fn(params, *arrays)
    assert pipelined == [len(plan)] == [3]
    by_chunk = [leaves(_whole(fn, params, [a[s] for a in arrays], device))
                for s in plan]
    assert type(got) is type(_whole(fn, params, arrays, device))
    for key, rows in leaves(got).items():
        want = np.concatenate([c[key] for c in by_chunk])
        assert rows.dtype == want.dtype and rows.shape == want.shape
        assert np.array_equal(rows, want)
        assert rows.flags.owndata and rows.flags.c_contiguous


def test_card_pipeline_takes_what_the_whole_path_takes(pipelined):
    """A reversed view of the records, a big-endian player and a read-only
    int64 rank, as a file or a slice hands them over."""
    device = _card()
    cfg, model = _full(device)
    fn = serving.make_log_prob_fn(cfg, device=device)
    packed, player, rank = boards(8192, seed=11)
    rank = rank.astype(np.int64)
    rank.flags.writeable = False
    odd = (packed[::-1], player.astype(">i4"), rank)
    want = _whole(fn, model, (packed[::-1], player, rank.astype(np.int32)),
                  device)
    assert np.array_equal(fn(model, *odd), want)
    assert pipelined == [4]


def test_card_pipelined_call_runs_one_lap_and_fails_a_middle_chunk():
    device = _card()
    cfg, model = _full(device)
    fn = serving.make_log_prob_fn(cfg, device=device)
    arrays = boards(8192, seed=12)
    want = _whole(fn, model, arrays, device)
    before = {(n, s): span_count(n, s) for n in SERVE
              for s in ("ok", "error")}
    fn(model, *arrays)
    net = serving._log_probs_net(cfg, device)
    calls = []

    def failing(params, staged):
        calls.append(len(staged[0][0]))
        if len(calls) == 2:
            raise RuntimeError("boom")
        return net(params, staged)

    with torch.inference_mode(), pytest.raises(RuntimeError, match="boom"):
        serving._serve_chunks(serving.serve_laps(), device, failing, model,
                              *arrays, serving._chunk_plan(8192, 2048))
    assert calls == [2048, 2048]
    assert {k: span_count(*k) - v for k, v in before.items()} == {
        ("serve.h2d", "ok"): 2, ("serve.h2d", "error"): 0,
        ("serve.net", "ok"): 1, ("serve.net", "error"): 1,
        ("serve.d2h", "ok"): 1, ("serve.d2h", "error"): 0}
    assert np.array_equal(fn(model, *arrays), want)


@pytest.mark.parametrize("rung", [1, 8, 32, 128, 512])
def test_card_engine_rungs_stay_on_todays_path(rung, pipelined):
    device = _card()
    cfg, model = _full(device)
    fn = serving.make_log_prob_fn(cfg, device=device)
    arrays = boards(rung, seed=rung)
    got = fn(model, *arrays)
    assert np.array_equal(got, _whole(fn, model, arrays, device))
    assert pipelined == []


def test_card_two_threads_get_their_own_rows():
    device = _card()
    cfg, model = _full(device)
    fn = serving.make_log_prob_fn(cfg, device=device)
    inputs = [boards(8192, seed=s) for s in (5, 6)]
    want = [_whole(fn, model, a, device) for a in inputs]
    got = [[], []]

    def call(i):
        for _ in range(4):
            got[i].append(fn(model, *inputs[i]))

    threads = [threading.Thread(target=call, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for i in (0, 1):
        assert len(got[i]) == 4
        assert all(np.array_equal(out, want[i]) for out in got[i])


def test_card_pipelined_call_never_synchronises_a_stream(pipelined):
    """Under ``DEEPGO_XLACHECK=1`` with the sync check armed (what a
    guard arms), a synchronising call raises: the pipelined call makes
    none, and its rows are the whole call's."""
    device = _card()
    cfg, model = _full(device)
    fn = serving.make_log_prob_fn(cfg, device=device)
    arrays = boards(8192, seed=8)
    want = _whole(fn, model, arrays, device)
    fn(model, *arrays)
    cudacheck.enable(True)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(model, *arrays)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        cudacheck.enable(None)
    assert np.array_equal(got, want)
    assert pipelined == [4, 4]


def test_card_copies_overlap_kernels_in_a_capture():
    device = _card()
    cfg, model = _full(device)
    fn = serving.make_log_prob_fn(cfg, device=device)
    arrays = boards(8192, seed=9)
    fn(model, *arrays)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(model, *arrays)
        torch.cuda.synchronize(device)
    copies = {"HtoD": [], "DtoH": []}
    kernels = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        name = e.name()
        if "Memcpy" in name:
            for way in copies:
                if way in name:
                    copies[way].append(span)
        elif "Memset" not in name:
            kernels.append(span)

    def overlapped(spans):
        return sum(1 for a, b in spans
                   if any(k0 < b and a < k1 for k0, k1 in kernels))

    print({way: (len(s), overlapped(s)) for way, s in copies.items()})
    assert kernels and all(copies.values())
    assert overlapped(copies["HtoD"]) >= 1
    assert overlapped(copies["DtoH"]) >= 1
