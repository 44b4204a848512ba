"""Batched policy and value inference (the serving path), in PyTorch.

The port of ``deepgo_tpu/models/serving.py``: forwards from packed records
to move log-probabilities and ranked moves, loadable straight from a
checkpoint, the unfused dihedral ensemble ``make_sym_policy_fn``, and the
value net's win-probability forward ``make_value_fn`` / ``load_value``.
Numpy in, numpy out, like the JAX forwards, so the serving engine
(``deepgo_tpu_torch.serving``) drives them unchanged.

One forward is: host arrays -> device -> expansion (the CUDA kernel on the
card, the plain version on the CPU) -> conv stack in ``cfg.compute_dtype``
-> float32 log-softmax -> host. The copy back to the host
(``cudacheck.stage_d2h``) is the forward's one synchronisation point. Each
forward carries its ``device``; inputs already staged there as tensors
pass straight through (the engine stages them under ``DEEPGO_XLACHECK=1``).

A bulk call on the card (host arrays of at least two chunks of
``SERVE_CHUNK_BOARDS`` boards) runs as a pipeline instead: its boards are
cut into near-equal chunks (``_chunk_plan``), each chunk's rows go to the
card through pinned memory on a side copy stream, the caller's stream
runs the unchanged net on each chunk as its rows land, and each chunk's
result comes back on a second copy stream into pinned memory, from which
the host moves it into the result while later chunks run. So the copies
of one chunk hide under the convolutions of another, and the host waits
on CUDA events only. Every forward here is row-independent, so the result
is the rows of the whole batch; pinned memory never leaves the call.

Every forward here and in ``models/quant.py`` runs through ``serve``, in
three back-to-back hot spans a call (``obs.spans.hot_laps``, a
``hot_span`` block each while a profiler capture runs): ``serve.h2d``
(the inputs onto the device; pipelined, the first chunk's staging and
copy), ``serve.net`` (expansion, network and log-softmax, as they are
enqueued; pipelined, the later chunks' staging and copies, every chunk's
net and copy back, and the moves of all chunks but the last) and
``serve.d2h`` (the host waiting for the device, then the copy back;
pipelined, the wait for the last chunk and its move).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import NUM_POINTS, resolve_device
from ..analysis.cudacheck import place, stage_d2h
from ..experiments import checkpoint as ckpt
from ..obs.spans import capturing, hot_laps, hot_span
from ..ops import expand_planes, expand_planes_sym
from ..ops.augment import _TARGET_MAP_NP, NUM_SYMMETRIES, table
from . import convert, policy_cnn, value_cnn


def _on(device: torch.device, value, dtype) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.ascontiguousarray(value, dtype=dtype)).to(
        device)


def inputs_on(device: torch.device, packed, player, rank
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host arrays (packed (B, 9, 19, 19) uint8, player / rank (B,) int32),
    or tensors staged on ``device`` already, -> tensors on ``device``."""
    return (_on(device, packed, np.uint8), _on(device, player, np.int32),
            _on(device, rank, np.int32))


def serve_laps() -> hot_laps:
    """``serve``'s spans, made once per forward."""
    return hot_laps("serve.h2d", "serve.net", "serve.d2h")


def serve(laps: hot_laps, device: torch.device, net, params, packed, player,
          rank):
    """One serving call: ``net(params, staged)`` on the inputs put on
    ``device``, its result (a tensor, or a dict of them) back on the host
    as numpy, in the spans ``serve.h2d``, ``serve.net`` and ``serve.d2h``.
    ``staged`` is a list holding the (packed, player, rank) tensors, which
    the net pops: they are freed once expanded, before the network runs.
    A bulk call on the card runs as a pipeline of chunks
    (``_pipeline_plan``)."""
    plan = _pipeline_plan(device, packed, player, rank)
    if plan:
        return _serve_chunks(laps, device, net, params, packed, player,
                             rank, plan)
    return _in_laps(laps, lambda: [inputs_on(device, packed, player, rank)],
                    lambda staged: net(params, staged), _to_host)


def _in_laps(laps: hot_laps, h2d, run, d2h):
    """``d2h(run(h2d()))``, the three parts timed as ``serve.h2d``,
    ``serve.net`` and ``serve.d2h``: laps from the caller's stamps, or a
    ``hot_span`` block each while a profiler capture runs. A part that
    raises is recorded as failed, and the exception propagates."""
    if capturing():
        with hot_span("serve.h2d"):
            x = h2d()
        with hot_span("serve.net"):
            x = run(x)
        with hot_span("serve.d2h"):
            return d2h(x)
    stamps = [time.perf_counter()]
    try:
        x = h2d()
        stamps.append(time.perf_counter())
        x = run(x)
        stamps.append(time.perf_counter())
        x = d2h(x)
    except BaseException:
        stamps.append(time.perf_counter())
        laps.failed(stamps)
        raise
    stamps.append(time.perf_counter())
    laps.observe(stamps)
    return x


def _to_host(out):
    if isinstance(out, dict):
        return {k: stage_d2h(v) for k, v in out.items()}
    return stage_d2h(out)


def check_model(params, cfg) -> None:
    if params.cfg != cfg:
        raise ValueError(f"model config {params.cfg} != forward config "
                         f"{cfg}")


# On the card cuDNN picks its convolution algorithm by the batch size, and
# below some size it picks another that rounds a bf16 row differently: on
# an NVIDIA H100 (torch 2.11, CUDA 12.8) at 4-32 rows for ``small`` and
# 1-16 for ``full``, by up to 1e-3 and 6e-3 in a log-probability. From 64
# rows up a row's result depends on that row alone, as XLA's does on every
# rung. So a card forward runs its convolutions over at least this many
# rows (zero planes below the real ones): a board gets the same answer on
# every rung of the ladder, which a position cache and the chaos
# campaigns' answer check hold it to.
CARD_MIN_ROWS = 64


def conv_rows(batch: int, device) -> int:
    """The rows a serving forward of ``batch`` boards convolves on
    ``device``."""
    if torch.device(device).type == "cuda":
        return max(batch, CARD_MIN_ROWS)
    return batch


# A bulk call on the card runs as a pipeline of chunks of about this many
# boards. On an NVIDIA H100 (700 W, torch 2.11, CUDA 12.8), ``full`` at B =
# 8,192, back to back: 1,024-board chunks give 290k boards/s (the host's
# enqueue of eight nets paces the call), 2,048 give 313k, 4,096 give
# 294-302k (half the batch's staging and copy back exposed at each end of
# the call), the call served whole 255-274k. Below two chunks a call is
# served whole, pageable: there one chunk through pinned memory and the side
# streams took 1.25x the whole call's time at 1 and 8 boards, 1.43x at 128,
# 1.10x at 512 and 0.96x at 3,000 (medians of seven rounds, same card).
SERVE_CHUNK_BOARDS = 2048


def _chunk_plan(batch: int, chunk_boards: int) -> list[slice]:
    """The chunks of a pipelined call of ``batch`` boards: ceil(batch /
    chunk) slices of near-equal size (they differ by a board at most), or
    none where the batch holds fewer than two chunks. A chunk is at least
    2 * ``CARD_MIN_ROWS`` boards, so that no slice falls under
    ``CARD_MIN_ROWS``."""
    chunk = max(chunk_boards, 2 * CARD_MIN_ROWS)
    if batch < 2 * chunk:
        return []
    n = -(-batch // chunk)
    bounds = [i * batch // n for i in range(n + 1)]
    return [slice(a, b) for a, b in zip(bounds, bounds[1:])]


def _pipeline_plan(device: torch.device, packed, player, rank
                   ) -> list[slice]:
    """The chunks ``serve`` pipelines a call into: none (the call is
    served whole) off the card, for inputs already staged as tensors, and
    for a batch of fewer than two chunks."""
    if device.type != "cuda" or any(isinstance(a, torch.Tensor)
                                    for a in (packed, player, rank)):
        return []
    return _chunk_plan(len(packed), SERVE_CHUNK_BOARDS)


def _serve_chunks(laps: hot_laps, device: torch.device, net, params,
                  packed, player, rank, plan: list[slice]):
    """``serve`` of the host arrays cut into the chunks of ``plan``
    (slices covering the batch in order), pipelined on the card: the same
    result, the same three spans."""
    call = _Pipeline(device, net, params, (packed, player, rank), plan)
    return _in_laps(laps, call.first, call.run, call.finish)


# the dtypes of packed, player and rank on the card
_INPUT_DTYPES = (torch.uint8, torch.int32, torch.int32)


class _Pipeline:
    """One pipelined serving call on the card.

    Chunk k's input rows are copied into pinned memory and sent to the
    card on a copy-in stream; the caller's stream waits for them (an
    event) and runs the net; the copy-out stream waits for the
    net (an event) and copies chunk k's result into pinned memory; the
    host waits for that copy (an event) and moves the rows into the
    result (``_stitch``). The host enqueues chunk k's net, its copy back
    and chunk k + 1's copy in before it waits for chunk k - 1, so the card
    always has a chunk to run while the host stages and moves. Device
    tensors used on a stream other than the one that made them are
    recorded on it (``record_stream``)."""

    def __init__(self, device, net, params, arrays, plan):
        self.device, self.net, self.params, self.plan = (device, net, params,
                                                         plan)
        self.arrays = [np.asarray(a) for a in arrays]
        # side streams from torch's pool, one for each way
        self.copy_in = torch.cuda.Stream(device)
        self.copy_out = torch.cuda.Stream(device)
        self.compute = torch.cuda.current_stream(device)
        self.landing = []  # chunk k's ({key: pinned tensor}, landed event)
        self.result = {}

    def first(self) -> tuple[tuple, torch.cuda.Event]:
        return self._stage(self.plan[0])

    def run(self, staged: tuple[tuple, torch.cuda.Event]) -> None:
        for k in range(len(self.plan)):
            self.landing.append(self._copy_back(self._net(*staged)))
            if k + 1 < len(self.plan):
                staged = self._stage(self.plan[k + 1])
            if k:
                self._move(k - 1)

    def finish(self, _):
        self._move(len(self.plan) - 1)
        return self.result.get(None, self.result)

    def _stage(self, rows: slice) -> tuple[tuple, torch.cuda.Event]:
        host = []
        for a, dtype in zip(self.arrays, _INPUT_DTYPES):
            part = a[rows]
            pinned = torch.empty(part.shape, dtype=dtype, pin_memory=True)
            _host_copy(pinned, part)
            host.append(pinned)
        with torch.cuda.stream(self.copy_in):
            staged = tuple(t.to(self.device, non_blocking=True)
                           for t in host)
            ready = torch.cuda.Event()
            ready.record(self.copy_in)
        return staged, ready

    def _net(self, staged: tuple, ready: torch.cuda.Event):
        self.compute.wait_event(ready)
        for t in staged:
            t.record_stream(self.compute)
        return self.net(self.params, [staged])

    def _copy_back(self, out) -> tuple[dict, torch.cuda.Event]:
        done = torch.cuda.Event()
        done.record(self.compute)
        host = {}
        with torch.cuda.stream(self.copy_out):
            self.copy_out.wait_event(done)
            for key, t in _leaves(out).items():
                t.record_stream(self.copy_out)
                host[key] = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
                host[key].copy_(t, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(self.copy_out)
        return host, landed

    def _move(self, k: int) -> None:
        host, landed = self.landing[k]
        self.landing[k] = None
        landed.synchronize()
        _stitch(self.result, {key: stage_d2h(t) for key, t in host.items()},
                self.plan[k], self.plan[-1].stop)


def _leaves(out) -> dict:
    """A net's result as {key: tensor}: a dict as it is, a tensor under
    ``None``."""
    return out if isinstance(out, dict) else {None: out}


def _stitch(result: dict, rows: dict, where: slice, batch: int) -> None:
    """One chunk's rows ({key: array}) into ``result``'s arrays of
    ``batch`` rows at ``where``; each array is made, owning its memory, by
    the first chunk that reaches it."""
    for key, part in rows.items():
        if key not in result:
            result[key] = np.empty((batch, *part.shape[1:]), part.dtype)
        _host_copy(torch.from_numpy(result[key][where]), part)


def _host_copy(dst: torch.Tensor, src: np.ndarray) -> None:
    """``dst[...] = src`` on the host, cast as ``np.ascontiguousarray``
    casts: in torch's intra-op threads (numpy copies in one) where torch
    can wrap ``src`` as it is (dst's dtype, writeable, no negative stride),
    else through numpy."""
    if (src.dtype == dst.numpy().dtype and src.flags.writeable
            and min(src.strides, default=0) >= 0):
        dst.copy_(torch.from_numpy(src))
    else:
        np.copyto(dst.numpy(), src, casting="unsafe")


def log_policy_rows(params: policy_cnn.PolicyCNN, planes: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """``policy_cnn.log_policy`` of ``planes``, the convolutions run over
    ``rows`` >= ``len(planes)`` rows (zero planes below the real ones)."""
    b = planes.shape[0]
    if rows <= b:
        return policy_cnn.log_policy(params, planes)
    pad = planes.new_zeros((rows - b, *planes.shape[1:]))
    return policy_cnn.log_policy(params, torch.cat([planes, pad]))[:b]


def _log_probs_net(cfg, device):
    """The log-prob forward on inputs staged on ``device`` (``serve``'s
    net)."""
    def log_probs(params: policy_cnn.PolicyCNN, staged: list
                  ) -> torch.Tensor:
        planes = expand_planes(*staged.pop(), dtype=cfg.torch_dtype)
        return log_policy_rows(params, planes,
                               conv_rows(planes.shape[0], device))

    return log_probs


def make_log_prob_fn(cfg: policy_cnn.ModelConfig, device="cuda"):
    """predict(params, packed, player, rank) -> (B, 361) float32 log-probs.

    ``params`` is a ``PolicyCNN`` of ``cfg`` on ``device``; ``packed`` is
    (B, 9, 19, 19) uint8 and ``player`` / ``rank`` (B,) int32 numpy arrays.
    This is the raw row-independent forward the serving engine batches:
    it must never grow a cross-batch term."""
    device = resolve_device(device)
    laps = serve_laps()
    net = _log_probs_net(cfg, device)

    @torch.inference_mode()
    def log_probs(params, packed, player, rank) -> np.ndarray:
        check_model(params, cfg)
        return serve(laps, device, net, params, packed, player, rank)

    log_probs.device = device
    return log_probs


def make_policy_fn(cfg: policy_cnn.ModelConfig, top_k: int = 5,
                   device="cuda"):
    """predict(params, packed, player, rank) ->
    {"log_probs": (B, 361), "top_moves": (B, k), "top_probs": (B, k)}.

    Moves are flat 0-based indices (19*x + y), matching the training
    target; ``top_probs`` are descending."""
    device = resolve_device(device)
    laps = serve_laps()
    log_probs = _log_probs_net(cfg, device)

    def net(params, staged: list) -> dict:
        logp = log_probs(params, staged)
        top_probs, top_moves = torch.topk(logp.exp(), top_k, dim=-1)
        return {"log_probs": logp, "top_moves": top_moves.to(torch.int32),
                "top_probs": top_probs}

    @torch.inference_mode()
    def predict(params, packed, player, rank) -> dict:
        check_model(params, cfg)
        return serve(laps, device, net, params, packed, player, rank)

    predict.device = device
    return predict


def make_sym_policy_fn(cfg: policy_cnn.ModelConfig, device="cuda"):
    """predict(params, packed, player, rank) -> (B, 361) log-probs averaged
    over the 8 dihedral board symmetries.

    Each view is transformed with the permutation table, pushed through one
    8B-board forward, softmaxed, mapped back to original coordinates with
    the inverse table, and the PROBABILITIES are averaged (a proper
    mixture). The averaged predictor is exactly equivariant by
    construction. The serving path runs the fused form instead
    (``models/quant.make_fused_sym_policy_fn``), which averages in log
    space; this is the reference it is tested against."""
    device = resolve_device(device)
    laps = serve_laps()
    tmap = table(_TARGET_MAP_NP, device)  # (8, 361) inverse tables

    def net(params, staged: list) -> torch.Tensor:
        planes = expand_planes_sym(*staged.pop(), symmetries=NUM_SYMMETRIES,
                                   dtype=cfg.torch_dtype)
        b = planes.shape[0] // NUM_SYMMETRIES
        probs = F.softmax(params(planes).float(), dim=-1)
        probs = probs.reshape(NUM_SYMMETRIES, b, NUM_POINTS)
        # map view k's distribution back: orig point p sits at tmap[k, p]
        back = torch.gather(probs, 2, tmap[:, None, :].expand_as(probs))
        return torch.log(back.mean(dim=0) + 1e-30)

    @torch.inference_mode()
    def predict(params, packed, player, rank) -> np.ndarray:
        check_model(params, cfg)
        return serve(laps, device, net, params, packed, player, rank)

    predict.device = device
    return predict


def make_value_fn(cfg: value_cnn.ValueConfig, device="cuda"):
    """win_prob(params, packed, player, rank) -> (B,) float32 P(side to
    move wins), the value-net twin of ``make_log_prob_fn``: the expansion
    (the CUDA kernel on the card, the plain version on the CPU), the
    ``ValueCNN`` of ``cfg`` on ``device``, a float32 sigmoid. Row-
    independent, so the serving engine batches it unchanged."""
    device = resolve_device(device)
    laps = serve_laps()

    def net(params, staged: list) -> torch.Tensor:
        planes = expand_planes(*staged.pop(), dtype=cfg.torch_dtype)
        return torch.sigmoid(params(planes))

    @torch.inference_mode()
    def win_prob(params: value_cnn.ValueCNN, packed, player, rank
                 ) -> np.ndarray:
        check_model(params, cfg)
        return serve(laps, device, net, params, packed, player, rank)

    win_prob.device = device
    return win_prob


def load_value(checkpoint_path: str, device="cuda"):
    """(win_prob_fn, model, value_cfg) from a value checkpoint
    (``kind="value"``, as the JAX package's ``tools/train_value.py`` writes
    it), with the model on ``device``. Raises ``CheckpointError`` for a
    corrupt file, another kind of checkpoint, or weights that do not fit
    the config."""
    device = resolve_device(device)
    meta, p_leaves, _ = ckpt.load_checkpoint(checkpoint_path)
    if meta.get("kind") != "value":
        raise ckpt.CheckpointError(
            checkpoint_path, f"not a value checkpoint: kind "
                             f"{meta.get('kind')!r}")
    try:
        cfg = value_cnn.ValueConfig(**meta["config"])
    except (KeyError, TypeError, ValueError) as e:
        raise ckpt.CheckpointError(
            checkpoint_path, f"config does not build a value net: {e}"
        ) from e
    model = value_cnn.ValueCNN(cfg)
    model.load_state_dict(convert.value_from_jax(ckpt.unflatten_like(
        convert.value_to_jax(model), p_leaves, checkpoint_path)))
    return make_value_fn(cfg, device=device), model.to(device), cfg


def load_policy(checkpoint_path: str, top_k: int = 5, device="cuda"):
    """(predict_fn, model, model_cfg) from a training checkpoint written by
    the JAX package, with the model on ``device``. Raises
    ``CheckpointError`` for a corrupt file or one whose weights do not fit
    its config."""
    device = resolve_device(device)
    meta, p_leaves, _ = ckpt.load_checkpoint(checkpoint_path)
    cfg = ckpt.model_config_from_meta(meta, checkpoint_path)
    model = policy_cnn.PolicyCNN(cfg)
    model.load_state_dict(ckpt.policy_state_dict(p_leaves, cfg,
                                                 checkpoint_path))
    return make_policy_fn(cfg, top_k=top_k, device=device), \
        place(model, device), cfg
