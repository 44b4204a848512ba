"""ctypes wrappers of the residual network's BN epilogue kernels
(``csrc/bn_epilogue.cu``).

``bn_relu_cuda`` is ``ops.bn_epilogue.bn_relu`` on the card: in train mode
three kernels (the batch's statistics by slabs, a finishing step that
merges them and moves the running statistics in place, the apply pass), in
eval mode the apply pass alone on the running statistics.
``bn_relu_backward_cuda`` is autograd's backward of the train mode, three
kernels (a reduce by slabs, its finishing step, the apply pass). ``BNReLU``
ties the two into one autograd node, which saves x, the batch's mean and
invstd and, where a skip was added, the output y (the ReLU mask; y is the
next block's input, held anyway); without a skip the backward recomputes
the mask from x. Each wrapper checks what it is given and raises on
anything its kernels do not take, allocates with ``torch.empty``, launches
on the current stream of the tensors' device, raises when the launch
reports an error, and counts its calls (``launches``, ``bwd_launches``): a
run resets the counts with ``reset_launches()``, drives a path, and reads
them to show which kernels the path went through.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from .. import NUM_POINTS
from . import _build
from ._build import (ELEM_BYTES, check_activation, check_device,
                     is_aligned, sm_count, vector_width)

THREADS = 256       # threads a block (csrc/bn_epilogue.cu kThreads)
# rows a block of an elementwise pass walks: many short blocks, so the last
# wave is small whatever the kernel's registers allow a SM
APPLY_ROWS = 16
# a channel's count of values, B * 361, is kept in float32: exact below 2^24
MAX_BATCH = ((1 << 24) - 1) // NUM_POINTS

launches = 0      # forward calls since import or the last reset
bwd_launches = 0  # backward calls
_count_lock = threading.Lock()
_resident: dict[tuple, tuple[int, int, int]] = {}
_ARGTYPES = {
    # x, skip, y, weight, bias, running_mean, running_var, saved, partial;
    # batch, channels, elem_bytes, vector, reduce_rows, reduce_slabs, rows,
    # slabs, train; eps, momentum, bessel; stream
    "deepgo_bn_relu_forward": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
    + [ctypes.c_float] * 3 + [ctypes.c_void_p],
    # dy, x, y, dy_eff, dx, weight, bias, saved, partial, sums, grad_weight,
    # grad_bias; batch, channels, elem_bytes, vector, reduce_rows,
    # reduce_slabs, rows, slabs; norm; stream
    "deepgo_bn_relu_backward": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p],
    # elem_bytes, vector, out (3 ints)
    "deepgo_bn_blocks_per_sm": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def reset_launches() -> None:
    """Set both launch counts to 0."""
    global launches, bwd_launches
    with _count_lock:
        launches = 0
        bwd_launches = 0


@functools.lru_cache(maxsize=None)
def plan(batch: int, channels: int, elem_bytes: int, sms: int,
         aligned: bool = True, blocks_per_sm: int | None = None
         ) -> tuple[int, int, int, int]:
    """A pass's partition of a (batch, channels, 19, 19) activation:
    (vector, points, rows, slabs). ``vector`` values a thread access (16
    bytes of neighbouring channels where C allows it and the tensors are
    16-byte aligned, else 1); a block covers ``points`` whole board points
    (C / vector threads each), and the batch is cut into ``slabs`` slabs of
    ``rows`` rows (the last may be shorter). An elementwise pass (no
    ``blocks_per_sm``) takes APPLY_ROWS rows a slab; a reducing pass takes
    one wave of the ``blocks_per_sm`` blocks each of ``sms`` SMs holds at
    once (as many slabs as fit, at least one), so none waits for a second
    wave, and its kernels interleave the slabs' rows (slab s holds rows s,
    s + slabs, ...). Fixed by the shapes and the card, so the order of
    every sum is too."""
    vector = vector_width(channels, elem_bytes, aligned)
    if channels // vector > THREADS:
        raise ValueError(f"the BN epilogue kernels take at most "
                         f"{THREADS * vector} channels here, got {channels}")
    points = THREADS // (channels // vector)
    if blocks_per_sm is None:
        rows = min(batch, APPLY_ROWS)
    else:
        tiles = math.ceil(NUM_POINTS / points)
        rows = math.ceil(batch / max(1, min(batch, blocks_per_sm * sms
                                            // tiles)))
    return vector, points, rows, math.ceil(batch / rows)


def _kernel(name: str):
    return _build.function("bn_epilogue", name, _ARGTYPES[name])


def _resident_blocks(device: torch.device, elem_bytes: int, vector: int
                     ) -> tuple[int, int, int]:
    """Blocks a SM holds at once of the statistics pass and of the
    backward's reduce without and with a skip (their registers set it)."""
    key = (device.index, elem_bytes, vector)
    got = _resident.get(key)
    if got is None:
        out = (ctypes.c_int * 3)()
        fn = _kernel("deepgo_bn_blocks_per_sm")
        with torch.cuda.device(device):
            err = fn(elem_bytes, vector, out)
        if err != 0:
            raise RuntimeError(f"deepgo_bn_blocks_per_sm failed with "
                               f"cudaError {err}")
        got = _resident[key] = tuple(out)
    return got


def _passes(b: int, c: int, elem: int, device: torch.device, aligned: bool,
            reducing: int) -> tuple[int, int, list[int]]:
    """(vector, parts, [reduce_rows, reduce_slabs, rows, slabs]): the
    partitions of reducing pass ``reducing`` (an index of
    ``_resident_blocks``) and of the elementwise pass after it, and the
    reducing pass's count of partials."""
    sms = sm_count(device)
    vector, points, rows, slabs = plan(b, c, elem, sms, aligned)
    resident = _resident_blocks(device, elem, vector)[reducing]
    _, _, r_rows, r_slabs = plan(b, c, elem, sms, aligned, resident)
    parts = math.ceil(NUM_POINTS / points) * r_slabs
    return vector, parts, [r_rows, r_slabs, rows, slabs]


def _check_like(name: str, t: torch.Tensor, x: torch.Tensor) -> None:
    check_activation(name, t, "BN epilogue", MAX_BATCH)
    if t.shape != x.shape or t.dtype != x.dtype:
        raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} does not match "
                         f"x {x.dtype} {tuple(x.shape)}")


def _check_channels(name: str, t: torch.Tensor, shape: tuple) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be float32 {shape} contiguous, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def bn_relu_cuda(x: torch.Tensor, bn, skip: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x (B, C, 19, 19) bfloat16 or float32, channels-last on a CUDA device;
    ``bn`` a ``models.resnet.BatchNorm`` whose scale, shift and running
    statistics are float32 (C,) on the same device; ``skip`` None or as x
    -> (y, saved). y = ``relu(batch_norm(x) + skip)``, channels-last in x's
    dtype. In train mode the batch's statistics: saved = (mean, invstd)
    (2, C) float32, and the running statistics moved in place; in eval mode
    the running statistics, saved None."""
    check_activation("x", x, "BN epilogue", MAX_BATCH)
    b, c = x.shape[:2]
    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    for name, t in zip(("weight", "bias", "running_mean", "running_var"),
                       params):
        _check_channels(name, t, (c,))
    others = params
    if skip is not None:
        _check_like("skip", skip, x)
        others = (*params, skip)
    check_device(x.device, *others)
    y = torch.empty_like(x)
    elem = ELEM_BYTES[x.dtype]
    vector, parts, partition = _passes(
        b, c, elem, x.device,
        is_aligned(x, y, *(() if skip is None else (skip,))), 0)
    saved = partial = None
    if bn.training:
        saved = torch.empty((2, c), dtype=torch.float32, device=x.device)
        partial = torch.empty(parts * (2 * c + 1), dtype=torch.float32,
                              device=x.device)
    n = b * NUM_POINTS
    args = [x.data_ptr(), _ptr(skip), y.data_ptr(), *map(_ptr, params),
            _ptr(saved), _ptr(partial), b, c, elem, vector, *partition,
            int(bn.training), bn.eps, bn.momentum, n / (n - 1)]
    _build.launch(_kernel("deepgo_bn_relu_forward"), x.device, args,
                  f"batch {b}, {c} channels, {x.dtype}")
    global launches
    with _count_lock:
        launches += 1
    return y, saved


def bn_relu_backward_cuda(dy: torch.Tensor, x: torch.Tensor,
                          saved: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, y: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor | None]:
    """Autograd's backward of ``bn_relu_cuda`` in train mode. dy: the
    gradient of its output; x its input; saved its (mean, invstd); weight
    and bias BN's scale and shift; y its output where it added a skip (the
    mask is then y's), None where it did not (the mask is recomputed from
    x). dy, x and y (B, C, 19, 19) channels-last, one dtype, on one CUDA
    device -> (dX, the scale's gradient, the shift's gradient (C,) float32,
    the skip's gradient: dY masked by ReLU, or None without a skip)."""
    check_activation("dy", dy, "BN epilogue", MAX_BATCH)
    _check_like("x", x, dy)
    b, c = dy.shape[:2]
    _check_channels("saved", saved, (2, c))
    _check_channels("weight", weight, (c,))
    _check_channels("bias", bias, (c,))
    others = (x, saved, weight, bias)
    if y is not None:
        _check_like("y", y, dy)
        others = (*others, y)
    check_device(dy.device, *others)
    dx = torch.empty_like(dy)
    dy_eff = None if y is None else torch.empty_like(dy)
    elem = ELEM_BYTES[dy.dtype]
    vector, parts, partition = _passes(
        b, c, elem, dy.device,
        is_aligned(dy, x, dx, *(() if y is None else (y, dy_eff))),
        1 if y is None else 2)
    scratch = torch.empty((parts + 1) * 2 * c, dtype=torch.float32,
                          device=dy.device)
    sums, partial = scratch[:2 * c], scratch[2 * c:]
    grads = torch.empty((2, c), dtype=torch.float32, device=dy.device)
    args = [dy.data_ptr(), x.data_ptr(), _ptr(y), _ptr(dy_eff),
            dx.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            saved.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            grads[0].data_ptr(), grads[1].data_ptr(), b, c, elem, vector,
            *partition, 1.0 / (b * NUM_POINTS)]
    _build.launch(_kernel("deepgo_bn_relu_backward"), dy.device, args,
                  f"batch {b}, {c} channels, {dy.dtype}")
    global bwd_launches
    with _count_lock:
        bwd_launches += 1
    return dx, grads[0], grads[1], dy_eff


class BNReLU(torch.autograd.Function):
    """``ops.bn_epilogue.bn_relu`` in train mode as one autograd node over
    the kernels: gradients for x, BN's float32 scale and shift, and the
    skip."""

    @staticmethod
    def forward(ctx, x, weight, bias, skip, bn):
        y, saved = bn_relu_cuda(x, bn, skip)
        ctx.save_for_backward(x, saved, weight, bias,
                              None if skip is None else y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, saved, weight, bias, y = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        dx, grad_weight, grad_bias, dskip = bn_relu_backward_cuda(
            dy, x, saved, weight, bias, y)
        return dx, grad_weight, grad_bias, dskip, None
