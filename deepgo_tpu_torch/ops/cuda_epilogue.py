"""ctypes wrappers of the convolution epilogue kernels (``csrc/epilogue.cu``).

``bias_relu_cuda`` is ``ops.epilogue.bias_relu`` on the card, one kernel;
``bias_relu_backward_cuda`` is autograd's backward of it, one kernel for dX
and the slabs' partial bias gradients and a small one that adds the slabs.
``BiasReLU`` ties the two into one autograd node, which saves the output y
(the backward's mask; the next convolution keeps y for its own weight
gradient, so saving it costs no memory). Each wrapper checks what it is
given and raises on anything its kernels do not take, allocates with
``torch.empty``, launches on the current stream of the tensors' device,
raises when the launch reports an error, and counts its calls
(``launches``, ``bwd_launches``): a run resets the counts with
``reset_launches()``, drives a path, and reads them to show which kernels
the path went through.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from .. import BOARD_SIZE, NUM_POINTS
from . import _build

THREADS = 256       # threads a block (csrc/epilogue.cu kThreads)
# the grid the partition aims at, in blocks per SM: on an H100 one or two
# left the large shapes at 48-80 % of the bytes bound, eight or sixteen
# were no faster than four (81-86 %)
BLOCKS_PER_SM = 4
VECTOR_BYTES = 16

launches = 0      # forward launches since import or the last reset
bwd_launches = 0  # backward launches (kernel and finishing pass)
_count_lock = threading.Lock()
_sm_counts: dict[int, int] = {}
_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}
_ARGTYPES = {
    # x, bias, y, batch, channels, elem_bytes, vector, rows, slabs, relu,
    # stream
    "deepgo_bias_relu_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    # dy, y, dx, partial, grad, batch, channels, elem_bytes, vector, rows,
    # slabs, stream
    "deepgo_bias_relu_backward": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def reset_launches() -> None:
    """Set both launch counts to 0."""
    global launches, bwd_launches
    with _count_lock:
        launches = 0
        bwd_launches = 0


@functools.lru_cache(maxsize=None)
def plan(batch: int, channels: int, elem_bytes: int, sms: int,
         aligned: bool = True) -> tuple[int, int, int]:
    """The kernels' partition of a (batch, channels, 19, 19) activation:
    (vector, rows, slabs). ``vector`` values a thread access (16 bytes of
    neighbouring channels where C allows it and the tensors are 16-byte
    aligned, else 1); the plane of 361 * C values is cut into tiles of
    THREADS vectors, and the batch into ``slabs`` slabs of ``rows`` rows
    (the last may be shorter), enough for about BLOCKS_PER_SM blocks on
    each of ``sms`` SMs where the batch has the rows. Fixed by the shapes
    and the card, so the bias gradient's order of summation is too."""
    vector = VECTOR_BYTES // elem_bytes
    if channels % vector or not aligned:
        vector = 1
    tiles = math.ceil(NUM_POINTS * channels / vector / THREADS)
    rows = math.ceil(batch / min(batch, math.ceil(BLOCKS_PER_SM * sms
                                                  / tiles)))
    return vector, rows, math.ceil(batch / rows)


def _kernel(name: str):
    return _build.function("epilogue", name, _ARGTYPES[name])


def _sms(device: torch.device) -> int:
    n = _sm_counts.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = n
    return n


def _check_activation(name: str, t: torch.Tensor) -> None:
    if t.dtype not in _ELEM_BYTES:
        raise ValueError(f"the epilogue kernels take bfloat16 or float32, "
                         f"not {t.dtype} ({name})")
    if (t.dim() != 4 or tuple(t.shape[2:]) != (BOARD_SIZE, BOARD_SIZE)
            or t.shape[0] < 1):
        raise ValueError(f"{name} must be (B >= 1, C, {BOARD_SIZE}, "
                         f"{BOARD_SIZE}), got {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be channels-last contiguous")


def _check_device(device: torch.device, *others: torch.Tensor) -> None:
    if device.type != "cuda" or any(t.device != device for t in others):
        raise ValueError(f"the tensors must lie on one CUDA device, got "
                         f"{[device, *(t.device for t in others)]}")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % VECTOR_BYTES == 0 for t in tensors)


def bias_relu_cuda(x: torch.Tensor, bias: torch.Tensor, relu: bool = True
                   ) -> torch.Tensor:
    """x (B, C, 19, 19) bfloat16 or float32, channels-last on a CUDA device;
    bias (C, 19, 19) float32, contiguous on the same device -> ``relu(x +
    bias)`` (``relu=False``: ``x + bias``), channels-last in x's dtype,
    bitwise ``ops.epilogue.bias_relu``."""
    _check_activation("x", x)
    b, c = x.shape[:2]
    if (bias.dtype != torch.float32
            or tuple(bias.shape) != (c, BOARD_SIZE, BOARD_SIZE)
            or not bias.is_contiguous()):
        raise ValueError(f"bias must be float32 ({c}, {BOARD_SIZE}, "
                         f"{BOARD_SIZE}) contiguous, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    _check_device(x.device, bias)
    y = torch.empty_like(x)
    elem = _ELEM_BYTES[x.dtype]
    vector, rows, slabs = plan(b, c, elem, _sms(x.device), _aligned(x, y))
    args = [x.data_ptr(), bias.data_ptr(), y.data_ptr(), b, c, elem, vector,
            rows, slabs, int(relu)]
    _build.launch(_kernel("deepgo_bias_relu_forward"), x.device, args,
                  f"batch {b}, {c} channels, {x.dtype}")
    global launches
    with _count_lock:
        launches += 1
    return y


def bias_relu_backward_cuda(dy: torch.Tensor, y: torch.Tensor | None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """dy: the gradient of ``bias_relu_cuda``'s output, y: that output (None
    for ``relu=False``), both (B, C, 19, 19) channels-last, one dtype, on
    one CUDA device -> (dX, the bias gradient (C, 19, 19) float32). dX is
    ``y <= 0 ? 0 : dy`` bitwise (dy itself without ReLU); the bias gradient
    is dX summed over the batch in float32, in a fixed order, rounded to the
    compute dtype and widened, as autograd of ``x + bias.to(x.dtype)[None]``
    gives it up to the order of the sum."""
    _check_activation("dy", dy)
    if y is not None:
        _check_activation("y", y)
        if y.shape != dy.shape or y.dtype != dy.dtype:
            raise ValueError(f"y {y.dtype} {tuple(y.shape)} does not match "
                             f"dy {dy.dtype} {tuple(dy.shape)}")
    others = () if y is None else (y,)
    _check_device(dy.device, *others)
    b, c = dy.shape[:2]
    elem = _ELEM_BYTES[dy.dtype]
    dx = dy if y is None else torch.empty_like(dy)
    vector, rows, slabs = plan(b, c, elem, _sms(dy.device),
                               _aligned(dy, dx, *others))
    partial = torch.empty((slabs, NUM_POINTS * c), dtype=torch.float32,
                          device=dy.device)
    grad = torch.empty((c, BOARD_SIZE, BOARD_SIZE), dtype=torch.float32,
                       device=dy.device)
    args = [dy.data_ptr(), None if y is None else y.data_ptr(),
            None if y is None else dx.data_ptr(), partial.data_ptr(),
            grad.data_ptr(), b, c, elem, vector, rows, slabs]
    _build.launch(_kernel("deepgo_bias_relu_backward"), dy.device, args,
                  f"batch {b}, {c} channels, {dy.dtype}")
    global bwd_launches
    with _count_lock:
        bwd_launches += 1
    return dx, grad


class BiasReLU(torch.autograd.Function):
    """``ops.epilogue.bias_relu`` as one autograd node over the kernels:
    gradients for x and the float32 bias."""

    @staticmethod
    def forward(ctx, x, bias, relu):
        y = bias_relu_cuda(x, bias, relu)
        ctx.relu = relu
        if relu:
            ctx.save_for_backward(y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        y = ctx.saved_tensors[0] if ctx.relu else None
        dy = dy.contiguous(memory_format=torch.channels_last)
        dx, grad = bias_relu_backward_cuda(dy, y)
        return dx, grad, None
