"""ctypes wrapper of the hand-written Hopper expansion kernel (``csrc/expand.cu``).

Replaces ``deepgo_tpu/ops/pallas_expand.py::_expand_kernel`` on the card.
The wrapper checks what it is given and raises on anything the kernel does
not take, allocates the NHWC output with ``torch.empty``, launches on the
current stream of the tensors' device, raises when the launch reports an
error, and counts its launches in ``launches``: a run resets the count,
drives a path, and reads it to show the path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import BOARD_SIZE
from ..features import NUM_PLANES, PACKED_CHANNELS
from . import _build

launches = 0  # kernel launches since import or the last reset_launches()
_count_lock = threading.Lock()
_launcher = None
_OUT_BYTES = {torch.bfloat16: 2, torch.float32: 4}


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _kernel():
    global _launcher
    if _launcher is None:
        fn = _build.load("expand").deepgo_expand_planes
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def expand_planes_cuda(packed: torch.Tensor, player: torch.Tensor,
                       rank: torch.Tensor, dtype=torch.bfloat16
                       ) -> torch.Tensor:
    """packed (B, 9, 19, 19) uint8, player / rank (B,) int32, all contiguous
    on one CUDA device -> (B, 19, 19, 37) planes in ``dtype`` (bfloat16 or
    float32), equal to ``ops.expand.expand_planes``."""
    if dtype not in _OUT_BYTES:
        raise ValueError(f"expand kernel writes bfloat16 or float32, "
                         f"not {dtype}")
    board = (PACKED_CHANNELS, BOARD_SIZE, BOARD_SIZE)
    if packed.dim() != 4 or tuple(packed.shape[1:]) != board:
        raise ValueError(f"packed must be (B, {PACKED_CHANNELS}, "
                         f"{BOARD_SIZE}, {BOARD_SIZE}), got "
                         f"{tuple(packed.shape)}")
    b = packed.shape[0]
    if b < 1:
        raise ValueError("expand kernel needs at least one board")
    if packed.dtype != torch.uint8:
        raise ValueError(f"packed must be uint8, got {packed.dtype}")
    for name, t in (("player", player), ("rank", rank)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be int32 of shape ({b},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("packed", packed), ("player", player), ("rank", rank)):
        if t.device.type != "cuda" or t.device != packed.device:
            raise ValueError(f"{name} must lie on packed's CUDA device, "
                             f"got {t.device} (packed on {packed.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((b, BOARD_SIZE, BOARD_SIZE, NUM_PLANES), dtype=dtype,
                      device=packed.device)
    launch = _kernel()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = launch(packed.data_ptr(), player.data_ptr(), rank.data_ptr(),
                     out.data_ptr(), b, _OUT_BYTES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"expand kernel launch failed with cudaError {err} "
                           f"(batch {b}, {dtype})")
    global launches
    with _count_lock:
        launches += 1
    return out
