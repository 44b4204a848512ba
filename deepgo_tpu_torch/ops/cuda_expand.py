"""ctypes wrappers of the hand-written Hopper expansion kernels (``csrc/expand.cu``).

``expand_planes_cuda`` replaces ``deepgo_tpu/ops/pallas_expand.py::_expand_kernel``
on the card, ``expand_planes_sym_cuda`` replaces ``_sym_expand_kernel`` (the
expansion fused with the dihedral-view gather). Each wrapper checks what it
is given and raises on anything its kernel does not take, allocates the
NHWC output with ``torch.empty``, launches on the current stream of the
tensors' device, raises when the launch reports an error, and counts its
launches (``launches``, ``sym_launches``): a run resets the counts with
``reset_launches()``, drives a path, and reads them to show which kernel
the path went through.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import BOARD_SIZE
from ..features import NUM_PLANES, PACKED_CHANNELS
from . import _build
from .augment import _PERM_NP, NUM_SYMMETRIES, table

launches = 0      # expand kernel launches since import or the last reset
sym_launches = 0  # sym kernel launches since import or the last reset
_count_lock = threading.Lock()
_perm_tables: dict[torch.device, torch.Tensor] = {}
_OUT_BYTES = {torch.bfloat16: 2, torch.float32: 4}
_ARGTYPES = {
    # packed, player, rank, out, batch, out_bytes, stream
    "deepgo_expand_planes": [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    # packed, player, rank, perm, out, batch, symmetries, out_bytes, stream
    "deepgo_expand_planes_sym": [ctypes.c_void_p] * 5
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def reset_launches() -> None:
    """Set both launch counts to 0."""
    global launches, sym_launches
    with _count_lock:
        launches = 0
        sym_launches = 0


def _kernel(name: str = "deepgo_expand_planes"):
    return _build.function("expand", name, _ARGTYPES[name])


def _check_inputs(packed: torch.Tensor, player: torch.Tensor,
                  rank: torch.Tensor, dtype) -> int:
    """Raise on what the kernels do not take; return the batch size."""
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
    return b


def expand_planes_cuda(packed: torch.Tensor, player: torch.Tensor,
                       rank: torch.Tensor, dtype=torch.bfloat16
                       ) -> torch.Tensor:
    """packed (B, 9, 19, 19) uint8, player / rank (B,) int32, all contiguous
    on one CUDA device -> (B, 19, 19, 37) planes in ``dtype`` (bfloat16 or
    float32), equal to ``ops.expand.expand_planes``."""
    b = _check_inputs(packed, player, rank, dtype)
    out = torch.empty((b, BOARD_SIZE, BOARD_SIZE, NUM_PLANES), dtype=dtype,
                      device=packed.device)
    args = [packed.data_ptr(), player.data_ptr(), rank.data_ptr(),
            out.data_ptr(), b, _OUT_BYTES[dtype]]
    _build.launch(_kernel("deepgo_expand_planes"), packed.device, args,
                  f"batch {b}, {dtype}")
    global launches
    with _count_lock:
        launches += 1
    return out


def _perm_table(device: torch.device) -> torch.Tensor:
    """The (8, 361) int32 gather table on ``device``, uploaded once."""
    perm = _perm_tables.get(device)
    if perm is None:
        perm = table(_PERM_NP, device).to(torch.int32)
        _perm_tables[device] = perm
    return perm


def expand_planes_sym_cuda(packed: torch.Tensor, player: torch.Tensor,
                           rank: torch.Tensor,
                           symmetries: int = NUM_SYMMETRIES,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """packed (B, 9, 19, 19) uint8, player / rank (B,) int32, all contiguous
    on one CUDA device -> (S*B, 19, 19, 37) planes in ``dtype`` of the first
    ``symmetries`` = S dihedral views, view k of board i at row ``k*B + i``;
    equal to ``ops.expand.expand_planes_sym``."""
    b = _check_inputs(packed, player, rank, dtype)
    if (not isinstance(symmetries, int)
            or not 1 <= symmetries <= NUM_SYMMETRIES):
        raise ValueError(f"symmetries must be an int in [1, "
                         f"{NUM_SYMMETRIES}], got {symmetries!r}")
    out = torch.empty((symmetries * b, BOARD_SIZE, BOARD_SIZE, NUM_PLANES),
                      dtype=dtype, device=packed.device)
    perm = _perm_table(packed.device)
    args = [packed.data_ptr(), player.data_ptr(), rank.data_ptr(),
            perm.data_ptr(), out.data_ptr(), b, symmetries, _OUT_BYTES[dtype]]
    _build.launch(_kernel("deepgo_expand_planes_sym"), packed.device, args,
                  f"batch {b}, {symmetries} views, {dtype}")
    global sym_launches
    with _count_lock:
        sym_launches += 1
    return out
