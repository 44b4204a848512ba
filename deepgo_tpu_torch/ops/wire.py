"""Nibble wire format: half the host-to-device bytes for packed records.

The port of ``deepgo_tpu/ops/wire.py``. Every packed channel value is only
ever compared against small constants by the expansion (the largest
threshold is kills >= 7), so clamping values to 15 keeps every expanded
plane, and two 4-bit cells fit one byte.

Layout: the (9, 19, 19) record flattens to 3,249 cells, pads one zero cell,
and adjacent cells pack pairwise into 1,625 bytes (low nibble = even cell,
high nibble = odd cell). ``nibble_pack_np`` runs on the host in the loader
(numpy, bitwise equal to the JAX package's); ``nibble_unpack`` is the first
op of every train and eval step on the device, plain PyTorch, followed by
the expansion kernel. The on-disk shard format is unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import BOARD_SIZE
from ..features import PACKED_CHANNELS

RECORD_CELLS = PACKED_CHANNELS * BOARD_SIZE * BOARD_SIZE  # 3,249
WIRE_BYTES = (RECORD_CELLS + 1) // 2  # 1,625 per position

# positions per packing pass: chunks keep the pack's ~4 passes over its
# working set cache-resident
_PACK_CHUNK = 1024


def nibble_pack_np(packed: np.ndarray) -> np.ndarray:
    """(..., 9, 19, 19) uint8 -> (..., 1625) uint8 on the host.

    Values clamp to 15 first; the pad cell and a little-endian uint16 view
    of each cell pair make every pass contiguous."""
    if packed.dtype != np.uint8 or packed.shape[-3:] != (
            PACKED_CHANNELS, BOARD_SIZE, BOARD_SIZE):
        raise ValueError(f"nibble_pack_np takes (..., {PACKED_CHANNELS}, "
                         f"{BOARD_SIZE}, {BOARD_SIZE}) uint8, got "
                         f"{packed.dtype} {packed.shape}")
    lead = packed.shape[:-3]
    flat = packed.reshape(-1, RECORD_CELLS)
    n = flat.shape[0]
    out = np.empty((n, WIRE_BYTES), dtype=np.uint8)
    buf = np.empty((min(n, _PACK_CHUNK), RECORD_CELLS + 1), dtype=np.uint8)
    buf[:, RECORD_CELLS] = 0  # the pad cell, constant across chunks
    for i in range(0, n, _PACK_CHUNK):
        chunk = flat[i:i + _PACK_CHUNK]
        b = buf[:len(chunk)]
        np.minimum(chunk, 15, out=b[:, :RECORD_CELLS])
        pairs = b.view("<u2")  # low byte = even cell
        out[i:i + _PACK_CHUNK] = ((pairs & 0x0F)
                                  | ((pairs >> 4) & 0xF0)).astype(np.uint8)
    return out.reshape(*lead, WIRE_BYTES)


def nibble_unpack(wire: torch.Tensor) -> torch.Tensor:
    """(..., 1625) uint8 -> (..., 9, 19, 19) uint8, on the tensor's
    device."""
    lead = wire.shape[:-1]
    flat = torch.stack([wire & 0x0F, wire >> 4], dim=-1).reshape(
        *lead, 2 * WIRE_BYTES)
    return flat[..., :RECORD_CELLS].reshape(
        *lead, PACKED_CHANNELS, BOARD_SIZE, BOARD_SIZE)
