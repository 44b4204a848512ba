"""Feature schema: packed on-disk records and the 37-plane model encoding.

The port's own copy of ``deepgo_tpu/features.py`` (the port imports nothing
of the JAX package). Tests hold the two copies equal.

**Packed record** (on disk / host->device transfer): (9, 19, 19) uint8.
Channels: 0 stones (0 empty, 1 black, 2 white), 1 chain liberties, 2-3
liberties-after-playing for black / white, 4-5 kills-by-playing for black /
white, 6 stone age, 7-8 working-ladder flags for black / white.

**Expanded planes** (model input): (37, 19, 19), all binary, from the
to-move player's perspective:

  planes 0-2    point is empty / mine / opponent's
  planes 3-6    chain liberties == 1, 2, 3, >= 4
  planes 7-13   my liberties-after-playing == 0 (empty points only),
                1, 2, 3, 4, 5, >= 6
  planes 14-20  my kills-by-playing == 1..6, >= 7
  planes 21-25  point age == 1..5
  plane  26     I can launch a working ladder capture here
  plane  27     always zero (the reference's dead RANK base plane)
  planes 28-36  one-hot full-plane encoding of my dan rank (1..9)

The training target for a move at 0-based (x, y) is class ``19*x + y``.
"""

from __future__ import annotations

import numpy as np

from . import BOARD_SIZE

# ---- packed record channel layout (write side) ----
P_STONES = 0
P_LIBERTIES = 1
P_LIB_AFTER = 2  # 2 channels, per player
P_KILLS = 4  # 2 channels, per player
P_AGE = 6
P_LADDERS = 7  # 2 channels, per player
PACKED_CHANNELS = 9

# ---- expanded plane layout (model input) ----
X_STONE = 0  # 3 planes
X_LIBERTIES = 3  # 4 planes
X_LIB_AFTER = 7  # 7 planes
X_KILLS = 14  # 7 planes
X_AGE = 21  # 5 planes
X_LADDER = 26  # 1 plane
X_RANK_BASE = 27  # rank r occupies plane 27 + r; plane 27 itself stays zero
NUM_PLANES = 37


def target_index(x: int, y: int) -> int:
    """0-based move coordinates -> class index in [0, 361)."""
    return BOARD_SIZE * x + y


def expand_planes_np(
    packed: np.ndarray, player: int, rank: int, dtype=np.float32
) -> np.ndarray:
    """NumPy reference expansion of one packed record to the 37 model planes
    in (37, 19, 19) layout.

    ``player`` is the player to move (1 or 2); ``rank`` their dan rank (1..9).
    The batched tensor versions live in ``deepgo_tpu_torch.ops``; tests
    assert they agree.
    """
    if packed.shape != (PACKED_CHANNELS, BOARD_SIZE, BOARD_SIZE):
        raise ValueError(f"packed record has shape {packed.shape}")
    if not (player in (1, 2) and 1 <= rank <= 9):
        raise ValueError(f"player {player} / rank {rank} out of range")
    out = np.zeros((NUM_PLANES, BOARD_SIZE, BOARD_SIZE), dtype=dtype)

    stones = packed[P_STONES]
    empty = stones == 0
    out[X_STONE + 0] = empty
    out[X_STONE + 1] = stones == player
    out[X_STONE + 2] = stones == 3 - player

    libs = packed[P_LIBERTIES]
    for i in range(3):
        out[X_LIBERTIES + i] = libs == i + 1
    out[X_LIBERTIES + 3] = libs >= 4

    lib_after = packed[P_LIB_AFTER + player - 1]
    out[X_LIB_AFTER + 0] = empty & (lib_after == 0)
    for i in range(1, 6):
        out[X_LIB_AFTER + i] = lib_after == i
    out[X_LIB_AFTER + 6] = lib_after >= 6

    kills = packed[P_KILLS + player - 1]
    for i in range(6):
        out[X_KILLS + i] = kills == i + 1
    out[X_KILLS + 6] = kills >= 7

    age = packed[P_AGE]
    for i in range(5):
        out[X_AGE + i] = age == i + 1

    out[X_LADDER] = packed[P_LADDERS + player - 1] >= 1

    out[X_RANK_BASE + rank] = 1.0
    return out
