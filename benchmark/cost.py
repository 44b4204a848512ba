"""Operations and bytes of the policy network's work, from shapes alone.

The FLOP arithmetic is copied from ``deepgo_tpu_torch/obs/costmodel.py``
(``_same_taps``, ``analytic_flops``): a SAME-padded convolution on the 19 x
19 board is charged only the kernel taps that land on the board, which is
what the mathematics needs (a dense ``k * k * 361`` count overstates the
stack by about 10 %). A training step adds the weight gradient of every
layer and the input gradient of every layer but the first (the planes need
no gradient). Bias adds, ReLUs and the log-softmax are left out: under 1 %
of the work at these widths.

The peaks come from ``peaks.json`` beside this file, matched on the name
``torch.cuda.get_device_name()`` gives.
"""

from __future__ import annotations

import json
from pathlib import Path

BOARD = 19
POINTS = BOARD * BOARD
PACKED_CHANNELS = 9
PLANES = 37


def same_taps(size: int, k: int) -> int:
    """Kernel taps, summed over one axis's outputs, that land inside a
    SAME-padded input of ``size`` (copied from ``obs/costmodel.py``)."""
    half = k // 2
    return sum(min(i + half, size - 1) - max(i - half, 0) + 1
               for i in range(size))


def layer_shapes(cfg: dict) -> list[tuple[int, int, int]]:
    """[(kernel, c_in, c_out)] of each convolution of a configuration file's
    network: a first 5 x 5 layer, then 3 x 3 layers, the last one 1 wide."""
    widths = [cfg["channels"]] * (cfg["num_layers"] - 1) + [1]
    shapes, c_in = [], cfg["input_planes"]
    for i, c_out in enumerate(widths):
        shapes.append((cfg["first_kernel"] if i == 0 else cfg["kernel"],
                       c_in, c_out))
        c_in = c_out
    return shapes


def layer_flops(k: int, c_in: int, c_out: int) -> float:
    """One board's forward FLOPs (2 per multiply-add) of one layer."""
    taps = same_taps(BOARD, k)
    return 2.0 * c_in * c_out * taps * taps


def forward_flops(cfg: dict, rows: int = 1) -> float:
    """Forward convolution FLOPs of ``rows`` boards."""
    return rows * sum(layer_flops(*s) for s in layer_shapes(cfg))


def train_flops(cfg: dict, rows: int = 1) -> float:
    """Convolution FLOPs of one training step over ``rows`` boards: the
    forward, every layer's weight gradient, and the input gradient of every
    layer but the first."""
    per = [layer_flops(*s) for s in layer_shapes(cfg)]
    return rows * (3.0 * sum(per) - per[0])


def num_params(cfg: dict) -> int:
    return sum(k * k * c_in * c_out + c_out * POINTS
               for k, c_in, c_out in layer_shapes(cfg))


def expand_bytes(rows: int, out_bytes: int = 2) -> int:
    """Bytes the expansion must move for ``rows`` boards: each packed
    record (3,249 B), player and rank (4 B each) read once, and the 37
    planes written once in the compute type (bf16: 26,714 B)."""
    return rows * (PACKED_CHANNELS * POINTS + 8 + PLANES * POINTS * out_bytes)


def peak(device_name: str) -> dict:
    """The row of ``peaks.json`` for a card name; raises for an unknown
    card, so that no share is ever divided by a guessed peak."""
    table = json.loads(Path(__file__).with_name("peaks.json").read_text())
    low = device_name.lower()
    for row in table["cards"]:
        if row["match"] in low:
            return row
    raise KeyError(f"no peak for device {device_name!r} in peaks.json")
