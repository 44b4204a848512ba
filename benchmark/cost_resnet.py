"""Operations and bytes of AlphaGo Zero's dual-head network (a configuration
file with ``blocks``), from shapes alone.

FLOPs follow ``cost.py``'s convention: a SAME-padded convolution on the 19
x 19 board is charged only the kernel taps that land on the board
(``cost.layer_flops``); a dense layer 2 FLOPs a multiply-add. A training
step adds every layer's weight gradient and the input gradient of every
layer but the first convolution (the planes need no gradient). BN, the
residual adds, ReLUs, tanh and the loss are left out of the FLOPs.

``epilogue_bytes`` is what BN, the skip add and ReLU of the trunk must
move at the least, each tensor touched once: per sample, a tensor is
``channels`` x 361 elements of the compute type. The convolutional block
reads its convolution's output and writes its activation forward, and
reads dY, the saved activation and the convolution's output and writes dX
backward: 6 tensors. A residual block's two epilogues read each
convolution's output and the skip and write each activation forward (5),
and read dY, the saved activation and the convolution's output and write
dX for each, with the skip's gradient written once more (9): 14 tensors.
No implementation of the trunk's epilogues, fused or not, moves less, so
no reading over this bound can pass 100 %.
"""

from __future__ import annotations

from . import cost

POLICY_FILTERS = 2
VALUE_FILTERS = 1


def conv_shapes(cfg: dict) -> list[tuple[int, int, int]]:
    """[(kernel, c_in, c_out)]: the convolutional block, the residual
    blocks' two convolutions each, the policy head's and the value head's
    1 x 1 convolutions."""
    c = cfg["channels"]
    trunk = [(3, c, c)] * (2 * (cfg["blocks"] - 1))
    return ([(3, cfg["input_planes"], c)] + trunk
            + [(1, c, POLICY_FILTERS), (1, c, VALUE_FILTERS)])


def dense_shapes(cfg: dict) -> list[tuple[int, int]]:
    """[(c_in, c_out)] of the dense layers: the policy head's, the value
    head's two."""
    return [(POLICY_FILTERS * cost.POINTS, cost.POINTS),
            (VALUE_FILTERS * cost.POINTS, cfg["value_hidden"]),
            (cfg["value_hidden"], 1)]


def conv_forward_flops(cfg: dict, rows: int = 1) -> float:
    return rows * sum(cost.layer_flops(*s) for s in conv_shapes(cfg))


def conv_train_flops(cfg: dict, rows: int = 1) -> float:
    """Convolution FLOPs of a training step: forward, weight gradients, and
    input gradients of every convolution but the first."""
    first = cost.layer_flops(*conv_shapes(cfg)[0])
    return 3.0 * conv_forward_flops(cfg, rows) - rows * first


def forward_flops(cfg: dict, rows: int = 1) -> float:
    return conv_forward_flops(cfg, rows) + rows * sum(
        2.0 * a * b for a, b in dense_shapes(cfg))


def train_flops(cfg: dict, rows: int = 1) -> float:
    """Every convolution's and dense layer's FLOPs of a training step."""
    return conv_train_flops(cfg, rows) + 3.0 * rows * sum(
        2.0 * a * b for a, b in dense_shapes(cfg))


def num_params(cfg: dict) -> int:
    """Convolution weights, BN scale and shift, dense weights and biases."""
    return (sum(k * k * a * b + 2 * b for k, a, b in conv_shapes(cfg))
            + sum(a * b + b for a, b in dense_shapes(cfg)))


def epilogue_bytes(cfg: dict, rows: int = 1, elem_bytes: int = 2) -> int:
    """The least bytes the trunk's BN, skip adds and ReLUs move in one
    training step over ``rows`` samples (module docstring)."""
    tensor = cfg["channels"] * cost.POINTS * elem_bytes
    return rows * tensor * (6 + 14 * (cfg["blocks"] - 1))
