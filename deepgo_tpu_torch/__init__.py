"""deepgo_tpu_torch — the PyTorch / CUDA port of ``deepgo_tpu`` for NVIDIA Hopper.

The JAX package ``deepgo_tpu`` stays beside this one as the reference: the
tests give both packages the same weights and inputs (made with numpy) and
compare the outputs. Module names here mirror the JAX package so a reader
finds each counterpart (``features``, ``ops/expand``, ``models/policy_cnn``,
``serving/engine``, ...).

Rules of the port:

* It imports ``torch`` and numpy, never ``jax`` and nothing of
  ``deepgo_tpu`` — not even a module there that does not load jax. What it
  needs from such a module (plane constants, the bucket ladder, the
  checkpoint reader) is a copy of its own.
* Every TPU (Pallas) kernel on a ported path is a kernel written by hand for
  Hopper (``ops/csrc/*.cu``), built with ``nvcc`` at first use. Beside each
  kernel sits its plain PyTorch version. A CPU tensor goes to the plain
  version; a CUDA tensor goes to the kernel, or the call raises. Nothing
  falls back from the kernel to the plain version.
* Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
  Without CUDA they raise instead of moving to the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

BOARD_SIZE = 19
NUM_POINTS = BOARD_SIZE * BOARD_SIZE


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on. A CUDA device without a
    usable CUDA runtime raises: the port never moves work to the CPU unless
    the caller asked for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device
