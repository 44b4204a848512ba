"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc at first use.

Each source compiles on its own into a shared library with a plain C
interface, loaded with ctypes: seconds per source, where a build that
includes PyTorch's headers takes minutes. Libraries land in ``build/``
beside this file (git-ignored), named by a digest of the source and the
flags, so an edited source never loads a stale library. A thread lock makes
one build per process and a file lock one build across processes; the
sources that need a build compile in parallel, one nvcc each.

Beside ``launch`` sit the checks and partition pieces every wrapper
(``cuda_*.py``) shares: the element sizes, the one-CUDA-device and 16-byte
alignment tests, the vector width, the per-device SM count and the check of
a (B, C, 19, 19) channels-last activation.

Nothing here runs at import: the CPU tests import every module, and this
machine need not have nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .. import BOARD_SIZE

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# bytes a value of each dtype the kernels take
ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}
VECTOR_BYTES = 16  # the widest access of one thread

_lock = threading.Lock()
_sm_counts: dict[int, int] = {}
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], object] = {}
# name -> nvcc's output (ptxas register / shared-memory report) of the
# build this process ran; empty for a library found already built
build_log: dict[str, str] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor /usr/local/cuda/bin): the "
            "CUDA kernels build only on a machine with the CUDA toolkit")
    return nvcc


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build(names=None) -> dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for each name (default: every source)
    whose library is missing; returns name -> library path. Raises with
    nvcc's output when a compile fails."""
    srcs = sources() if names is None else [CSRC / f"{n}.cu" for n in names]
    targets = {s.stem: library_path(s) for s in srcs}
    if all(t.exists() for t in targets.values()):
        return targets
    nvcc = find_nvcc()
    with _lock:
        BUILD_DIR.mkdir(exist_ok=True)
        # lint: allow[atomic-write] an empty lock file for flock, never read: nothing durable to tear
        with open(BUILD_DIR / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            todo = [s for s in srcs if not targets[s.stem].exists()]
            procs = []
            for s in todo:
                tmp = targets[s.stem].with_suffix(f".{os.getpid()}.tmp")
                procs.append((s, tmp, subprocess.Popen(
                    nvcc_command(nvcc, s, tmp), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
            failed = []
            for s, tmp, proc in procs:
                out, _ = proc.communicate()
                build_log[s.stem] = out
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {s} "
                                  f"(exit {proc.returncode}):\n{out}")
                else:
                    os.replace(tmp, targets[s.stem])
            if failed:
                raise RuntimeError("\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed,
    together with every other source that needs a build (in parallel, so
    a process pays one build's time)."""
    lib = _libs.get(name)
    if lib is None:
        path = build()[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib


def function(lib: str, name: str, argtypes: list):
    """The C launcher ``name`` of ``csrc/<lib>.cu``, typed: ``argtypes``
    in, a ``cudaError_t`` as int out."""
    fn = _functions.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[(lib, name)] = fn
    return fn


def launch(fn, device, args: list, what: str) -> None:
    """Call the C launcher ``fn`` with ``args`` and the current stream of
    CUDA ``device``, with ``device`` current; raise when it returns an
    error (``what`` names the call)."""
    # the raw handle of the current stream: 0.2 us a call on an H100's
    # host, where torch.cuda.current_stream(device) builds a Stream in 6 us
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed with cudaError "
                           f"{err} ({what})")


def sm_count(device: torch.device) -> int:
    """The SMs of CUDA ``device``, read once a device."""
    n = _sm_counts.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = n
    return n


def check_device(device: torch.device, *others: torch.Tensor) -> None:
    if device.type != "cuda" or any(t.device != device for t in others):
        raise ValueError(f"the tensors must lie on one CUDA device, got "
                         f"{[device, *(t.device for t in others)]}")


def is_aligned(*tensors) -> bool:
    return all(t.data_ptr() % VECTOR_BYTES == 0 for t in tensors)


def vector_width(channels: int, elem_bytes: int, aligned: bool) -> int:
    """Values a thread accesses: 16 bytes of neighbouring channels where C
    allows it and the tensors are 16-byte aligned, else 1."""
    vector = VECTOR_BYTES // elem_bytes
    return 1 if channels % vector or not aligned else vector


def check_activation(name: str, t: torch.Tensor, kernels: str,
                     max_batch: int | None = None) -> None:
    """Raise unless ``t`` is a (B, C, 19, 19) channels-last activation in a
    dtype of ``ELEM_BYTES`` with 1 <= B (<= ``max_batch`` where given);
    ``kernels`` names the kernels in the message."""
    if t.dtype not in ELEM_BYTES:
        raise ValueError(f"the {kernels} kernels take bfloat16 or float32, "
                         f"not {t.dtype} ({name})")
    if (t.dim() != 4 or tuple(t.shape[2:]) != (BOARD_SIZE, BOARD_SIZE)
            or t.shape[0] < 1
            or max_batch is not None and t.shape[0] > max_batch):
        batch = "B >= 1" if max_batch is None else f"1 <= B <= {max_batch}"
        raise ValueError(f"{name} must be ({batch}, C, {BOARD_SIZE}, "
                         f"{BOARD_SIZE}), got {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be channels-last contiguous")
