"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc at first use.

Each source compiles on its own into a shared library with a plain C
interface, loaded with ctypes: seconds per source, where a build that
includes PyTorch's headers takes minutes. Libraries land in ``build/``
beside this file (git-ignored), named by a digest of the source and the
flags, so an edited source never loads a stale library. A thread lock makes
one build per process and a file lock one build across processes; the
sources that need a build compile in parallel, one nvcc each.

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

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
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
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build([name])[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib
