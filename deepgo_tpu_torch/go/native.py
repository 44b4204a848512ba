"""ctypes bridge to the native C++ rules engine.

The port's copy of ``deepgo_tpu/go/native.py``, built from a source of its
own: ``csrc/goboard.cpp`` is a byte-equal copy of ``native/goboard.cpp``
(tests/test_torch_games.py holds it so). At first use it compiles with the
host C++ compiler (``$CXX``, else ``g++`` or ``c++``) and the JAX
package's Makefile flags into ``build/`` beside this file (git-ignored),
named by a digest of the source and the flags, so an edited source never
loads a stale library. A thread lock makes one build per process, a file
lock one build across processes, and the library appears under its final
name by an atomic rename. It never writes into ``native/build/``, where the
JAX package's ``make`` builds.

This is host rules code, not a device kernel: where no compiler exists,
every consumer falls back to the pure-Python engine, which is semantically
identical (both are held to the same records in the tests).
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

import numpy as np

from .. import BOARD_SIZE
from ..features import PACKED_CHANNELS

SOURCE = Path(__file__).with_name("csrc") / "goboard.cpp"
BUILD_DIR = Path(__file__).with_name("build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def find_compiler() -> str | None:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"goboard-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    """Compile ``SOURCE`` to ``target`` unless another process already
    did; False when no compiler exists or the compile fails."""
    cxx = find_compiler()
    if cxx is None:
        return False
    BUILD_DIR.mkdir(exist_ok=True)
    # lint: allow[atomic-write] an empty lock file for flock, never read: nothing durable to tear
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if target.exists():
            return True
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        try:
            result = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                     str(SOURCE)], capture_output=True,
                                    text=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return False
        if result.returncode != 0:
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, target)
        return True


def load() -> ctypes.CDLL | None:
    """The loaded library, building it if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        target = library_path()
        if not target.exists() and not _build(target):
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            return None
        lib.goboard_transcribe.restype = ctypes.c_int
        lib.goboard_transcribe.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.goboard_summarize.restype = None
        lib.goboard_summarize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.goboard_summarize_batch.restype = None
        lib.goboard_summarize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        lib.goboard_play_batch.restype = ctypes.c_int
        lib.goboard_play_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def batch_available() -> bool:
    """The batch entry points come with the library: the port builds from
    its own source, so no stale library can lack them."""
    return available()


def _moves_array(moves) -> np.ndarray:
    return np.array([(m.player, m.x, m.y) for m in moves], dtype=np.int32).reshape(-1, 3)


def transcribe_game_native(handicaps, moves) -> np.ndarray:
    """Replay a whole game natively -> packed (M, 9, 19, 19) records of the
    pre-move boards. Raises on illegal positions (like the Python engine)."""
    lib = load()
    assert lib is not None, "native engine unavailable"
    h = _moves_array(handicaps)
    m = _moves_array(moves)
    out = np.empty(
        (len(moves), PACKED_CHANNELS, BOARD_SIZE, BOARD_SIZE), dtype=np.uint8
    )
    rc = lib.goboard_transcribe(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(handicaps),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(moves),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        from .board import IllegalMoveError

        if rc <= -1000000:
            raise IllegalMoveError(f"illegal handicap placement #{-(rc + 1000000) - 1}")
        raise IllegalMoveError(f"illegal move #{-rc - 1}")
    return out


def play_batch_native(stones: np.ndarray, age: np.ndarray, moves: np.ndarray,
                      players: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Apply one move per board IN PLACE across N boards in one native call.

    ``stones`` (N, 19, 19) uint8 and ``age`` (N, 19, 19) int32 are mutated;
    ``moves`` is (N,) int32 flat indices (-1 = pass, board untouched) and
    ``players`` (N,) int32. Returns the (N,) int32 simple-ko points (flat
    index of the banned recapture, -1 = none) — the native twin of
    ``selfplay.apply_move``'s ko rule. Raises IllegalMoveError if any move
    lands on an occupied point. ``n_threads <= 0`` uses every core.
    """
    lib = load()
    assert lib is not None, "native batch play unavailable"
    assert stones.dtype == np.uint8 and stones.flags.c_contiguous
    assert age.dtype == np.int32 and age.flags.c_contiguous
    assert stones.ndim == 3 and stones.shape[1:] == (BOARD_SIZE, BOARD_SIZE)
    assert age.shape == stones.shape
    m = np.ascontiguousarray(moves, dtype=np.int32)
    p = np.ascontiguousarray(players, dtype=np.int32)
    n = stones.shape[0]
    assert m.shape == (n,) and p.shape == (n,)
    ko = np.empty(n, dtype=np.int32)
    rc = lib.goboard_play_batch(
        stones.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        age.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        ko.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    if rc != 0:
        from .board import IllegalMoveError

        raise IllegalMoveError(f"illegal move on board #{-rc - 1}")
    return ko


def summarize_batch_native(stones: np.ndarray, age: np.ndarray,
                           n_threads: int = 0) -> np.ndarray:
    """Summarize N independent boards in one native call.

    ``stones`` is (N, 19, 19) uint8, ``age`` (N, 19, 19) int32; returns
    packed (N, 9, 19, 19) uint8 records. One FFI crossing for the whole
    batch, fanned over C++ threads (``n_threads <= 0`` = every core).
    """
    lib = load()
    assert lib is not None, "native batch summarize unavailable"
    s = np.ascontiguousarray(stones, dtype=np.uint8)
    a = np.ascontiguousarray(age, dtype=np.int32)
    assert s.ndim == 3 and s.shape[1:] == (BOARD_SIZE, BOARD_SIZE)
    assert a.shape == s.shape
    n = s.shape[0]
    out = np.empty((n, PACKED_CHANNELS, BOARD_SIZE, BOARD_SIZE), dtype=np.uint8)
    lib.goboard_summarize_batch(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads,
    )
    return out


def summarize_native(stones: np.ndarray, age: np.ndarray) -> np.ndarray:
    lib = load()
    assert lib is not None, "native engine unavailable"
    s = np.ascontiguousarray(stones, dtype=np.uint8)
    a = np.ascontiguousarray(age, dtype=np.int32)
    out = np.empty((PACKED_CHANNELS, BOARD_SIZE, BOARD_SIZE), dtype=np.uint8)
    lib.goboard_summarize(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out
