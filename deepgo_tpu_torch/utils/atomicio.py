"""Crash-safe file writes: temp file + fsync + atomic rename.

The port's copy of ``deepgo_tpu/utils/atomicio.py``. ``atomic_write``
guarantees readers only ever observe either the old complete file or the
new complete file:

  1. the payload goes to a uniquely-named temp file in the *same directory*
     (``os.replace`` is only atomic within a filesystem),
  2. the file is flushed and fsync'd so the bytes are durable before they
     become visible,
  3. ``os.replace`` swaps it in atomically,
  4. the directory entry itself is fsync'd (best effort) so the rename
     survives a power cut.

On any failure the temp file is removed and the destination is untouched.
"""

from __future__ import annotations

import contextlib
import os
import tempfile


def _fsync_dir(path: str) -> None:
    """Flush the directory entry after a rename (best effort: some
    filesystems refuse O_RDONLY fsync on directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wb"):
    """Context manager yielding a file object whose contents replace
    ``path`` atomically on successful exit. If the body raises, ``path``
    is left exactly as it was and the temp file is deleted."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(path) + ".", suffix=".tmp"
    )
    f = os.fdopen(fd, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
        tmp = None  # committed: nothing to clean up
        _fsync_dir(directory)
    finally:
        if not f.closed:
            f.close()
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
