"""Run provenance: git commit stamping (the port's copy of
``deepgo_tpu/utils/gitinfo.py``). The short sha goes into run metadata and
checkpoints; outside a git checkout it is None."""

from __future__ import annotations

import os
import subprocess


def git_sha(cwd: str | None = None) -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True,
            text=True,
            timeout=5,
            cwd=cwd or os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None
