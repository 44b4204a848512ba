"""Warm restart: continue a trained checkpoint under a fresh run id with a
fresh optimizer (the port of ``deepgo_tpu/experiments/repeated.py``; the
reference's experiments/repeated.lua:6-22).

The weights, step and validation history carry over; the optimizer starts
anew at the configured base rate. ``num`` offsets the sampling seed, as the
reference's ``-num`` seed-variant flag does.
"""

from __future__ import annotations

import uuid

from . import checkpoint as ckpt
from .experiment import Experiment, ExperimentConfig


def warm_restart(path: str, overrides: dict, num: int = 0,
                 device="cuda") -> Experiment:
    meta, p_leaves, _ = ckpt.load_checkpoint(path)
    config = ExperimentConfig.from_dict(meta["config"])
    if num:
        overrides = {**overrides, "seed": config.seed + num}
    if overrides:
        config = config.replace(**overrides)
    exp = Experiment(config, run_id=uuid.uuid4().hex[:8], device=device)
    exp.step = meta["step"]
    exp.validation_history = list(meta["validation_history"])
    exp.init()  # fresh optimizer state: reference repeated.lua:17
    exp._restore(p_leaves, None, path)
    return exp
