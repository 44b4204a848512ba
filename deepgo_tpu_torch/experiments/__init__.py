"""Experiment management: config, runs, checkpoints, warm restarts."""

from .experiment import Experiment, ExperimentConfig  # noqa: F401
