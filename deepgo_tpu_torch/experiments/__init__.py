"""Experiment artefacts: the checkpoint reader."""
