"""Datasets: the transcribed split format and the input pipeline."""
