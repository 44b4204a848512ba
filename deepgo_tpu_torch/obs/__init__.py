"""Observability: the process-wide metrics registry."""

from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, get_registry)
