"""``device.idle_frac.train``'s reading, on the dual-head training cell:
the share of the profiler's device-only phase in which nothing ran on the
card."""

from benchmark import harness

read = harness.load_reader("device.idle_frac.train").read
