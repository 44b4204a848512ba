"""``loader.wait_frac.train``'s reading, on the dual-head training cell:
the share of the window's untraced phase that the step loop spent waiting
in the loader's ``get()``."""

from benchmark import harness

read = harness.load_reader("loader.wait_frac.train").read
