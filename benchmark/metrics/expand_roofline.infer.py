"""The expansion kernel's share of its roofline in bulk inference, in %:
the bytes it must move for the rows served (``cost.expand_bytes``) at the
card's HBM bandwidth, over its device time in the profiler's device-only phase."""


def read(run):
    t = run.summary["device"]["category_s"].get("expand")
    if not t or run.peak is None:
        return None
    nbytes = run.cost.expand_bytes(run.counters["device"]["rows"])
    return 100.0 * nbytes / run.peak["hbm_bytes_per_s"] / t
