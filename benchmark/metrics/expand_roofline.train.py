"""The expansion kernel's share of its roofline in training, in %: the
bytes it must move (``cost.expand_bytes``, bandwidth-bound) at the card's
HBM bandwidth, over its device time in the profiler's device-only phase."""


def read(run):
    t = run.summary["device"]["category_s"].get("expand")
    if not t or run.peak is None:
        return None
    c = run.counters["device"]
    nbytes = run.cost.expand_bytes(c["rows_per_card"]) * c["steps"]
    return 100.0 * nbytes / run.peak["hbm_bytes_per_s"] / t
