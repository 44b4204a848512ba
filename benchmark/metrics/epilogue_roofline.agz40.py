"""The trunk's BN, skip-add and ReLU epilogues' share of their roofline in
training, in %: the bytes they must move (``cost_resnet.epilogue_bytes``,
bandwidth-bound) at the card's HBM bandwidth, over the device time of
every kernel that neither a convolution op launched nor is the expansion
(the trace's ``other``, in the profiler's phase that links kernels to host
ops). ``other`` also holds the heads, the loss, the unwire and the
optimizer, so the share is a floor of the epilogues' own. None for a
network without residual blocks."""

from benchmark import cost_resnet


def read(run):
    t = run.summary["host"]["category_s"].get("other")
    if not t or run.peak is None or "blocks" not in run.cfg:
        return None
    c = run.counters["host"]
    nbytes = cost_resnet.epilogue_bytes(run.cfg, c["rows_per_card"]) \
        * c["steps"]
    return 100.0 * nbytes / run.peak["hbm_bytes_per_s"] / t
