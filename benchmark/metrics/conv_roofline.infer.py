"""The convolutions' share of their roofline in bulk inference, in %: the
real rows' forward FLOPs at the card's bf16 peak, over the device time of
every kernel a convolution op launched (the profiler's phase that links
kernels to host ops)."""


def read(run):
    t = run.summary["host"]["category_s"].get("conv")
    if not t or run.peak is None:
        return None
    flops = run.cost.forward_flops(run.cfg, run.counters["host"]["rows"])
    return 100.0 * flops / run.peak["bf16_flops"] / t
