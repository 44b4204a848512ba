"""The dual-head network's convolutions' share of their roofline in
training, in %: fprop, wgrad and dgrad FLOPs of the real rows
(``cost_resnet.conv_train_flops``, compute-bound) at the card's bf16 peak,
over the device time of every kernel a convolution op launched (the
profiler's phase that links kernels to host ops). None for a network
without residual blocks."""

from benchmark import cost_resnet


def read(run):
    t = run.summary["host"]["category_s"].get("conv")
    if not t or run.peak is None or "blocks" not in run.cfg:
        return None
    c = run.counters["host"]
    flops = cost_resnet.conv_train_flops(run.cfg, c["rows_per_card"]) \
        * c["steps"]
    return 100.0 * flops / run.peak["bf16_flops"] / t
