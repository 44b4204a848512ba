"""The dual-head training step's share of the card's bf16 peak, in %: the
step's convolution and dense FLOPs from shapes (``cost_resnet.
train_flops``) times the steps of the window's untraced phase, over its
time and the card's peak. None for a network without residual blocks."""

from benchmark import cost_resnet


def read(run):
    c = run.counters["clock"]
    if run.peak is None or not c.get("steps") or "blocks" not in run.cfg:
        return None
    flops = cost_resnet.train_flops(run.cfg, c["rows_per_card"]) * c["steps"]
    return 100.0 * flops / (c["window_s"] * run.peak["bf16_flops"])
