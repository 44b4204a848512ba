"""The serving forward's share of the card's bf16 peak, in %: the real
rows' forward FLOPs (``cost.forward_flops``) over the window's untraced
phase and the peak."""


def read(run):
    c = run.counters["clock"]
    if run.peak is None or not c.get("rows"):
        return None
    flops = run.cost.forward_flops(run.cfg, c["rows"])
    return 100.0 * flops / (c["window_s"] * run.peak["bf16_flops"])
