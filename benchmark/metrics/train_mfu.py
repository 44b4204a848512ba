"""The training step's share of the card's bf16 peak, in %: the step's
convolution FLOPs from shapes (``cost.train_flops``) times the steps of the
window's untraced phase, over its time and the card's peak."""


def read(run):
    c = run.counters["clock"]
    if run.peak is None or not c.get("steps"):
        return None
    flops = run.cost.train_flops(run.cfg, c["rows_per_card"]) * c["steps"]
    return 100.0 * flops / (c["window_s"] * run.peak["bf16_flops"])
