"""The share of the profiler's device-only phase in which nothing ran on
the card: one less the union of the device's kernels, copies and fills
over the window."""


def read(run):
    s = run.summary["device"]
    if not s["device_ops"]:
        return None
    return 1.0 - s["busy_s"] / s["window_s"]
