"""The share of the window's untraced phase that the step loop spent waiting in the
loader's ``get()`` for its next batch (the host clock around the call)."""


def read(run):
    c = run.counters["clock"]
    if "loader_wait_s" not in c:
        return None
    return c["loader_wait_s"] / c["window_s"]
