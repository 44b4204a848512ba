"""The serving forward's host time a call spent putting its inputs on the card (the pageable copy's host staging and the copy), in ms: the
mean of the program's ``serve.h2d`` spans (``deepgo_span_seconds`` in
``deepgo_tpu_torch.obs.get_registry()``, timed by ``models/serving.py``)
over the calls that returned, less the longest one: the run's first call
holds the one-off set-up (building the expansion kernel, loading cuDNN).
The calls are the whole run's: the warm-up calls and all three phases of
``--trace 1``, the profiler's host phase, where the host runs slower,
included."""


def read(run):
    from deepgo_tpu_torch.obs import get_registry

    spans = {m.name: m for m in get_registry().metrics()}.get(
        "deepgo_span_seconds")
    snap = None if spans is None else spans.snapshot(name="serve.h2d",
                                                     status="ok")
    if snap is None or snap["count"] < 2:
        return None
    return 1e3 * (snap["sum"] - snap["max"]) / (snap["count"] - 1)
