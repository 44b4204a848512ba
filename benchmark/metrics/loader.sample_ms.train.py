"""The loader's cost a batch, in ms: the mean of the program's
``loader.sample`` spans, one worker sampling one batch (1,024 rows in
``large.train.b1024``) on the host (``deepgo_span_seconds`` in
``deepgo_tpu_torch.obs.get_registry()``, timed by ``data/loader.py``).
Only a faster sampler moves it: the time a worker then waits on a full
queue (``loader.put_wait``) is not in it. The batches are the whole
run's, warm-up and all three phases of ``--trace 1`` included."""


def read(run):
    from deepgo_tpu_torch.obs import get_registry

    spans = {m.name: m for m in get_registry().metrics()}.get(
        "deepgo_span_seconds")
    snap = None if spans is None else spans.snapshot(name="loader.sample",
                                                     status="ok")
    if snap is None or snap["count"] == 0:
        return None
    return 1e3 * snap["sum"] / snap["count"]
