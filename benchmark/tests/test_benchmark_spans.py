"""The readers of the program's own spans (``serve.h2d_ms.infer``,
``serve.net_ms.infer``, ``loader.sample_ms.train``): exact values on a
hand-filled registry, None where the program recorded none of their spans
(as at a commit without them) or a serving forward's first call alone,
and a positive reading from a traced run of each cell on the CPU."""

import time
import types

import pytest

import deepgo_tpu_torch.obs as obs
from benchmark import harness
from benchmark.tests.conftest import tiny

READERS = ("serve.h2d_ms.infer", "serve.net_ms.infer",
           "loader.sample_ms.train")
RUN = types.SimpleNamespace()  # the readers read the registry alone


def registry(spans) -> obs.MetricsRegistry:
    reg = obs.MetricsRegistry()
    hist = reg.histogram("deepgo_span_seconds")
    for name, status, seconds in spans:
        hist.observe(seconds, name=name, status=status)
    return reg


def read_all(monkeypatch, reg) -> dict:
    monkeypatch.setattr(obs, "get_registry", lambda: reg)
    return {m: harness.load_reader(m).read(RUN) for m in READERS}


def test_the_readers_on_a_hand_filled_registry(monkeypatch):
    """Each serving span's longest occurrence is left out (the first
    call's set-up); calls that raised, and the workers' waits, are left
    out."""
    reg = registry([
        ("serve.h2d", "ok", 0.25), ("serve.h2d", "ok", 0.25),
        ("serve.h2d", "ok", 1.0), ("serve.h2d", "error", 0.125),
        ("serve.net", "ok", 4.0), ("serve.net", "ok", 0.125),
        ("serve.d2h", "ok", 0.375), ("serve.d2h", "ok", 0.5),
        ("loader.sample", "ok", 0.5), ("loader.sample", "ok", 0.25),
        ("loader.sample", "error", 2.0), ("loader.put_wait", "ok", 0.25),
        ("validate", "ok", 7.0), ("checkpoint_save", "ok", 3.0)])
    assert read_all(monkeypatch, reg) == {
        "serve.h2d_ms.infer": 250.0, "serve.net_ms.infer": 125.0,
        "loader.sample_ms.train": 375.0}


@pytest.mark.parametrize("spans", [None, [], [("validate", "ok", 1.0)],
                                   [("serve.h2d", "ok", 0.5),
                                    ("serve.net", "ok", 0.5),
                                    ("loader.put_wait", "ok", 0.5)]],
                         ids=["no_family", "empty", "other_spans",
                              "first_call_only"])
def test_the_readers_give_none_where_nothing_was_recorded(monkeypatch,
                                                          spans):
    reg = obs.MetricsRegistry() if spans is None else registry(spans)
    assert read_all(monkeypatch, reg) == dict.fromkeys(READERS)


@pytest.mark.parametrize("workload,kind,names", [
    ("full.infer.b8192", "infer",
     ["serve.h2d_ms.infer", "serve.net_ms.infer"]),
    ("large.train.b1024", "train", ["loader.sample_ms.train"])])
def test_a_traced_cpu_run_reports_the_span_metrics(workload, kind, names):
    line = harness.run(["--workload", workload, "--seed", "2147483713",
                        "--seconds", "0.3", "--trace", "1"],
                       time.perf_counter(), device="cpu",
                       overrides=tiny(kind))
    assert line["correct"], line["checks"]
    for name in names:
        assert line["metrics"][name]["value"] > 0.0, name
        assert line["metrics"][name]["unit"] == "ms"
