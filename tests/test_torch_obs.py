"""The port's observability layer (``deepgo_tpu_torch/obs``) against the
JAX package's, on the CPU.

Every module here is a copy or an adapter, so the bar is equality: the same
operations on a fake clock give exactly equal outputs in both packages.

* attribution: ``attribute_snapshot`` of one synthetic registry, and
  ``attribute_run`` / ``format_attribution`` of run directories written
  by the JAX package (single host and elastic);
* the run report: ``summarize_run`` / ``format_report`` of one run
  directory with every stream the report reads;
* SLO verdicts and burn events; time-series chunk files (record for
  record but the sink's wall-clock stamp, through roll and power-of-two
  retention) and ``key_matches``; anomaly
  findings; the federated view; the dash's ``--json`` dict and frame;
* a port CPU dryrun (2 x 8, B = 8, 30 steps) attributes >= 0.95 of its
  wall with steps = 30 and the JAX package's buckets, and carries its cost
  ledger's roofline; a ledger that cannot price the step never blocks
  training.
"""

import json
import os
import random
from types import SimpleNamespace

import pytest
import torch

from conftest import REPO_ROOT
from deepgo_tpu.obs import anomaly as jax_anomaly
from deepgo_tpu.obs import attribution as jax_attribution
from deepgo_tpu.obs import dash as jax_dash
from deepgo_tpu.obs import exporter as jax_exporter
from deepgo_tpu.obs import federate as jax_federate
from deepgo_tpu.obs import registry as jax_registry
from deepgo_tpu.obs import report as jax_report
from deepgo_tpu.obs import slo as jax_slo
from deepgo_tpu.obs import timeseries as jax_timeseries

from deepgo_tpu_torch.data.transcribe import transcribe_split
from deepgo_tpu_torch.experiments.experiment import (Experiment,
                                                     ExperimentConfig)
from deepgo_tpu_torch.obs import (anomaly, attribution, costmodel, dash,
                                  exporter, federate, registry, report,
                                  slo, timeseries)
from deepgo_tpu_torch.obs.sentinel import get_flight_recorder

torch.set_num_threads(2)

PKGS = {
    "jax": SimpleNamespace(
        registry=jax_registry, attribution=jax_attribution,
        report=jax_report, slo=jax_slo, timeseries=jax_timeseries,
        anomaly=jax_anomaly, federate=jax_federate, dash=jax_dash,
        exporter=jax_exporter),
    "port": SimpleNamespace(
        registry=registry, attribution=attribution, report=report,
        slo=slo, timeseries=timeseries, anomaly=anomaly,
        federate=federate, dash=dash, exporter=exporter),
}
ATTRIBUTION_BAR = 0.95


@pytest.fixture(scope="module", autouse=True)
def private_jax_registry():
    """The JAX package's calls in this file count into a metrics registry
    of their own. Its process-wide one feeds the ``obs_snapshot`` of every
    later JAX run in this worker, and tests/test_attribution.py holds its
    run's train-step total to its own 30 steps."""
    saved = jax_registry._default
    jax_registry._default = jax_registry.MetricsRegistry()
    yield
    jax_registry._default = saved


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


# ---------------------------------------------------------------------------
# attribution


def fill_train_registry(reg, case: str):
    """A train loop's attribution metrics, as the experiment feeds them."""
    if case == "empty":
        return reg
    reg.counter("deepgo_train_wall_seconds_total").inc(12.5)
    reg.counter("deepgo_train_steps_total").inc(30)
    reg.counter("deepgo_train_samples_total").inc(240)
    wait = reg.histogram("deepgo_loader_wait_seconds")
    h2d = reg.histogram("deepgo_h2d_seconds")
    dispatch = reg.histogram("deepgo_train_dispatch_seconds")
    span = reg.histogram("deepgo_span_seconds")
    for i in range(30):
        wait.observe(0.05 + 0.001 * i)
        h2d.observe(0.002, path="inline")
        dispatch.observe(0.2, phase="steady")
    dispatch.observe(3.0, phase="first")
    reg.histogram("deepgo_train_fetch_seconds").observe(1.5)
    reg.histogram("deepgo_train_hook_seconds").observe(0.01)
    span.observe(0.3, name="validate", status="ok")
    span.observe(0.2, name="checkpoint_save", status="ok")
    if case == "uploader":
        h2d.observe(0.4, path="uploader")
        reg.histogram("deepgo_collective_seconds").observe(0.25)
    if case == "roofline":
        reg.gauge("deepgo_cost_flops").set(2.5e9, fn="train_step",
                                           bucket=8)
        reg.gauge("deepgo_cost_peak_flops_per_sec").set(
            5e11, platform="cpu", source="estimated")
        reg.gauge("deepgo_cost_peak_hbm_bytes_per_sec").set(
            2.4e10, platform="cpu", source="estimated")
        reg.gauge("deepgo_cost_hbm_peak_bytes").set(1e8, fn="train_step",
                                                    bucket=8)
    return reg


@pytest.mark.parametrize("case", ["plain", "uploader", "roofline",
                                  "empty"])
def test_attribute_snapshot_like_jax(case):
    out = {name: p.attribution.attribute_snapshot(
               fill_train_registry(p.registry.MetricsRegistry(), case)
               .snapshot()["metrics"])
           for name, p in PKGS.items()}
    assert out["port"] == out["jax"]
    assert (out["port"] is None) == (case == "empty")


def write_jax_run(run_dir, hosts: int):
    """A run directory the JAX package wrote: one metrics.jsonl, or one
    elastic stream per host, each ending in an ``obs_snapshot``."""
    os.makedirs(run_dir, exist_ok=True)
    for h in range(hosts):
        reg = fill_train_registry(jax_registry.MetricsRegistry(),
                                  "roofline" if h else "plain")
        reg.counter("deepgo_train_wall_seconds_total").inc(h)
        name = (f"elastic-{h:04d}.jsonl" if hosts > 1 else "metrics.jsonl")
        with jax_exporter.JsonlSink(os.path.join(run_dir, name)) as sink:
            sink.write("train", step=10, loss=2.0, ewma=2.1,
                       samples_per_sec=100.0 + h)
            sink.write("obs_snapshot", host=h,
                       metrics=reg.snapshot()["metrics"])
    return str(run_dir)


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_attribute_run_of_a_jax_written_run_like_jax(hosts, tmp_path):
    run = write_jax_run(tmp_path / "run", hosts)
    got = attribution.attribute_run(run)
    assert got == jax_attribution.attribute_run(run)
    assert got["num_hosts"] == hosts
    assert attribution.format_attribution(got) == \
        jax_attribution.format_attribution(got)


def test_attribute_run_of_nothing_is_none(tmp_path):
    assert attribution.attribute_run(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# the telemetry plane: store, detector, SLO tracker, federation, dash


def telemetry_run(pkg, run_dir, clock=None):
    """A run directory with every stream the report and the dash read,
    written by ``pkg`` on a fake clock: train and validation records, a
    cost_ledger event, spans, SLO burns, a time-series store and its
    anomaly events, and the close-time snapshot."""
    p = PKGS[pkg]
    clock = clock or FakeClock()
    os.makedirs(run_dir, exist_ok=True)
    reg = fill_train_registry(p.registry.MetricsRegistry(clock=clock),
                              "roofline")
    sink = p.exporter.JsonlSink(os.path.join(run_dir, "metrics.jsonl"))
    trace = p.exporter.JsonlSink(os.path.join(run_dir, "trace.jsonl"))
    store = p.timeseries.TimeSeriesStore(run_dir, chunk_samples=8,
                                         max_chunks=3, clock=clock,
                                         registry=reg)
    det = p.anomaly.AnomalyDetector(sink=sink, registry=reg, store=store,
                                    flight=False, clock=clock)
    sampler = p.timeseries.TelemetrySampler(
        store, registry=reg, interval_s=1.0, clock=clock,
        listeners=[det.observe], flight_tick=False)
    ok = {"v": True}
    tracker = p.slo.SloTracker(
        [p.slo.HealthObjective("avail", lambda: ok["v"], target=0.99),
         p.slo.HistogramLatencyObjective(
             "dispatch", "deepgo_serving_dispatch_seconds", 0.05,
             registry=reg)],
        config=p.slo.SLOConfig(fast_window_s=6.0, slow_window_s=30.0,
                               fast_burn=10.0, slow_burn=6.0),
        registry=reg, sink=sink, clock=clock)
    sps = reg.gauge("deepgo_train_samples_per_sec")
    serving = reg.gauge("deepgo_fleet_replicas_serving")
    state = reg.gauge("deepgo_fleet_replica_state")
    failovers = reg.counter("deepgo_fleet_failovers_total")
    lat = reg.histogram("deepgo_serving_dispatch_seconds")
    rnd = random.Random(11)
    serving.set(2, fleet="f")
    verdicts = []
    for i in range(40):
        sps.set(1000.0 + rnd.gauss(0, 4) if i < 30 else 450.0)
        lat.observe(0.01 if i % 7 else 0.2, engine="f-0", bucket=8)
        for r in range(2):
            state.set(1.0 if (r, i >= 25) != (1, True) else 0.0,
                      fleet="f", replica=str(r))
        if i == 20:
            failovers.inc(1, fleet="f")
        ok["v"] = not 12 <= i < 15
        clock.advance(1.0)
        sampler.sample_once()
        verdicts.append(tracker.evaluate())
        if i % 10 == 0:
            sink.write("train", step=i, loss=3.0 - 0.01 * i, ewma=3.0,
                       samples_per_sec=1000.0)
            trace.write("obs_span", name="validate", span_id=f"s{i}",
                        parent_id=None, t_start=clock(),
                        duration_s=0.1 + 0.001 * i, status="ok", step=i)
    sink.write("validation", step=40, cost=2.5, accuracy=0.1, n=16)
    sink.write("cost_ledger", version=1, device_kind="cpu", fn="train_step",
               bucket=8, flops=2.5e9, bytes_accessed=None,
               hbm_peak_bytes=None, hbm_argument_bytes=None,
               hbm_output_bytes=None, hbm_temp_bytes=None,
               compile_seconds=0.5, source="flop_counter", platform="cpu",
               arithmetic_intensity=None)
    sink.write("obs_snapshot", metrics=reg.snapshot()["metrics"])
    store.close()
    sink.close()
    trace.close()
    return {"verdicts": verdicts,
            "anomalies": [a.to_dict() for a in det.anomalies],
            "summary": det.summary(),
            "keys": sorted(store.keys())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("telemetry")
    return {pkg: (str(root / pkg), telemetry_run(pkg, str(root / pkg)))
            for pkg in PKGS}


def test_slo_verdicts_like_jax(runs):
    got, want = runs["port"][1]["verdicts"], runs["jax"][1]["verdicts"]
    assert got == want
    states = {v["avail"]["state"] for v in got}
    assert {"ok", "fast_burn"} <= states


def test_anomaly_findings_like_jax(runs):
    got, want = runs["port"][1], runs["jax"][1]
    assert got["anomalies"] == want["anomalies"]
    assert got["summary"] == want["summary"]
    kinds = {a["detector"] for a in got["anomalies"]}
    assert "step" in kinds and "rate" in kinds


def _records(path):
    """A chunk's records without the sink's wall-clock ``time`` stamp."""
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f if line.strip()]


def test_time_series_chunks_equal(runs):
    dirs = {pkg: d for pkg, (d, _) in runs.items()}
    names = {pkg: [os.path.basename(p)
                   for p in timeseries.chunk_paths(d)]
             for pkg, d in dirs.items()}
    assert names["port"] == names["jax"]
    assert len(names["port"]) == 3  # rolled and retained
    for name in names["port"]:
        assert _records(os.path.join(dirs["port"], name)) == \
            _records(os.path.join(dirs["jax"], name)), name
    assert timeseries.load_samples(dirs["jax"]) == \
        jax_timeseries.load_samples(dirs["jax"])
    assert runs["port"][1]["keys"] == runs["jax"][1]["keys"]


def test_key_matches_like_jax(runs):
    keys = runs["port"][1]["keys"] + [
        "deepgo_fleet_replica_state{fleet=f,replica=1}",
        "deepgo_serving_dispatch_seconds{bucket=8,engine=f-0}:p99",
        "deepgo_x{a=b:c}", "deepgo_xy", "deepgo_x"]
    metrics = ["deepgo_fleet_replica_state", "deepgo_serving_dispatch_seconds",
               "deepgo_serving_dispatch_seconds:p99", "deepgo_x",
               "deepgo_x{a=b:c}", "deepgo_train_samples_per_sec"]
    for m in metrics:
        for k in keys:
            assert timeseries.key_matches(m, k) == \
                jax_timeseries.key_matches(m, k), (m, k)
            assert timeseries.split_key(k) == jax_timeseries.split_key(k)


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_run_report_like_jax(runs, writer):
    run_dir = runs[writer][0]
    got = report.summarize_run(run_dir)
    want = jax_report.summarize_run(run_dir)
    assert got == want
    assert report.format_report(got) == jax_report.format_report(want)
    assert "step-time attribution" in report.format_report(got)


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_dash_json_like_jax(runs, writer):
    run_dir = runs[writer][0]
    got = dash.collect_dash(run_dir)
    want = jax_dash.collect_dash(run_dir)
    # the frame's wall-clock stamp is the only field read from the clock
    got.pop("time", None)
    want.pop("time", None)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got["mode"] == "store" and got["samples"] > 0
    assert dash.render_dash(dict(got, time=0.0)) == \
        jax_dash.render_dash(dict(want, time=0.0))


def test_federated_view_like_jax(runs):
    out = {}
    for pkg, p in PKGS.items():
        reg = fill_train_registry(p.registry.MetricsRegistry(), "uploader")
        text = p.exporter.render_prometheus(reg)
        assert p.federate.parse_prometheus(text) == \
            PKGS["jax"].federate.parse_prometheus(text)

        def dead():
            raise ConnectionError("endpoint down")

        view = p.federate.FederatedView(registry=p.registry.MetricsRegistry(),
                                        clock=FakeClock())
        view.add_getter("live", lambda t=text: p.federate.parse_prometheus(t))
        view.add_store("jax-run", runs["jax"][0])
        view.add_store("port-run", runs["port"][0])
        view.add_getter("dead", dead)
        out[pkg] = view.collect()
    assert out["port"] == out["jax"]
    assert out["port"]["hosts"]["dead"]["ok"] is False
    assert out["port"]["hosts"]["live"]["ok"] is True


def test_prometheus_text_like_jax():
    texts = [PKGS[pkg].exporter.render_prometheus(
        fill_train_registry(PKGS[pkg].registry.MetricsRegistry(),
                            "roofline")) for pkg in ("port", "jax")]
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# a port dryrun: the attribution bar, spans and the cost ledger


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("processed")
    for split in ("validation", "test"):
        transcribe_split(os.path.join(REPO_ROOT, "data/sgf", split),
                         str(root / split), workers=1, verbose=False)
    return str(root)


@pytest.fixture(scope="module")
def private_port_registry():
    """The port's dryrun counts into a registry of its own: other port
    Experiments in this worker would otherwise add their steps to its
    close-time snapshot."""
    saved = registry._default
    registry._default = registry.MetricsRegistry()
    yield registry._default
    registry._default = saved


@pytest.fixture(scope="module")
def dryrun(data_root, tmp_path_factory, private_port_registry):
    cfg = ExperimentConfig(
        name="attribution-dryrun", num_layers=2, channels=8, batch_size=8,
        validation_size=16, validation_interval=10, print_interval=5,
        data_root=data_root, train_split="validation",
        validation_split="test", loader_threads=0, data_parallel=1,
        run_dir=str(tmp_path_factory.mktemp("runs")))
    exp = Experiment(cfg, device="cpu")
    exp.run(30)
    return exp.run_path


def test_port_dryrun_attributes_95_percent_of_wall(dryrun):
    att = attribution.attribute_run(dryrun)
    host = att["hosts"]["0"]
    assert host["attributed_fraction"] >= ATTRIBUTION_BAR, host
    assert abs(host["residual_fraction"]) <= 1 - ATTRIBUTION_BAR
    assert host["steps"] == 30
    for bucket in ("loader_wait", "compile", "dispatch", "validate",
                   "checkpoint"):
        assert bucket in host["buckets"], host["buckets"].keys()
    # the JAX package reads the port's run alike
    assert jax_attribution.attribute_run(dryrun) == att


def test_port_dryrun_carries_its_cost_ledger(dryrun):
    roof = attribution.attribute_run(dryrun)["hosts"]["0"]["roofline"]
    assert roof["flops_per_step"] > 0 and 0 < roof["mfu"]
    events = [r for r in exporter.read_events(
        os.path.join(dryrun, "metrics.jsonl")) if r["kind"] == "cost_ledger"]
    assert [(e["fn"], e["bucket"], e["source"]) for e in events] == \
        [("train_step", 8, "flop_counter")]
    text = report.format_report(report.summarize_run(dryrun))
    assert "device cost ledger" in text and "roofline: MFU" in text


def test_port_dryrun_streams_spans_and_arms_the_flight_recorder(dryrun):
    spans = [r for r in exporter.read_events(
        os.path.join(dryrun, "trace.jsonl")) if r["kind"] == "obs_span"]
    names = [s["name"] for s in spans]
    assert names.count("validate") == names.count("checkpoint_save") == 3
    assert [s["step"] for s in spans if s["name"] == "validate"] == \
        [10, 20, 30]
    assert get_flight_recorder().enabled


def test_a_ledger_failure_never_blocks_training(data_root, tmp_path,
                                                monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("cannot price")

    monkeypatch.setattr(costmodel, "train_entry", broken)
    exp = Experiment(ExperimentConfig(
        num_layers=2, channels=8, batch_size=8, validation_size=8,
        validation_interval=100, print_interval=5, data_root=data_root,
        train_split="validation", validation_split="test",
        loader_threads=0, run_dir=str(tmp_path)), device="cpu")
    exp.run(5)
    assert exp.step == 5
    assert "cost ledger: skipped" in capsys.readouterr().out
