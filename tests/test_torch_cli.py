"""The port's command line (``deepgo_tpu_torch/cli.py``), HTTP exporter,
plot, warm restart and entry module against the JAX package's, on the CPU.

Both command lines run in-process (the JAX one on a private metrics
registry). Bars:

* parser: every JAX subcommand and option string exists in the port with
  the same default, choices, nargs and type; the port adds ``--device``
  (default ``cuda``) to the subcommands that build a net or a step, and
  nothing else. ``parse_overrides`` gives the same values and errors.
* ``train --resume`` of one JAX-written float32 checkpoint (3 x 16 on the
  bundled ``data/sgf`` splits), 20 steps through both command lines: EWMA
  and params within 1e-5; ``eval`` of one checkpoint: NLL within 1e-5
  relative and the same correct count.
* pure-host subcommands (``obs``, ``trace``, ``trend``, ``dash --once
  --json``, ``workload analyze``, ``chaos report``): equal output on the
  same inputs; ``cost`` at a small config: the same (fn, bucket) rows,
  FLOPs within the 5 % band of tests/test_costmodel.py.
* the exporter: the JAX routes, status codes and payload keys; plot: the
  CSV byte-equal; ``entry``: float32 within 1e-4 of JAX, bf16 within the
  ROADMAP bar (drift <= 0.5, margin-gated top-1 1.0 on >= 32 rows).
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import REPO_ROOT
from deepgo_tpu import cli as jax_cli
from deepgo_tpu.experiments import plot as jax_plot
from deepgo_tpu.experiments import repeated as jax_repeated
from deepgo_tpu.experiments.experiment import Experiment as JaxExperiment
from deepgo_tpu.experiments.experiment import \
    ExperimentConfig as JaxExperimentConfig
from deepgo_tpu.models import policy_cnn as jax_policy
from deepgo_tpu.obs import exporter as jax_exporter
from deepgo_tpu.ops import expand_planes as jax_expand
from deepgo_tpu.obs import registry as jax_registry

from deepgo_tpu_torch import cli, graft_entry
from deepgo_tpu_torch.data.transcribe import transcribe_split
from deepgo_tpu_torch.experiments import checkpoint as ckpt
from deepgo_tpu_torch.experiments import plot, repeated
from deepgo_tpu_torch.experiments.experiment import Experiment
from deepgo_tpu_torch.models import convert, policy_cnn
from deepgo_tpu_torch.obs import exporter
from deepgo_tpu_torch.obs.registry import MetricsRegistry

torch.set_num_threads(2)

TOL = 1e-5          # EWMA, params (max-abs) and eval NLL (relative)
FLOP_BAND = 0.05    # tests/test_costmodel.py's band
F32_TOL = 1e-4
DRIFT_CAP, PROB_FLOOR = 0.5, 1e-3
MARGIN, MIN_DECIDED_ROWS = 0.05, 32
NET_SUBCOMMANDS = {("train",), ("eval",), ("localtest",), ("serve",),
                   ("loop",), ("cost",), ("workload", "record"),
                   ("workload", "replay"), ("chaos", "run")}


@pytest.fixture(scope="module", autouse=True)
def private_jax_registry():
    """The JAX package's calls here count into a registry of their own:
    tests/test_attribution.py holds the process-wide train-step total."""
    saved = jax_registry._default
    jax_registry._default = jax_registry.MetricsRegistry()
    yield
    jax_registry._default = saved


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("processed")
    for split in ("validation", "test"):
        transcribe_split(os.path.join(REPO_ROOT, "data/sgf", split),
                         str(root / split), workers=1, verbose=False)
    return str(root)


def tiny(data_root, run_dir, **kw):
    """tests/test_torch_experiment.py's 3 x 16 float32 config."""
    return dict(dict(
        name="test", num_layers=3, channels=16, compute_dtype="float32",
        batch_size=8, rate=0.05, validation_size=32, validation_interval=10,
        print_interval=10, data_root=data_root, train_split="validation",
        validation_split="test", test_split="test", loader_threads=0,
        data_parallel=1, cost_ledger=False, run_dir=str(run_dir)), **kw)


def run_main(main, argv) -> tuple[str, int]:
    """(stdout, exit code) of one in-process command line; a
    ``SystemExit`` message joins the output."""
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
            if not isinstance(e.code, int) and e.code is not None:
                out.write(str(e.code))
    return out.getvalue(), code


# ---- the parser ----


class _Captured(Exception):
    def __init__(self, parser):
        super().__init__("parser captured")
        self.parser = parser


def capture_parser(main):
    def grab(self, args=None, namespace=None):
        raise _Captured(self)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        try:
            main(["trend"])
        except _Captured as c:
            return c.parser
    raise AssertionError("the command line never parsed")


def parser_options(parser, prefix=()) -> dict:
    """{(subcommand..., option): its contract} over every (sub)parser;
    ``(subcommand...,)`` itself maps to None."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[prefix + (name,)] = None
                out.update(parser_options(sub, prefix + (name,)))
        elif not isinstance(action, argparse._HelpAction):
            key = (action.option_strings[0] if action.option_strings
                   else action.dest)
            out[prefix + (key,)] = (
                tuple(action.option_strings), action.dest, action.default,
                None if action.choices is None else list(action.choices),
                action.nargs, action.required, type(action).__name__,
                getattr(action.type, "__name__", action.type))
    return out


@pytest.fixture(scope="module")
def parsers():
    return (parser_options(capture_parser(cli.main)),
            parser_options(capture_parser(jax_cli.main)))


JAX_KEYS = sorted(k for k in parser_options(capture_parser(jax_cli.main)))


@pytest.mark.parametrize("key", JAX_KEYS, ids=lambda k: " ".join(k))
def test_every_jax_subcommand_and_option_in_the_port(parsers, key):
    port, ref = parsers
    assert key in port
    assert port[key] == ref[key]


def test_the_port_adds_only_device(parsers):
    port, ref = parsers
    extra = sorted(set(port) - set(ref))
    assert extra == sorted(sub + ("--device",) for sub in NET_SUBCOMMANDS)
    for key in extra:
        assert port[key][2] == "cuda"


def test_help_lists_every_jax_subcommand():
    out = subprocess.run(
        [sys.executable, "-m", "deepgo_tpu_torch.cli", "--help"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ("train", "eval", "localtest", "serve", "loop", "cost",
                 "lint", "trace", "obs", "dash", "trend", "workload",
                 "chaos", "selfplay"):
        assert re.search(rf"\b{name}\b", out.stdout), name


OVERRIDES = [
    ["rate=0.5", "num_layers=4", "name=x"],
    ["augment=yes", "zero_opt=0", "elastic=TRUE", "remat=no"],
    ["channel_schedule=8,16", "compute_dtype=float32", "momentum=0.9"],
    ["seed=-3", "rate=1e-3", "faults="],
    ["bogus=1"],
    ["num_layers=four"],
    ["rate=fast"],
    ["name"],
]


@pytest.mark.parametrize("pairs", OVERRIDES, ids=lambda p: " ".join(p))
def test_parse_overrides_like_jax(pairs):
    def outcome(fn):
        try:
            return ("ok", fn(pairs))
        except (SystemExit, ValueError) as e:
            return (type(e).__name__, str(e))

    assert outcome(cli.parse_overrides) == outcome(jax_cli.parse_overrides)


def test_train_on_cuda_raises_without_cuda(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--iters", "1", "--set",
                  f"data_root={data_root}", f"run_dir={tmp_path}"])


# ---- train --resume and eval through both command lines ----


@pytest.fixture(scope="module")
def resumed(data_root, tmp_path_factory):
    """One JAX-written float32 seed checkpoint, 20 steps through each
    command line (the JAX run's directory moved aside before the port's
    writes the same path)."""
    tmp = tmp_path_factory.mktemp("resume")
    runs = tmp / "runs"
    seed = JaxExperiment(JaxExperimentConfig(**tiny(data_root, runs)),
                         run_id="seed")
    seed.init()
    path = seed.save(str(tmp / "seed.npz"))
    out = {"seed": path}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        text, code = run_main(main, ["train", "--resume", path, "--iters",
                                     "20"] + extra)
        assert code == 0, text
        final = re.search(r"checkpoint at (\S+)", text).group(1)
        moved = str(runs / f"seed-{name}")
        os.replace(str(runs / "seed"), moved)
        out[name] = os.path.join(moved, os.path.basename(final))
    return out


def test_train_resume_matches_jax(resumed):
    meta_p, p_p, _ = ckpt.load_checkpoint(resumed["port"])
    meta_j, p_j, _ = ckpt.load_checkpoint(resumed["jax"])
    assert meta_p["step"] == meta_j["step"] == 20
    assert abs(meta_p["ewma"] - meta_j["ewma"]) <= TOL * abs(meta_j["ewma"])
    assert len(p_p) == len(p_j)
    assert max(np.abs(a - b).max() for a, b in zip(p_p, p_j)) <= TOL


def test_eval_matches_jax(resumed):
    results = {}

    def capture(cls, name):
        real = cls.evaluate

        def evaluate(self, *a, **kw):
            results[name] = real(self, *a, **kw)
            return results[name]

        return mock.patch.object(cls, "evaluate", evaluate)

    with capture(JaxExperiment, "jax"):
        text_j, code_j = run_main(jax_cli.main, [
            "eval", "--checkpoint", resumed["jax"], "--split", "test"])
    with capture(Experiment, "port"):
        text_p, code_p = run_main(cli.main, [
            "eval", "--checkpoint", resumed["jax"], "--split", "test",
            "--device", "cpu"])
    assert code_j == code_p == 0
    got, want = results["port"], results["jax"]
    assert got["n"] == want["n"] > 100
    assert abs(got["cost"] - want["cost"]) <= TOL * abs(want["cost"])
    assert round(got["accuracy"] * got["n"]) == \
        round(want["accuracy"] * want["n"])
    assert text_p.split(":")[0] == text_j.split(":")[0] == "test"


def test_warm_restart_main_matches_jax(resumed, tmp_path):
    """``experiments.repeated`` from the same checkpoint, 10 more steps."""
    finals = {}
    for name, main, extra in (("jax", jax_repeated.main, []),
                              ("port", repeated.main, ["--device", "cpu"])):
        text, code = run_main(main, ["--checkpoint", resumed["jax"],
                                     "--iters", "10"] + extra)
        assert code == 0, text
        finals[name] = re.search(r"saved (\S+)", text).group(1)
    meta_p, p_p, _ = ckpt.load_checkpoint(finals["port"])
    meta_j, p_j, _ = ckpt.load_checkpoint(finals["jax"])
    assert meta_p["step"] == meta_j["step"] == 30
    assert meta_p["id"] != "seed" and meta_j["id"] != "seed"
    assert max(np.abs(a - b).max() for a, b in zip(p_p, p_j)) <= TOL


def test_localtest_runs_on_the_cpu(data_root, tmp_path):
    text, code = run_main(cli.main, [
        "localtest", "--iters", "4", "--device", "cpu", "--set",
        f"data_root={data_root}", f"run_dir={tmp_path}", "channels=8",
        "num_layers=2", "train_split=validation", "loader_threads=0",
        "validation_interval=4", "validation_size=16"])
    assert code == 0, text
    assert text.strip().splitlines()[-1].startswith("localtest done")


# ---- pure-host subcommands: equal output on the same inputs ----


@pytest.fixture(scope="module")
def host_inputs(tmp_path_factory):
    """A telemetry run directory (tests/test_torch_obs.py's), a synthetic
    workload capture and a stored chaos report."""
    from deepgo_tpu_torch.serving import replay as rp
    from test_torch_obs import telemetry_run

    root = tmp_path_factory.mktemp("host")
    run_dir = str(root / "run")
    telemetry_run("port", run_dir)
    capture = str(root / "capture")
    rp.write_synthetic_capture(capture, rp.build_synthetic_requests(
        os.path.join(REPO_ROOT, "data/sgf/train"), requests=48, games=4,
        opening_moves=6, seed=3))
    report = str(root / "report.json")
    with open(report, "w") as f:
        json.dump({"scenario": {"name": "brownout", "seed": 0,
                                "events": [{"kind": "slow"}]},
                   "answers": {"checked": 10, "wrong": 0, "lost": 0},
                   "slo": {"tier": "interactive", "good_frac": 0.97,
                           "threshold_s": 0.15, "target": 0.95,
                           "burn": 0.6, "ok": True},
                   "counters": {"failovers": 2},
                   "expects_corruption": False}, f)
    return {"run": run_dir, "capture": capture, "report": report}


HOST_COMMANDS = {
    "obs": ["obs", "{run}"],
    "obs-json": ["obs", "{run}", "--json"],
    "trace-list": ["trace", "{run}"],
    "trace-missing": ["trace", "{run}", "ffff", "--json"],
    "trend": ["trend", "--root", REPO_ROOT],
    "trend-json": ["trend", "--root", REPO_ROOT, "--json"],
    "dash": ["dash", "{run}", "--once", "--json"],
    "workload-analyze": ["workload", "analyze", "{capture}"],
    "workload-analyze-json": ["workload", "analyze", "{capture}", "--json",
                              "--simulate-cache", "4,16"],
    "chaos-report": ["chaos", "report", "{report}"],
    "chaos-report-json": ["chaos", "report", "{report}", "--json"],
}


@pytest.mark.parametrize("name", sorted(HOST_COMMANDS))
def test_host_subcommand_output_like_jax(host_inputs, name):
    argv = [a.format(**host_inputs) for a in HOST_COMMANDS[name]]
    got = run_main(cli.main, argv)
    want = run_main(jax_cli.main, argv)
    if name == "dash":
        # the frame's wall-clock stamp is the one field read from a clock
        got = (json.loads(got[0]), got[1])
        want = (json.loads(want[0]), want[1])
        got[0].pop("time")
        want[0].pop("time")
    if name == "trace-list":
        # the closing hint names where tracing is armed; the JAX one also
        # names its bench, which the port does not have
        hint = "was tracing armed?"
        assert hint in got[0] and hint in want[0]
        got = (got[0].split(hint)[0], got[1])
        want = (want[0].split(hint)[0], want[1])
    assert got == want
    assert got[0]


# ---- cost ----


def test_cost_rows_match_jax_at_a_small_config():
    argv = ["cost", "--model", "small", "--buckets", "1,8", "--train-batch",
            "8", "--sym-bucket", "8", "--json"]
    got_text, code = run_main(cli.main, argv + ["--device", "cpu"])
    want_text, jcode = run_main(jax_cli.main, argv)
    assert code == jcode == 0
    got = json.loads(got_text)["entries"]
    want = json.loads(want_text)["entries"]
    assert sorted(got) == sorted(want)
    assert set(got) == {f"{fn}/b{b}" for fn in ("policy_forward",
                                                 "quant_forward")
                        for b in (1, 8)} | {
        f"{fn}/b8" for fn in ("sym_policy_forward", "fused_sym_forward",
                              "fused_sym_int8_forward", "train_step",
                              "eval_step")}
    for key in got:
        assert got[key]["source"] == "flop_counter", key
        assert abs(got[key]["flops"] - want[key]["flops"]) \
            <= FLOP_BAND * want[key]["flops"], key


# ---- the exporter ----


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def exporter_transcript(pkg) -> dict:
    """Every route of one package's exporter over equal registries and
    health callables: status codes, /metrics text, and payload keys."""
    mod = {"port": exporter, "jax": jax_exporter}[pkg]
    reg = (MetricsRegistry() if pkg == "port"
           else jax_registry.MetricsRegistry())
    reg.counter("deepgo_train_steps_total", "steps").inc(3)
    reg.gauge("deepgo_fleet_replicas_serving", "up").set(2, fleet="f")
    reg.histogram("deepgo_serving_dispatch_seconds", "d").observe(
        0.01, engine="e", bucket=8)
    healthy = {"v": True}
    out = {}
    with mod.ObsExporter(port=0, registry=reg) as exp:
        exp.add_health("train", lambda: {"healthy": healthy["v"], "step": 3})
        exp.add_health("slo", lambda: {"healthy": True, "degraded": True})
        status, body = _get(exp.url + "/metrics")
        out["metrics"] = (status, body)
        status, body = _get(exp.url + "/healthz")
        payload = json.loads(body)
        payload.pop("time")
        out["healthz"] = (status, payload)
        healthy["v"] = False
        status, body = _get(exp.url + "/healthz")
        payload = json.loads(body)
        payload.pop("time")
        out["healthz_down"] = (status, payload)
        exp.add_health("dying", lambda: 1 / 0)
        status, body = _get(exp.url + "/healthz")
        out["healthz_raise"] = (status, sorted(
            json.loads(body)["components"]["dying"]))
        for route in ("/trace", "/cost", "/series", "/series?metric=x&n=2"):
            status, body = _get(exp.url + route)
            out[route] = (status, sorted(json.loads(body)))
        out["404"] = _get(exp.url + "/nope")
    out["closed"] = exp._closed
    return out


def test_exporter_routes_like_jax():
    got, want = exporter_transcript("port"), exporter_transcript("jax")
    assert got == want
    assert got["healthz"][0] == 200 and got["healthz_down"][0] == 503
    assert got["healthz"][1]["degraded"] is True
    assert "deepgo_train_steps_total 3" in got["metrics"][1]


def test_exporter_cost_trace_series_payloads_like_jax(tmp_path):
    """/cost, /trace and /series with a ledger, a recorder and a live
    store installed: the JAX payload keys."""
    from deepgo_tpu.obs import costmodel as jax_costmodel
    from deepgo_tpu.obs import timeseries as jax_timeseries
    from deepgo_tpu.obs import tracing as jax_tracing
    from deepgo_tpu_torch.obs import costmodel, timeseries, tracing

    def transcript(pkg):
        cm, ts, tr, mod = ((costmodel, timeseries, tracing, exporter)
                           if pkg == "port" else
                           (jax_costmodel, jax_timeseries, jax_tracing,
                            jax_exporter))
        reg = (MetricsRegistry() if pkg == "port"
               else jax_registry.MetricsRegistry())
        ledger = (cm.CostLedger(registry=reg, device="cpu") if pkg == "port"
                  else cm.CostLedger(registry=reg))
        ledger.add(cm.CostEntry(
            fn="train_step", bucket=8, flops=1e9, bytes_accessed=None,
            hbm_peak_bytes=None, hbm_argument_bytes=None,
            hbm_output_bytes=None, hbm_temp_bytes=None,
            compile_seconds=0.1, source="flop_counter", platform="cpu"))
        store = ts.TimeSeriesStore(str(tmp_path / pkg), registry=reg)
        store.append({"deepgo_x": 1.0}, t=1.0)
        store.append({"deepgo_x": 2.0}, t=2.0)
        cm.set_cost_ledger(ledger)
        ts.set_live_store(store)
        tr.configure_tracing(str(tmp_path / pkg / "trace.jsonl"))
        try:
            out = {}
            with mod.ObsExporter(port=0, registry=reg) as exp:
                for route in ("/cost", "/trace", "/series",
                              "/series?metric=deepgo_x&n=5"):
                    status, body = _get(exp.url + route)
                    payload = json.loads(body)
                    out[route] = (status, sorted(payload), {
                        k: sorted(v) if isinstance(v, dict) else type(v)
                        for k, v in payload.items()})
            return out
        finally:
            cm.set_cost_ledger(None)
            ts.set_live_store(None)
            tr.disable_tracing()
            store.close()

    got, want = transcript("port"), transcript("jax")
    assert got == want
    assert got["/cost"][1] == ["enabled", "ledger"]
    assert got["/series?metric=deepgo_x&n=5"][1] == ["enabled", "metric",
                                                      "series"]


# ---- plot ----


def test_plot_csv_byte_equal_to_jax(resumed, tmp_path):
    runs = [os.path.dirname(resumed["port"]),
            os.path.dirname(resumed["jax"]), resumed["jax"]]
    outs = {}
    for name, main in (("port", plot.main), ("jax", jax_plot.main)):
        text, code = run_main(main, runs + ["--out",
                                            str(tmp_path / name / "c")])
        assert code == 0, text
        with open(tmp_path / name / "c.csv", "rb") as f:
            outs[name] = f.read()
    assert outs["port"] == outs["jax"]
    assert outs["port"].count(b"\n") > 3


# ---- the entry module ----


@pytest.fixture(scope="module")
def jax_entry():
    import __graft_entry__

    fn, args = __graft_entry__._entry()
    tree = jax.tree.map(np.asarray, args[0])
    return fn, tree, tuple(np.asarray(a) for a in args[1:])


def port_config(name, **overrides):
    return dataclasses.replace(policy_cnn.CONFIGS[name], **overrides)


def test_entry_shapes_and_args_like_jax(jax_entry):
    _, _, (packed, player, rank) = jax_entry
    fn, args = graft_entry.make_entry(policy_cnn.CONFIGS["full"], "cpu")
    assert args[0].cfg == policy_cnn.CONFIGS["full"]
    for got, want in zip(args[1:], (packed, player, rank)):
        assert np.array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype


def test_entry_float32_matches_jax(jax_entry):
    jfn, tree, (packed, player, rank) = jax_entry
    n = 8
    jcfg = dataclasses.replace(jax_policy.CONFIGS["full"],
                               compute_dtype="float32")
    want = np.asarray(jax.jit(lambda p, x, y, z: jax_policy.log_policy(
        p, jax_expand(x, y, z, dtype=jnp.float32), jcfg))(
            jax.tree.map(jnp.asarray, tree), packed[:n], player[:n],
            rank[:n]))
    cfg = port_config("full", compute_dtype="float32")
    fn, args = graft_entry.make_entry(cfg, "cpu")
    model = convert.model_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        got = fn(model, *(a[:n] for a in args[1:])).numpy()
    assert got.shape == (n, 361)
    assert np.abs(got - want).max() <= F32_TOL


def test_entry_bfloat16_meets_the_bar(jax_entry):
    """The entry's own bf16 forward against the JAX float32 reference on
    its first 8 boards, and on more boards drawn the same way until 32
    rows clear the margin gate."""
    _, tree, (packed, player, rank) = jax_entry
    jcfg = dataclasses.replace(jax_policy.CONFIGS["full"],
                               compute_dtype="float32")
    ref_fn = jax.jit(lambda p, x, y, z: jax_policy.log_policy(
        p, jax_expand(x, y, z, dtype=jnp.float32), jcfg))
    params = jax.tree.map(jnp.asarray, tree)
    fn, _ = graft_entry.make_entry(policy_cnn.CONFIGS["full"], "cpu",
                                   batch=1)
    model = convert.model_from_jax(tree, policy_cnn.CONFIGS["full"],
                                   device="cpu")
    rng = np.random.default_rng(1)
    chunks = [(packed[:8], player[:8], rank[:8])]
    refs, gots = [], []
    while True:
        x, y, z = chunks[-1]
        refs.append(np.asarray(ref_fn(params, x, y, z)))
        with torch.no_grad():
            gots.append(fn(model, *(torch.from_numpy(a) for a in
                                    (x, y, z))).numpy())
        ref, got = np.concatenate(refs), np.concatenate(gots)
        top2 = np.sort(ref, axis=1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] >= MARGIN
        if decided.sum() >= MIN_DECIDED_ROWS:
            break
        chunks.append((rng.integers(0, 3, size=(64, 9, 19, 19),
                                    dtype=np.uint8),
                       rng.integers(1, 3, size=64).astype(np.int32),
                       rng.integers(1, 10, size=64).astype(np.int32)))
    assert np.isfinite(got).all()
    assert np.abs(got - ref)[np.exp(ref) >= PROB_FLOOR].max() <= DRIFT_CAP
    assert np.array_equal(got.argmax(1)[decided], ref.argmax(1)[decided])


def test_entry_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()


# The dry run trains the JAX dry run's bf16 config. Its 2 x 2 losses
# differ from one unsharded model's by up to 8.4e-4 after the first step:
# the input gradients of a sharded layer are summed over the model group
# from bf16 partials (2^-8 relative) that a single device never rounds.
# Gradients taken over one data rank's half batch only, or a Megatron copy
# whose backward skips its all-reduce, move them by 7e-2 or more.
DRYRUN_FIRST_LOSS_TOL = 1e-5
DRYRUN_LOSS_TOL = 2e-3


def test_dryrun_multichip_on_four_gloo_ranks():
    """The 2 x 2 dry run's losses, step by step, against the same steps of
    one unsharded model from the same init on the same global batch: a
    wrong shard of a layer or a gradient averaged over the wrong group
    moves them."""
    from deepgo_tpu_torch.training import make_train_step, sgd

    records = graft_entry.dryrun_multichip(4, device="cpu")
    assert [r["rank"] for r in records] == [0, 1, 2, 3]
    assert {(r["data"], r["model"]) for r in records} == {(2, 2)}
    losses = [r["losses"] for r in records]
    assert all(x == losses[0] for x in losses)  # one program, one loss
    assert losses[0][-1] < losses[0][1]

    cfg = graft_entry.DRYRUN_CONFIG
    optimizer = sgd(0.01, rate_decay=1e-7)
    model = policy_cnn.init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    state = optimizer.init(model)
    step = make_train_step(cfg, optimizer)
    batch = {k: torch.from_numpy(v)
             for k, v in graft_entry.dryrun_batch(4).items()}
    want = []
    for _ in range(1 + graft_entry.DRYRUN_STEPS):
        model, state, loss = step(model, state, batch)
        want.append(float(loss))
    got = np.asarray(losses[0])
    # the first step's loss is the forward through every sharded layer
    assert abs(got[0] - want[0]) <= DRYRUN_FIRST_LOSS_TOL, (got, want)
    # later steps also carry the averaged gradients, rounded in bf16
    assert np.abs(got - np.asarray(want)).max() <= DRYRUN_LOSS_TOL, (
        got, want)


# ---- serve and selfplay, in-process on the CPU ----


def test_serve_reloads_a_watched_checkpoint_and_restores_signals(
        resumed, tmp_path):
    """``serve`` over a 3 x 16 checkpoint: /healthz answers 200 while it
    serves, a checkpoint published atomically at ``--watch`` is
    hot-reloaded once, and SIGINT / SIGTERM get their handlers back."""
    import shutil
    import signal
    import time

    from deepgo_tpu_torch.obs import get_registry

    target = str(tmp_path / "champion.npz")
    before = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                               signal.SIGTERM)}
    reloads = get_registry().counter("deepgo_fleet_reloads_total")
    n0 = sum(reloads.collect().values())
    seen = {}

    def publish():
        url = None
        while url is None:
            m = re.search(r"at (http://\S+)", out.getvalue())
            url = m.group(1) if m else None
            time.sleep(0.05)
        seen["healthz"] = _get(url + "/healthz")[0]
        shutil.copy(resumed["port"], target + ".tmp")
        os.replace(target + ".tmp", target)

    out = io.StringIO()
    t = threading.Thread(target=publish, name="test-publish", daemon=True)
    with contextlib.redirect_stdout(out):
        t.start()
        cli.main(["serve", "--fleet", "1", "--checkpoint", resumed["seed"],
                  "--device", "cpu", "--duration", "4", "--watch", target,
                  "--watch-interval", "0.2", "--max-wait-ms", "1"])
    t.join(timeout=10)
    text = out.getvalue()
    assert seen["healthz"] == 200
    assert f"hot-reloaded {target}" in text, text
    assert "1 reloads" in text
    assert sum(reloads.collect().values()) - n0 == 1
    assert {s: signal.getsignal(s) for s in before} == before


def test_selfplay_is_forwarded(tmp_path):
    text, code = run_main(cli.main, [
        "selfplay", "--games", "2", "--max-moves", "6", "--device", "cpu",
        "--sgf-out", str(tmp_path)])
    assert code == 0, text
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".sgf")]) == 2
