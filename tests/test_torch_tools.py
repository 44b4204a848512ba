"""The port's net-touching tools (``deepgo_tpu_torch/tools``) against the
JAX package's ``tools/`` scripts on the CPU, on the same inputs: the
bundled ``data/sgf`` transcribed with the port, nets of 3 layers x 16
channels in float32.

* ``symmetry_eval.evaluate`` on one JAX-written checkpoint (a sharp N(0, 4)
  last-layer bias, so top-1 has real margins): plain and sym8 top-1 equal,
  NLL within 1e-4; ``main`` prints the JAX records.
* ``accuracy_curve.run_point``: both tools' ``Experiment`` start from one
  numpy tree (as tests/test_torch_experiment.py's ``port_exp`` /
  ``jax_exp``): the record keys and ``actual_positions`` equal, the test
  NLL within that file's ``EVAL_NLL_TOL``, the EWMA within its
  ``EWMA_RTOL``; budgets already in ``--out`` are skipped.
* ``feed_bench``: the JAX tool's record keys; one steady window at 20 steps
  of 10; ``SystemExit`` below one window.
* ``debug_twoply``: the JAX subclass's stats over two short games.
* every tool that touches a net raises on ``--device cuda`` here.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import accuracy_curve as jax_accuracy_curve
import debug_twoply as jax_debug_twoply
import feed_bench as jax_feed_bench
import symmetry_eval as jax_symmetry_eval
from conftest import REPO_ROOT
from deepgo_tpu import arena as jax_arena
from deepgo_tpu.experiments.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from deepgo_tpu.experiments.experiment import Experiment as JaxExperiment
from deepgo_tpu.experiments.experiment import \
    ExperimentConfig as JaxExperimentConfig
from deepgo_tpu.models import serving as jax_serving
from deepgo_tpu.obs import registry as jax_registry

from deepgo_tpu_torch import arena
from deepgo_tpu_torch.data.dataset import GoDataset
from deepgo_tpu_torch.data.transcribe import transcribe_split
from deepgo_tpu_torch.experiments.experiment import (Experiment,
                                                     ExperimentConfig)
from deepgo_tpu_torch.models import convert
from deepgo_tpu_torch.models.serving import (load_policy, make_policy_fn,
                                             make_sym_policy_fn)
from deepgo_tpu_torch.tools import (accuracy_curve, debug_twoply,
                                    feed_bench, make_corpus, make_notebook,
                                    make_selfplay_corpus, symmetry_eval)

from test_torch_experiment import EVAL_NLL_TOL, EWMA_RTOL, tiny
from test_torch_policy import numpy_tree

torch.set_num_threads(2)

NET = {"num_layers": 3, "channels": 16, "compute_dtype": "float32"}
NLL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def private_jax_registry():
    """The JAX Experiments here count into a registry of their own (the
    process-wide one feeds later JAX runs' snapshots in this worker)."""
    saved = jax_registry._default
    jax_registry._default = jax_registry.MetricsRegistry()
    yield
    jax_registry._default = saved


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("processed")
    for split in ("train", "validation", "test"):
        transcribe_split(os.path.join(REPO_ROOT, "data/sgf", split),
                         str(root / split), workers=1, verbose=False)
    return str(root)


def sharp_tree(cfg, seed=0):
    """He-normal weights and an N(0, 4) last-layer bias: real top-1
    margins, so float32 rounding between the packages flips no argmax."""
    tree = numpy_tree(cfg, seed=seed)
    last = tree["layers"][-1]
    last["b"] = np.random.default_rng(seed + 1).normal(
        0.0, 4.0, size=last["b"].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """One policy checkpoint written by the JAX package."""
    path = str(tmp_path_factory.mktemp("ckpt") / "policy.npz")
    cfg = ExperimentConfig(**NET).model_config()
    jax_save_checkpoint(path, jax.tree.map(jnp.asarray, sharp_tree(cfg)), {},
                        {"config": dict(NET)})
    return path


# ---- symmetry_eval ----


@pytest.mark.parametrize("mode", ["plain", "sym8"])
def test_symmetry_eval_matches_jax(data_root, checkpoint, mode):
    ds = GoDataset(data_root, "train")
    _, params, cfg = load_policy(checkpoint, device="cpu")
    _, jparams, jcfg = jax_serving.load_policy(checkpoint)
    if mode == "plain":
        fn, jfn = make_policy_fn(cfg, top_k=1, device="cpu"), \
            jax_serving.make_policy_fn(jcfg, top_k=1)
        predict = lambda p, *a: fn(p, *a)["log_probs"]  # noqa: E731
        jpredict = lambda p, *a: jfn(p, *a)["log_probs"]  # noqa: E731
    else:
        predict = make_sym_policy_fn(cfg, device="cpu")
        jpredict = jax_serving.make_sym_policy_fn(jcfg)
    # 300 positions at 64 a batch: the last batch is padded
    got = symmetry_eval.evaluate(predict, params, ds, 64, 300)
    want = jax_symmetry_eval.evaluate(jpredict, jparams, ds, 64, 300)
    assert got.keys() == want.keys()
    assert got["n"] == want["n"] == 300
    assert got["top1"] == want["top1"] > 0
    assert abs(got["nll"] - want["nll"]) <= NLL_TOL


def test_symmetry_eval_main_prints_the_jax_records(data_root, checkpoint,
                                                   tmp_path, capsys):
    argv = ["--checkpoint", checkpoint, "--data-root", data_root,
            "--split", "validation", "--batch", "32"]
    jax_symmetry_eval.main(argv)
    want = [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.startswith("{")]
    out = str(tmp_path / "sym.jsonl")
    symmetry_eval.main([*argv, "--device", "cpu", "--out", out])
    got = [json.loads(line) for line in
           capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [r.keys() for r in got] == [r.keys() for r in want]
    assert [r["mode"] for r in got] == ["plain", "sym8", "delta"]
    for g, w in zip(got[:2], want[:2]):
        assert (g["n"], g["top1"]) == (w["n"], w["top1"])
        assert abs(g["nll"] - w["nll"]) <= NLL_TOL
    assert got[2]["top1_delta"] == want[2]["top1_delta"]
    with open(out) as f:
        assert [json.loads(line) for line in f] == got[:2]


# ---- accuracy_curve ----


def patch_experiments(monkeypatch, tree):
    """Both tools' Experiments start from ``tree``."""
    def port(cfg, device="cuda"):
        exp = Experiment(cfg, run_id="port", device=device)
        exp.model = convert.model_from_jax(tree, cfg.model_config(),
                                           device=device)
        return exp

    def jax_exp(cfg):
        exp = JaxExperiment(cfg, run_id="jax")
        exp.params = jax.tree.map(jnp.asarray, tree)
        return exp

    monkeypatch.setattr(accuracy_curve, "Experiment", port)
    monkeypatch.setattr(jax_accuracy_curve, "Experiment", jax_exp)


@pytest.mark.parametrize("budget", [1000, 10**6])
def test_accuracy_curve_point_matches_jax(data_root, tmp_path, monkeypatch,
                                          budget):
    roots = {}
    for pkg in ("port", "jax"):
        roots[pkg] = str(tmp_path / pkg / "data")
        shutil.copytree(data_root, roots[pkg])
    kw = tiny(None, None, test_split="test", train_split="train",
              scheme="uniform")
    cfg = ExperimentConfig(**{**kw, "data_root": roots["port"],
                              "run_dir": str(tmp_path / "port" / "runs")})
    jcfg = JaxExperimentConfig(**{**kw, "data_root": roots["jax"],
                                  "run_dir": str(tmp_path / "jax" / "runs")})
    tree = numpy_tree(cfg.model_config(), seed=3, bias_scale=0.0)
    patch_experiments(monkeypatch, tree)
    full = len(GoDataset(data_root, "train"))
    got = accuracy_curve.run_point(cfg, budget, 10, roots["port"], full,
                                   device="cpu")
    want = jax_accuracy_curve.run_point(jcfg, budget, 10, roots["jax"],
                                        full)
    assert got.keys() == want.keys()
    assert got["actual_positions"] == want["actual_positions"]
    if budget < full:
        assert full > got["actual_positions"] >= budget
        assert got["actual_positions"] == len(
            GoDataset(roots["port"], f"train_{budget}"))
    else:
        assert got["actual_positions"] == full
    for key in ("budget", "iters", "batch_size"):
        assert got[key] == want[key]
    assert abs(got["test_nll"] - want["test_nll"]) <= EVAL_NLL_TOL
    assert abs(got["final_ewma"] - want["final_ewma"]) <= \
        EWMA_RTOL * abs(want["final_ewma"])
    assert got["last_val"]["n"] == want["last_val"]["n"] == 32


def test_accuracy_curve_skips_recorded_budgets(data_root, tmp_path, capsys):
    out = str(tmp_path / "curve.jsonl")
    record = {"budget": 5, "actual_positions": 5, "test_top1": 0.25,
              "test_nll": 3.5}
    with open(out, "w") as f:
        f.write(json.dumps(record) + "\n")
    accuracy_curve.main(["--data-root", data_root, "--budgets", "5",
                         "--iters", "10", "--out", out, "--device", "cpu",
                         "--set", f"run_dir={tmp_path / 'runs'}"])
    printed = capsys.readouterr().out
    assert "budget 5 already recorded; skipping" in printed
    assert not os.path.exists(tmp_path / "runs")
    with open(str(tmp_path / "curve.csv")) as f:
        assert f.read() == "positions,test_top1,test_nll\n5,0.2500,3.5000\n"


def test_plot_curve_writes_a_png_and_none_without_matplotlib(tmp_path,
                                                             monkeypatch):
    out = str(tmp_path / "curve.jsonl")
    with open(out, "w") as f:
        for n, top1 in ((4000, 0.3), (40000, 0.4)):
            f.write(json.dumps({"actual_positions": n, "test_top1": top1})
                    + "\n")
    pytest.importorskip("matplotlib")
    assert accuracy_curve.plot_curve(out) == str(tmp_path / "curve.png")
    assert os.path.getsize(tmp_path / "curve.png") > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert accuracy_curve.plot_curve(out) is None


# ---- feed_bench ----


def test_feed_bench_host_records_have_the_jax_keys(data_root):
    for wire in ("packed", "nibble"):
        got = feed_bench.host_sampling_rate(data_root, 16, wire, 0.2)
        want = jax_feed_bench.host_sampling_rate(data_root, 16, wire, 0.2)
        assert got.keys() == want.keys() and got["wire"] == wire
        got = feed_bench.host_superbatch_rate(data_root, 16, 4, wire, 0.2)
        want = jax_feed_bench.host_superbatch_rate(data_root, 16, 4, wire,
                                                   0.2)
        assert got.keys() == want.keys() and got["stack"] == 4
        assert got["samples_per_sec"] > 0


def feed_config(cls, data_root, run_dir, **kw):
    return cls(**{**tiny(data_root, run_dir, train_split="train"),
                  "scheme": "uniform", "print_interval": 10,
                  "validation_interval": 10**9, **kw})


def test_feed_bench_streamed_record_has_the_jax_keys(data_root, tmp_path):
    got = feed_bench.streamed_training_rate(
        feed_config(ExperimentConfig, data_root, tmp_path / "port"), 20,
        device="cpu")
    want = jax_feed_bench.streamed_training_rate(
        feed_config(JaxExperimentConfig, data_root, tmp_path / "jax"), 20)
    assert got.keys() == want.keys()
    assert got["windows"] == want["windows"] == 1
    assert got["samples_per_sec"] > 0
    for key in ("kind", "wire", "device_prefetch", "loader_threads",
                "steps_per_call", "batch_size"):
        assert got[key] == want[key]


def test_feed_bench_needs_one_whole_window(data_root, tmp_path):
    with pytest.raises(SystemExit, match="print_interval"):
        feed_bench.streamed_training_rate(
            feed_config(ExperimentConfig, data_root, tmp_path), 5,
            device="cpu")


def test_feed_bench_keeps_the_jax_base_config():
    import inspect

    src = inspect.getsource(feed_bench.main)
    want = inspect.getsource(jax_feed_bench.main)
    base = "num_layers=12, channels=128, batch_size=512, steps_per_call=20"
    assert base in src and base in want
    assert "loader_threads=4" in src and "prefetch=8" in src


# ---- debug_twoply ----


def test_debug_twoply_stats_match_jax(checkpoint):
    _, params, cfg = load_policy(checkpoint, device="cpu")
    _, jparams, jcfg = jax_serving.load_policy(checkpoint)
    two = debug_twoply.DebugTwoPly(params, cfg, rank=8, device="cpu")
    jtwo = jax_debug_twoply.DebugTwoPly(jparams, jcfg, rank=8)
    one = arena.PolicySearchAgent(params, cfg, rank=8, device="cpu")
    jone = jax_arena.PolicySearchAgent(jparams, jcfg, rank=8)
    games, _, stats = arena.play_match(two, one, n_games=2, max_moves=40,
                                       seed=11)
    jgames, _, jstats = jax_arena.play_match(jtwo, jone, n_games=2,
                                             max_moves=40, seed=11)
    assert two.stats == jtwo.stats and two.stats["plies"] > 0
    def moves(games):
        return [[(m.player, m.x, m.y) for m in g.moves] for g in games]

    assert moves(games) == moves(jgames)
    drop = ("seconds", "positions_per_sec")
    assert {k: v for k, v in stats.items() if k not in drop} == \
        {k: v for k, v in jstats.items() if k not in drop}


def test_debug_twoply_main_on_the_cpu(checkpoint, capsys):
    debug_twoply.main(["--ckpt", checkpoint, "--games", "2", "--max-moves",
                       "12", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "twoply: 12 boards over 12 plies" in printed
    assert "game0 moves tail:" in printed


# ---- no card, no fallback ----


def net_tool_calls(data_root, checkpoint, tmp_path):
    spec = f"checkpoint:{checkpoint}"
    return {
        "symmetry_eval": lambda: symmetry_eval.main([
            "--checkpoint", checkpoint, "--data-root", data_root]),
        "accuracy_curve": lambda: accuracy_curve.main([
            "--data-root", data_root, "--out", str(tmp_path / "c.jsonl")]),
        "feed_bench": lambda: feed_bench.main([
            "--data-root", data_root, "--out", str(tmp_path / "f.jsonl")]),
        "debug_twoply": lambda: debug_twoply.main(["--ckpt", checkpoint]),
        "make_selfplay_corpus": lambda: make_selfplay_corpus.main([
            "--out", str(tmp_path), "--pairs", f"{spec},oneply"]),
        "make_corpus": lambda: make_corpus.main([
            "--out", str(tmp_path), "--extra", f"{spec}=6"]),
        "make_notebook": lambda: make_notebook.main([
            "--out", str(tmp_path / "f.jsonl")]),
    }


@pytest.mark.parametrize("tool", ["symmetry_eval", "accuracy_curve",
                                  "feed_bench", "debug_twoply",
                                  "make_selfplay_corpus", "make_corpus",
                                  "make_notebook"])
def test_net_tools_raise_on_cuda_without_cuda(data_root, checkpoint,
                                              tmp_path, tool):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        net_tool_calls(data_root, checkpoint, tmp_path)[tool]()
    assert not os.path.exists(tmp_path / "f.jsonl")

