"""The port's value training against ``tools/train_value.py`` and
``tools/winner_index.py``.

The winner sidecar the port's ``data.winners.build`` writes is byte-equal
to the JAX tool's, on the port's transcription of ``data/sgf`` (whose
games carry no result) and of a copy of it with results written in.
``decided_indices`` and ``gather`` agree; a float32 value step from the
same params and batch gives a loss and updated params within ``STEP_TOL``
of the step ``tools/train_value.make_step`` compiles, and ``evaluate``
the same accuracy. ``main`` trains on the CPU and its checkpoint loads in
both packages.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import train_value as jax_train_value
import winner_index as jax_winner_index
from deepgo_tpu.data.dataset import GoDataset as JaxDataset
from deepgo_tpu.experiments import checkpoint as jax_ckpt
from deepgo_tpu.models.serving import load_value as jax_load_value
from deepgo_tpu.training.optimizers import sgd as jax_sgd

from deepgo_tpu_torch.data import winners
from deepgo_tpu_torch.data.dataset import GoDataset
from deepgo_tpu_torch.data.transcribe import transcribe_split
from deepgo_tpu_torch.experiments import checkpoint as ckpt
from deepgo_tpu_torch.models import convert, value_cnn
from deepgo_tpu_torch.models.serving import load_value
from deepgo_tpu_torch.training import sgd, value

from conftest import REPO_ROOT
from test_torch_value import jax_cfg, jax_tree, port_model

torch.set_num_threads(2)

SGF_DIR = os.path.join(REPO_ROOT, "data", "sgf")
STEP_TOL = 1e-5
RESULTS = ("B+R", "W+3.5", None)   # game i gets RESULTS[i % 3]
F32 = value_cnn.ValueConfig(num_layers=2, channels=16, head_hidden=16,
                            compute_dtype="float32")
B = 32


def with_results(src: str, dst: str) -> None:
    """Copy the SGF tree ``src`` to ``dst``, writing an RE[] result into
    the root node of game i (sorted order) as ``RESULTS[i % 3]`` says."""
    paths = sorted(os.path.relpath(os.path.join(d, n), src)
                   for d, _, names in os.walk(src) for n in names
                   if n.endswith(".sgf"))
    for i, rel in enumerate(paths):
        with open(os.path.join(src, rel)) as f:
            text = f.read()
        result = RESULTS[i % len(RESULTS)]
        if result is not None:
            text = text.replace("(;", f"(;RE[{result}]", 1)
        os.makedirs(os.path.dirname(os.path.join(dst, rel)), exist_ok=True)
        with open(os.path.join(dst, rel), "w") as f:
            f.write(text)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{"plain": (sgf root, processed root), "results": ...}: the train
    and validation splits of data/sgf as they are and with results, each
    transcribed by the port."""
    base = tmp_path_factory.mktemp("value")
    out = {}
    for name in ("plain", "results"):
        sgf_root = SGF_DIR if name == "plain" else str(base / "sgf")
        if name == "results":
            with_results(SGF_DIR, sgf_root)
        root = base / f"processed-{name}"
        for split in ("train", "validation"):
            transcribe_split(os.path.join(sgf_root, split),
                             str(root / split), workers=1, verbose=False)
        out[name] = (sgf_root, str(root))
    return out


@pytest.fixture(scope="module")
def data_root(corpora):
    """The processed corpus with results and its port-built sidecars."""
    sgf_root, root = corpora["results"]
    for split in ("train", "validation"):
        winners.build(os.path.join(root, split),
                      os.path.join(sgf_root, split))
    return root


@pytest.mark.parametrize("name", ["plain", "results"])
def test_winner_sidecar_byte_equal(corpora, tmp_path, name):
    sgf_root, root = corpora[name]
    shard = str(tmp_path / "train")
    shutil.copytree(os.path.join(root, "train"), shard)
    sgf_dir = os.path.join(sgf_root, "train")
    want_stats = jax_winner_index.build(shard, sgf_dir)
    with open(os.path.join(shard, "winner.npy"), "rb") as f:
        want = f.read()
    os.remove(os.path.join(shard, "winner.npy"))
    assert winners.build(shard, sgf_dir) == want_stats
    with open(os.path.join(shard, "winner.npy"), "rb") as f:
        assert f.read() == want
    if name == "results":
        assert want_stats["decided"] > 0 and want_stats["undecided"] > 0
    else:
        assert want_stats["decided"] == 0


@pytest.mark.parametrize("equal_rank", [False, True])
def test_decided_indices_and_gather_equal(data_root, equal_rank):
    ds, jds = GoDataset(data_root, "train"), JaxDataset(data_root, "train")
    ix = value.decided_indices(ds, equal_rank)
    np.testing.assert_array_equal(
        ix, jax_train_value.decided_indices(jds, equal_rank))
    assert ix.size > 0
    pick = np.random.default_rng(1).choice(ix, size=B)
    for a, b in zip(value.gather(ds, pick),
                    jax_train_value.gather(jds, pick)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_decided_indices_needs_the_sidecar(corpora):
    with pytest.raises(ValueError, match="winner.npy"):
        value.decided_indices(GoDataset(corpora["plain"][1], "validation"))


def batch(data_root, seed=0):
    ds = GoDataset(data_root, "train")
    ix = value.decided_indices(ds)
    return value.gather(ds, np.random.default_rng(seed).choice(ix, size=B))


def test_float32_value_step_matches_jax(data_root):
    tree = jax_tree(F32, seed=3)
    host = batch(data_root)
    step, _ = value.make_step(F32, sgd(0.02, 0.0, 0.9))
    j_step, _ = jax_train_value.make_step(jax_cfg(F32),
                                          jax_sgd(0.02, 0.0, 0.9))
    model = port_model(tree, F32)
    opt = sgd(0.02, 0.0, 0.9)
    state = opt.init(model)
    j_params = jax.tree.map(jnp.asarray, tree)
    j_state = jax_sgd(0.02, 0.0, 0.9).init(j_params)
    for _ in range(2):  # the second step carries momentum
        model, state, loss = step(model, state,
                                  *value.to_tensors(host, "cpu"))
        j_params, j_state, j_loss = j_step(j_params, j_state,
                                           *map(jnp.asarray, host))
        assert abs(float(loss) - float(j_loss)) <= STEP_TOL
    for got, want in zip(ckpt.tree_leaves(convert.value_to_jax(model)),
                         jax.tree.leaves(j_params)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=STEP_TOL)
    velocity = convert.value_opt_state_to_jax(state)
    for got, want in zip(ckpt.tree_leaves(velocity),
                         jax.tree.leaves(j_state)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=STEP_TOL)


def test_bce_is_the_jax_form_and_stable():
    logits = torch.tensor([-80.0, -3.0, 0.0, 2.5, 90.0])
    z = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    got = value.bce_from_logits(logits, z)
    want = torch.nn.functional.binary_cross_entropy_with_logits(logits, z)
    assert torch.isfinite(got) and abs(float(got - want)) <= 1e-6


def test_evaluate_equal_accuracy(data_root):
    tree = jax_tree(F32, seed=5)
    host = batch(data_root, seed=2)
    _, evaluate = value.make_step(F32, sgd(0.02))
    _, j_evaluate = jax_train_value.make_step(jax_cfg(F32), jax_sgd(0.02))
    loss, acc = evaluate(port_model(tree, F32),
                         *value.to_tensors(host, "cpu"))
    j_loss, j_acc = j_evaluate(jax.tree.map(jnp.asarray, tree),
                               *map(jnp.asarray, host))
    assert float(acc) == float(j_acc)
    assert abs(float(loss) - float(j_loss)) <= STEP_TOL


def test_main_trains_on_the_cpu_and_both_packages_load_it(data_root,
                                                          tmp_path):
    out = value.main(["--data-root", data_root, "--iters", "6",
                      "--batch-size", "16", "--channels", "16",
                      "--val-interval", "3", "--val-size", "64",
                      "--print-interval", "3", "--out", str(tmp_path),
                      "--device", "cpu"])
    assert out["final"]["step"] == 6
    assert np.isfinite(out["final"]["val_loss"])
    _, model, cfg = load_value(out["path"], device="cpu")
    assert (cfg.num_layers, cfg.channels) == (3, 16)
    _, j_params, j_cfg = jax_load_value(out["path"])
    assert (j_cfg.num_layers, j_cfg.channels) == (3, 16)
    for got, want in zip(ckpt.tree_leaves(convert.value_to_jax(model)),
                         jax.tree.leaves(j_params)):
        np.testing.assert_array_equal(got, np.asarray(want))
    meta, _, o_leaves = jax_ckpt.load_checkpoint(out["path"])
    assert meta["kind"] == "value" and len(meta["validation_history"]) == 2
    assert len(o_leaves) == 1 + len(jax.tree.leaves(j_params))


def test_main_raises_without_cuda(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        value.main(["--data-root", data_root, "--iters", "1",
                    "--out", str(tmp_path)])
