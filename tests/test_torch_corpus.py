"""The port's corpus tools (``deepgo_tpu_torch/tools``) against the JAX
package's ``tools/`` scripts on the CPU, on the same inputs.

Bars: byte-identical output directories (SGFs and shards) for
``make_corpus`` with the scripted pool, ``make_selfplay_corpus`` with
scripted pairs, ``subset_split`` and ``convert_torch_dataset``; the same
printed lines but for timings; the same pool, splits and pair cycle; the
``t7reader`` copy decodes the same bytes to the same objects. The port's
walkthrough notebook imports only the port, is valid nbformat v4, matches
the committed ``docs/walkthrough_torch.ipynb`` and executes on the CPU.
"""

import ast
import json
import os
import re
import struct
import time

import numpy as np
import pytest
import torch

import convert_torch_dataset as jax_convert
import make_corpus as jax_make_corpus
import make_selfplay_corpus as jax_make_selfplay_corpus
import subset_split as jax_subset_split
import t7reader as jax_t7reader
from conftest import REPO_ROOT
from deepgo_tpu.data.transcribe import transcribe_split as jax_transcribe

from deepgo_tpu_torch.data.transcribe import transcribe_split
from deepgo_tpu_torch.tools import (OUT_DIR, convert_torch_dataset,
                                    make_corpus, make_notebook,
                                    make_selfplay_corpus, subset_split,
                                    t7reader)

torch.set_num_threads(2)

SPLITS = ("train", "validation", "test")
SHARD_FILES = ("planes.bin", "meta.npy", "games.json")
# printed figures that are timings, dropped before two runs' lines compare
TIMINGS = re.compile(r"[\d,.]+ pos/sec|'gen_seconds': [\d.e-]+|in \d+s")


def tree_bytes(root: str) -> dict:
    """relative path -> bytes of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def untimed(text: str) -> list:
    return [TIMINGS.sub("<t>", line) for line in text.splitlines()]


# ---- make_corpus ----


def test_generate_scripted_pool_is_byte_identical(tmp_path):
    kw = dict(target_positions=600, chunk=16, max_moves=60, seed=5,
              opening_plies=4)
    want = jax_make_corpus.generate(
        str(tmp_path / "jax"), pool=jax_make_corpus.build_pool([], 5, 0.0),
        **kw)
    got = make_corpus.generate(
        str(tmp_path / "port"), pool=make_corpus.build_pool([], 5, 0.0),
        **kw)
    assert want.pop("gen_seconds") > 0 and got.pop("gen_seconds") > 0
    assert got == want and got["positions"] >= 600
    sgfs = tree_bytes(str(tmp_path / "port" / "sgf"))
    assert len(sgfs) == got["games"]
    assert sgfs == tree_bytes(str(tmp_path / "jax" / "sgf"))
    for split in SPLITS:
        n = transcribe_split(str(tmp_path / "port" / "sgf" / split),
                             str(tmp_path / "port" / "processed" / split),
                             workers=1, verbose=False)
        m = jax_transcribe(str(tmp_path / "jax" / "sgf" / split),
                           str(tmp_path / "jax" / "processed" / split),
                           workers=1, verbose=False)
        assert n == m > 0
    assert tree_bytes(str(tmp_path / "port" / "processed")) == \
        tree_bytes(str(tmp_path / "jax" / "processed"))


def test_main_writes_and_prints_what_the_jax_tool_does(tmp_path, capsys):
    argv = ["--positions", "200", "--chunk", "8", "--max-moves", "30",
            "--seed", "2", "--opening-plies", "3", "--transcribe-workers",
            "1"]
    jax_make_corpus.main(["--out", str(tmp_path / "jax"), *argv])
    want = capsys.readouterr().out
    make_corpus.main(["--out", str(tmp_path / "port"), *argv])
    got = capsys.readouterr().out
    assert untimed(got) == untimed(want)
    assert tree_bytes(str(tmp_path / "port")) == \
        tree_bytes(str(tmp_path / "jax"))


def test_build_pool_matches_jax():
    def summary(pool):
        return {name: (type(agent).__name__, agent.name, rank,
                       getattr(agent, "temperature", None))
                for name, (agent, rank) in pool.items()}

    assert summary(make_corpus.build_pool([], 0, 0.0)) == \
        summary(jax_make_corpus.build_pool([], 0, 0.0))
    got = make_corpus.build_pool(["model:small=7"], 0, 0.5, device="cpu")
    assert summary(got) == summary(jax_make_corpus.build_pool(
        ["model:small=7"], 0, 0.5))
    assert set(got) == {"heuristic", "oneply", "x0-init-small"}
    assert got["x0-init-small"][0].device == "cpu"


def test_build_pool_rejects_a_malformed_extra_as_jax_does():
    with pytest.raises(AssertionError) as want:
        jax_make_corpus.build_pool(["model:small"], 0, 0.0)
    with pytest.raises(ValueError) as got:
        make_corpus.build_pool(["model:small"], 0, 0.0, device="cpu")
    assert str(got.value) == str(want.value)
    assert "SPEC=RANK" in str(got.value)


def test_split_of_matches_jax():
    got = [make_corpus.split_of(g) for g in range(1000)]
    assert got == [jax_make_corpus.split_of(g) for g in range(1000)]
    assert got.count("validation") == got.count("test") == 20


def test_default_pool_keeps_the_legacy_pair_cycle():
    pool = make_corpus.build_pool([], seed=0, temperature=0.0)
    names = sorted(pool, key=lambda n: (-pool[n][1], n))
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i:]]
    assert pairs == [("oneply", "oneply"), ("oneply", "heuristic"),
                     ("heuristic", "heuristic")]


# ---- make_selfplay_corpus ----


def test_selfplay_corpus_of_scripted_pairs_is_byte_identical(tmp_path,
                                                             capsys):
    argv = ["--pairs", "oneply,heuristic", "heuristic,random", "--games",
            "12", "--chunk", "5", "--max-moves", "40", "--opening-plies",
            "3", "--seed", "4", "--skip-transcribe"]
    jax_make_selfplay_corpus.main(["--out", str(tmp_path / "jax"), *argv])
    want = capsys.readouterr().out
    make_selfplay_corpus.main(["--out", str(tmp_path / "port"), *argv,
                               "--device", "cpu"])
    got = capsys.readouterr().out
    assert untimed(got) == untimed(want)
    sgfs = tree_bytes(str(tmp_path / "port" / "sgf"))
    assert len(sgfs) == 12 and sgfs == tree_bytes(str(tmp_path / "jax" /
                                                      "sgf"))
    assert "BR[1d]" in "".join(s.decode() for s in sgfs.values())
    # the port's transcription of them is the JAX package's, byte for byte
    for pkg, fn in (("port", transcribe_split), ("jax", jax_transcribe)):
        fn(str(tmp_path / pkg / "sgf" / "train"),
           str(tmp_path / pkg / "processed"), workers=1, verbose=False)
    assert tree_bytes(str(tmp_path / "port" / "processed")) == \
        tree_bytes(str(tmp_path / "jax" / "processed"))


def test_selfplay_corpus_rejects_a_malformed_pair(tmp_path):
    with pytest.raises(ValueError, match="specA,specB"):
        make_selfplay_corpus.main(["--out", str(tmp_path), "--pairs",
                                   "oneply", "--device", "cpu"])


# ---- subset_split ----


@pytest.fixture(scope="module")
def train_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    transcribe_split(os.path.join(REPO_ROOT, "data/sgf/train"),
                     str(root / "train"), workers=1, verbose=False)
    return str(root / "train")


@pytest.mark.parametrize("positions", [1, 1500, 10**9])
def test_subset_split_is_byte_identical(train_split, tmp_path, positions,
                                        capsys):
    argv = ["--src", train_split, "--positions", str(positions)]
    jax_subset_split.main(["--out", str(tmp_path / "jax"), *argv])
    want = capsys.readouterr().out
    subset_split.main(["--out", str(tmp_path / "port"), *argv])
    got = capsys.readouterr().out
    assert got.replace(str(tmp_path / "port"), "OUT") == \
        want.replace(str(tmp_path / "jax"), "OUT")
    files = tree_bytes(str(tmp_path / "port"))
    assert sorted(files) == sorted(SHARD_FILES)
    assert files == tree_bytes(str(tmp_path / "jax"))
    n = subset_split.subset_prefix_copy(train_split, str(tmp_path / "again"),
                                        positions)
    assert n == jax_subset_split.subset_prefix_copy(
        train_split, str(tmp_path / "again_jax"), positions)


def test_subset_split_refuses_an_empty_subset(train_split, tmp_path):
    with pytest.raises(ValueError, match="empty subset"):
        subset_split.subset_prefix_copy(train_split, str(tmp_path), 0)


# ---- t7reader and convert_torch_dataset ----


class T7Writer:
    """The subset of the Torch7 serialization the reference records use
    (numbers, strings, tables, Byte/Int tensors and their storages)."""

    TENSORS = {np.uint8: ("torch.ByteTensor", "torch.ByteStorage"),
               np.int32: ("torch.IntTensor", "torch.IntStorage")}

    def __init__(self):
        self.out = bytearray()
        self.index = 0

    def _int(self, v):
        self.out += struct.pack("<i", v)

    def _long(self, v):
        self.out += struct.pack("<q", v)

    def _str(self, s):
        b = s.encode("latin-1")
        self._int(len(b))
        self.out += b

    def _ref(self):
        self.index += 1
        self._int(self.index)

    def obj(self, o):
        if isinstance(o, bool):
            self._int(5)
            self._int(int(o))
        elif isinstance(o, (int, float)):
            self._int(1)
            self.out += struct.pack("<d", float(o))
        elif isinstance(o, str):
            self._int(2)
            self._str(o)
        elif isinstance(o, dict):
            self._int(3)
            self._ref()
            self._int(len(o))
            for k, v in o.items():
                self.obj(k)
                self.obj(v)
        else:  # a contiguous numpy tensor
            tensor, storage = self.TENSORS[o.dtype.type]
            self._int(4)
            self._ref()
            self._str("V 1")
            self._str(tensor)
            self._int(o.ndim)
            for s in o.shape:
                self._long(s)
            for s in o.strides:
                self._long(s // o.itemsize)
            self._long(1)  # 1-based storage offset
            self._int(4)
            self._ref()
            self._str("V 1")
            self._str(storage)
            self._long(o.size)
            self.out += o.tobytes()
        return self


def write_t7_corpus(root, seed=0):
    """<root>/<split>/<game>/<K>: one record per move, as the reference's
    makedata writes them; a non-game directory and a 0-move game too."""
    rng = np.random.default_rng(seed)
    records = {}
    for split, games in (("train", 3), ("validation", 2)):
        for g in range(games):
            d = os.path.join(root, split, "2001", f"game-{g}")
            os.makedirs(d)
            for k in range(1, int(rng.integers(2, 12)) + 1):
                rec = {"input": rng.integers(0, 3, (9, 19, 19),
                                             dtype=np.uint8),
                       "move": {"player": int(rng.integers(1, 3)),
                                "x": int(rng.integers(1, 20)),
                                "y": int(rng.integers(1, 20))},
                       "ranks": {1: int(rng.integers(1, 10)),
                                 2: int(rng.integers(1, 10))},
                       "meta": {"komi": 6.5, "handicap": False,
                                "ids": np.arange(3, dtype=np.int32)}}
                path = os.path.join(d, str(k))
                with open(path, "wb") as f:
                    f.write(bytes(T7Writer().obj(rec).out))
                records[path] = rec
        os.makedirs(os.path.join(root, split, "2001", "notes"))
    return records


def test_t7reader_copy_decodes_what_the_jax_reader_does(tmp_path):
    records = write_t7_corpus(str(tmp_path))
    for path, rec in records.items():
        got, want = t7reader.load(path), jax_t7reader.load(path)
        assert got.keys() == want.keys() == rec.keys()
        assert got["input"].dtype == np.uint8
        for a, b in ((got, want), (got, rec)):
            assert np.array_equal(a["input"], b["input"])
            assert a["move"] == b["move"] and a["ranks"] == b["ranks"]
            assert np.array_equal(a["meta"]["ids"], b["meta"]["ids"])
            assert a["meta"]["komi"] == b["meta"]["komi"] == 6.5


def test_convert_torch_dataset_is_byte_identical(tmp_path, capsys):
    write_t7_corpus(str(tmp_path / "src"), seed=3)
    for split in ("train", "validation"):
        n = convert_torch_dataset.convert_split(
            str(tmp_path / "src" / split), str(tmp_path / "port" / split),
            verbose=False)
        m = jax_convert.convert_split(str(tmp_path / "src" / split),
                                      str(tmp_path / "jax" / split),
                                      verbose=False)
        assert n == m > 0
    assert tree_bytes(str(tmp_path / "port")) == \
        tree_bytes(str(tmp_path / "jax"))
    convert_torch_dataset.main(["--src", str(tmp_path / "src"), "--out",
                                str(tmp_path / "main"), "--splits",
                                "train,validation"])
    printed = capsys.readouterr().out
    assert printed.count("examples") == 2
    assert tree_bytes(str(tmp_path / "main")) == \
        tree_bytes(str(tmp_path / "jax"))


# ---- make_notebook ----

FORBIDDEN = ("jax", "jaxlib", "deepgo_tpu", "tools")


def code_cells(device="cpu"):
    return [src for kind, src in make_notebook.cells(device)
            if kind == "code"]


def test_notebook_cells_import_only_the_port():
    roots = set()
    for src in code_cells():
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots.add(node.module.split(".")[0])
    assert "deepgo_tpu_torch" in roots and not roots & set(FORBIDDEN)
    assert code_cells("cuda")[0] == 'DEVICE = "cuda"'
    assert [k for k, _ in make_notebook.cells("cpu")] == \
        [k for k, _ in make_notebook.CELLS]


def test_built_notebook_is_valid_v4():
    import nbformat

    nb = make_notebook.build("cpu")
    nbformat.validate(nb)
    assert nb.nbformat == 4
    assert [c.source for c in nb.cells if c.cell_type == "code"] == \
        [s.rstrip("\n") for s in code_cells()]


def test_committed_notebook_is_the_cells_executed_on_the_cpu():
    import nbformat

    path = os.path.join(REPO_ROOT, "docs", "walkthrough_torch.ipynb")
    nb = nbformat.read(path, as_version=4)
    nbformat.validate(nb)
    assert [c.source for c in nb.cells] == \
        [s.rstrip("\n") for _, s in make_notebook.cells("cpu")]
    code = [c for c in nb.cells if c.cell_type == "code"]
    assert all(c.execution_count for c in code)
    assert not [o for c in code for o in c.outputs
                if o.output_type == "error"]
    text = json.dumps(nb)
    assert "round-trip through SGF" in text and "/root/" not in text


def test_notebook_executes_on_the_cpu(tmp_path, monkeypatch):
    import nbformat

    os.makedirs(tmp_path / "data")
    os.symlink(os.path.join(REPO_ROOT, "data", "sgf"),
               tmp_path / "data" / "sgf")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO_ROOT, os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    nb = make_notebook.build("cpu")
    t0 = time.monotonic()
    make_notebook.execute(nb, str(tmp_path), timeout=120)
    assert time.monotonic() - t0 < 300
    nbformat.validate(nb)
    outputs = [o for c in nb.cells if c.cell_type == "code"
               for o in c.outputs]
    assert not [o for o in outputs if o.output_type == "error"]
    text = "".join(o.get("text", "") for o in outputs)
    assert "train:" in text and "round-trip through SGF" in text
    assert os.path.isdir(tmp_path / "runs")


def test_default_outputs_are_not_tracked_files():
    assert OUT_DIR.split("/")[0] == "runs"
    ignored = open(os.path.join(REPO_ROOT, ".gitignore")).read().split()
    assert "runs/" in ignored
