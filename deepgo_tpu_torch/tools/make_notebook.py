"""Build and execute docs/walkthrough_torch.ipynb, the port's walkthrough.

The notebook is generated from the cell sources below (so it stays in sync
with the API by re-running this tool) and executed with nbclient against
the bundled 22-game fixture; the committed .ipynb carries real outputs of
a ``--device cpu`` run. Its first code cell is ``DEVICE = "<--device>"``
and every later cell runs on ``DEVICE``. ``nbformat`` and ``nbclient`` are
imported only inside ``build`` and ``execute``, so ``CELLS`` imports where
neither is installed. The port's twin of ``tools/make_notebook.py``
(``docs/walkthrough.ipynb`` stays the JAX package's).

Usage:
  python -m deepgo_tpu_torch.tools.make_notebook \
      [--out docs/walkthrough_torch.ipynb] [--no-execute] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from .. import resolve_device
from ..utils.atomicio import atomic_write

DEVICE_CELL = 'DEVICE = "{device}"'

CELLS: list[tuple[str, str]] = [
    ("markdown", """\
# deepgo_tpu_torch walkthrough

End-to-end tour of the PyTorch port on the bundled 22-game fixture:
transcribe SGF records to packed feature shards, train a small policy CNN,
validate, checkpoint/resume, plot, and play. This is the port's
counterpart of `docs/walkthrough.ipynb` (the JAX package's). On an NVIDIA
card (`DEVICE = "cuda"`) every forward and train step expands the packed
records with the hand-written CUDA kernel; on the CPU the same cells take
its plain PyTorch version. The fixture keeps the notebook executable in
seconds.
"""),
    ("code", DEVICE_CELL),
    ("code", """\
# run from the repo root (nbclient starts the kernel in docs/)
import os
if os.path.basename(os.getcwd()) == "docs":
    os.chdir("..")
import torch
print(torch.__version__, DEVICE,
      torch.cuda.get_device_name(0) if DEVICE == "cuda" else "host CPU")
"""),
    ("markdown", """\
## 1. Data: SGF -> packed feature shards

`data/sgf/` holds 22 real games. Transcription replays each game with the
full rules engine (captures, liberties, ladders; the C++ twin when built)
and writes one packed `(9, 19, 19)` uint8 record per move — the model's 37
binary planes are expanded from these *on the device* at train time.
"""),
    ("code", """\
from deepgo_tpu_torch.data.transcribe import transcribe_split

for split in ("train", "validation", "test"):
    out = f"data/processed/{split}"
    n = transcribe_split(f"data/sgf/{split}", out, workers=1, verbose=False)
    print(f"{split}: {n} examples")
"""),
    ("code", """\
# one record, decoded: the position before move 60 of the first train game
import numpy as np
from deepgo_tpu_torch.data.dataset import GoDataset
from deepgo_tpu_torch.features import P_STONES

ds = GoDataset("data/processed", "train")
packed, player, rank, target = (a[0] for a in ds.batch_at(np.array([60])))
glyph = {0: ".", 1: "X", 2: "O"}
board = packed[P_STONES]
print("side to move:", "black" if player == 1 else "white",
      f"(rank {rank}d)   target point: {divmod(int(target), 19)}")
print("\\n".join(" ".join(glyph[v] for v in row) for row in board))
"""),
    ("markdown", """\
## 2. Train

One train call runs K steps (`steps_per_call`; on the card K is the print
interval, on the CPU 1): the expansion, forward, NLL, backward and SGD
update of each step, with the losses fetched once per print window.
"""),
    ("code", """\
from deepgo_tpu_torch.experiments import Experiment, ExperimentConfig

config = ExperimentConfig(
    name="walkthrough", num_layers=3, channels=32, batch_size=16,
    rate=0.05, validation_size=64, validation_interval=60,
    print_interval=20, loader_threads=1, data_parallel=1, seed=3,
    data_root="data/processed")
exp = Experiment(config, device=DEVICE)
summary = exp.run(120)
print({k: round(v, 4) if isinstance(v, float) else v
       for k, v in summary.items() if k not in ("config", "last_validation")})
"""),
    ("markdown", """\
## 3. Validate, evaluate, plot

Validation uses a fixed, game-balanced, mask-padded set (deterministic —
improving on the reference's one random minibatch per run). `evaluate()`
runs the full held-out test split. Plotting reads the run's JSONL metrics,
or the history inside any bare checkpoint.
"""),
    ("code", """\
val = exp.validate()
test = exp.evaluate()
print(f"validation: cost={val['cost']:.3f} top1={val['accuracy']:.3f} n={val['n']}")
print(f"test:       cost={test['cost']:.3f} top1={test['accuracy']:.3f} n={test['n']}")
"""),
    ("code", """\
ckpt_path = exp.save()
from deepgo_tpu_torch.experiments import plot as plotmod

curves = plotmod.load_curves([ckpt_path])  # straight from the checkpoint
print(curves)
"""),
    ("markdown", """\
## 4. Checkpoint, resume, warm restart

A checkpoint is one self-describing `.npz` in the JAX package's format
(either package loads the other's): config + weights + optimizer state +
step + validation history. `Experiment.load` continues a run;
`experiments.repeated` re-IDs it with a fresh optimizer (the reference's
warm-restart sweep workflow).
"""),
    ("code", """\
resumed = Experiment.load(ckpt_path, device=DEVICE)
print("resumed", resumed.id, "at step", resumed.step)
more = resumed.run(40)
print("EWMA after 40 more steps:", round(more["final_ewma"], 4))
"""),
    ("markdown", """\
## 5. Play: self-play and the arena

The trained policy drives batched games (one forward per ply for every
game where it is to move; per-ply move application is one threaded native
call), and the arena pits agents against each other with Tromp-Taylor
scoring. 160 training steps on 20 games is far too little to beat even the
capture-greedy baseline, but the plumbing is identical.
"""),
    ("code", """\
from deepgo_tpu_torch import arena

policy = arena.PolicyAgent(resumed.model, resumed.model_cfg, rank=8,
                           device=DEVICE)
games, scores, stats = arena.play_match(policy, arena.RandomAgent(),
                                        n_games=8, max_moves=120, seed=0)
print({k: round(v, 3) if isinstance(v, float) else v for k, v in stats.items()})
"""),
    ("code", """\
# full circle: finished games feed back through our own SGF pipeline
from deepgo_tpu_torch.selfplay import to_sgf
from deepgo_tpu_torch import sgf as sgfmod

rec = to_sgf(games[0], komi=7.5)
parsed = sgfmod.parse(rec)
print(f"game 0: {len(parsed.moves)} moves round-trip through SGF")
"""),
]


def cells(device: str) -> list[tuple[str, str]]:
    """``CELLS`` with the device cell set to ``DEVICE = "<device>"``."""
    return [(kind, DEVICE_CELL.format(device=device)
             if src == DEVICE_CELL else src) for kind, src in CELLS]


def build(device: str = "cuda"):
    """The notebook (an ``nbformat`` v4 node) of ``cells(device)``."""
    import nbformat

    nb = nbformat.v4.new_notebook()
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": "python3"}
    for kind, src in cells(device):
        cell = (nbformat.v4.new_markdown_cell if kind == "markdown"
                else nbformat.v4.new_code_cell)(src.rstrip("\n"))
        nb.cells.append(cell)
    return nb


def execute(nb, cwd: str, timeout: int = 600) -> None:
    """Run every code cell of ``nb`` in a fresh kernel started in
    ``cwd``, writing the outputs into ``nb``."""
    from nbclient import NotebookClient

    NotebookClient(nb, timeout=timeout,
                   resources={"metadata": {"path": cwd}}).execute()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="docs/walkthrough_torch.ipynb")
    ap.add_argument("--no-execute", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the notebook's DEVICE (cuda or cpu)")
    args = ap.parse_args(argv)

    import nbformat

    nb = build(args.device)
    if not args.no_execute:
        resolve_device(args.device)  # no card: raise before the kernel
        execute(nb, os.getcwd())
    with atomic_write(args.out, "w") as f:
        nbformat.write(nb, f)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
