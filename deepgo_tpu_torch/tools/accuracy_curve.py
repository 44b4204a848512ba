"""Accuracy-vs-corpus-size curve: same config, growing data, shared test set.

For each position budget this trains the SAME model config for the SAME
number of steps on a game-aligned subset of the corpus
(``deepgo_tpu_torch.tools.subset_split``) and evaluates top-1 on the shared
held-out test split; small subsets overfit and plateau, larger ones keep
gaining — the curve the paper's 55%@27M-positions sits on
(arXiv:1412.6564). The port's twin of ``tools/accuracy_curve.py``: each
point is the port's ``Experiment`` on ``--device`` (``cuda`` by default).

Writes one JSONL record per point to --out and a CSV next to it; budgets
already recorded in --out are skipped.

Usage:
  python -m deepgo_tpu_torch.tools.accuracy_curve \
      --data-root data/corpus/processed \
      --budgets 4000,40000,400000,4000000 --iters 4000 \
      --set num_layers=12 channels=128 batch_size=512
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .. import resolve_device
from ..cli import parse_overrides
from ..data.dataset import GoDataset
from ..experiments import Experiment, ExperimentConfig
from ..utils.atomicio import atomic_write
from . import OUT_DIR
from .subset_split import subset_prefix_copy


def run_point(cfg: ExperimentConfig, budget: int, iters: int,
              data_root: str, full_size: int, device="cuda") -> dict:
    if budget >= full_size:
        split = "train"  # full corpus: no point copying 100% of the shard
    else:
        split = f"train_{budget}"
        split_dir = os.path.join(data_root, split)
        if not os.path.exists(os.path.join(split_dir, "planes.bin")):
            n = subset_prefix_copy(os.path.join(data_root, "train"),
                                   split_dir, budget)
            print(f"built {split}: {n:,} positions", flush=True)

    exp = Experiment(cfg.replace(name=f"curve-{budget}", train_split=split),
                     device=device)
    t0 = time.time()
    summary = exp.run(iters)
    test = exp.evaluate()  # full test split, deterministic
    record = {
        "budget": budget,
        "actual_positions": (full_size if split == "train"
                             else len(GoDataset(data_root, split))),
        "iters": iters,
        "batch_size": cfg.batch_size,
        "test_top1": test["accuracy"],
        "test_nll": test["cost"],
        "final_ewma": summary["final_ewma"],
        "last_val": summary["last_validation"],
        "samples_per_sec": summary["samples_per_sec"],
        "seconds": time.time() - t0,
        "run_id": exp.id,
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-root", default="data/corpus/processed")
    ap.add_argument("--budgets", default="4000,40000,400000,4000000")
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--out", default=os.path.join(OUT_DIR,
                                                  "accuracy_curve.jsonl"))
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    ap.add_argument("--device", default="cuda",
                    help="device the points train on (cuda or cpu)")
    args = ap.parse_args(argv)

    resolve_device(args.device)  # no card: raise before any work
    cfg = ExperimentConfig(data_root=args.data_root, scheme="uniform")
    cfg = cfg.replace(**parse_overrides(args.set))

    full_size = len(GoDataset(args.data_root, "train"))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    # resume-friendly: budgets already recorded in --out are not re-trained
    # (an interrupted sweep then only costs the interrupted point)
    records = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            records = [json.loads(line) for line in f if line.strip()]
    done = {r["budget"] for r in records}
    for budget in [int(b) for b in args.budgets.split(",")]:
        if budget in done:
            print(f"budget {budget} already recorded; skipping", flush=True)
            continue
        record = run_point(cfg, budget, args.iters, args.data_root,
                           full_size, device=args.device)
        records.append(record)
        with open(args.out, "a") as f:
            f.write(json.dumps(record) + "\n")

    csv = args.out.rsplit(".", 1)[0] + ".csv"
    with atomic_write(csv, "w") as f:
        f.write("positions,test_top1,test_nll\n")
        for r in records:
            f.write(f"{r['actual_positions']},{r['test_top1']:.4f},"
                    f"{r['test_nll']:.4f}\n")
    print(f"wrote {args.out} and {csv}")
    plot_curve(args.out)


def plot_curve(jsonl_path: str) -> str | None:
    """Accuracy-vs-positions PNG (log x) from every record in the JSONL;
    returns the PNG path, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    with open(jsonl_path) as f:
        rows = sorted((json.loads(line) for line in f if line.strip()),
                      key=lambda r: r["actual_positions"])
    if not rows:
        return None
    xs = [r["actual_positions"] for r in rows]
    ys = [r["test_top1"] for r in rows]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogx(xs, ys, marker="o")
    for x, y in zip(xs, ys):
        ax.annotate(f"{y:.1%}", (x, y), textcoords="offset points",
                    xytext=(0, 8), ha="center", fontsize=8)
    ax.set_xlabel("training positions (log)")
    ax.set_ylabel("test top-1 accuracy")
    ax.set_title("Accuracy vs corpus size (same config, same steps)")
    fig.tight_layout()
    png = jsonl_path.rsplit(".", 1)[0] + ".png"
    fig.savefig(png, dpi=120)
    plt.close(fig)
    print(f"wrote {png}")
    return png


if __name__ == "__main__":
    main()
