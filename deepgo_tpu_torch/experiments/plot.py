"""Validation-curve plotting from run metrics or bare checkpoints.

The port's copy of ``deepgo_tpu/experiments/plot.py``: the same CSV bytes
for the same run directories, whichever package wrote them.

The reference plots validation costs out of checkpoint files inside iTorch
(plot.lua:5-29). Runs here stream JSONL metrics, so plotting prefers those,
but every checkpoint also carries its full ``validation_history``, so a
bare ``checkpoint.npz`` (or a run dir holding only one) plots too — true
parity with the reference's plot-from-.model workflow. Emits a CSV
(always) and a PNG when matplotlib is importable.

Usage:
  python -m deepgo_tpu_torch.experiments.plot runs/<id> [runs/<id2> ...] [--out curves]
  python -m deepgo_tpu_torch.experiments.plot runs/<id>/checkpoint.npz
"""

from __future__ import annotations

import argparse
import os

from ..utils.atomicio import atomic_write
from ..utils.metrics import read_jsonl


def _checkpoint_curve(path: str) -> list[tuple[int, float, float]]:
    from .checkpoint import load_meta

    meta = load_meta(path)
    return [(r["step"], r["cost"], r["accuracy"])
            for r in meta.get("validation_history", [])]


def load_curves(run_dirs: list[str]) -> dict[str, list[tuple[int, float, float]]]:
    """Per-run (step, cost, accuracy) rows. Each argument may be a run dir
    (metrics.jsonl preferred, checkpoint.npz fallback) or a checkpoint file."""
    curves = {}
    for run_dir in run_dirs:
        if run_dir.endswith(".npz"):
            name = os.path.basename(os.path.dirname(run_dir)) or run_dir
            curves[name] = _checkpoint_curve(run_dir)
            continue
        name = os.path.basename(run_dir.rstrip("/"))
        path = os.path.join(run_dir, "metrics.jsonl")
        if os.path.exists(path):
            rows = [r for r in read_jsonl(path) if r["kind"] == "validation"]
            curves[name] = [(r["step"], r["cost"], r["accuracy"]) for r in rows]
        else:
            curves[name] = _checkpoint_curve(
                os.path.join(run_dir, "checkpoint.npz"))
    return curves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--out", default="curves")
    args = ap.parse_args(argv)

    curves = load_curves(args.runs)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    csv_path = args.out + ".csv"
    # atomic: repeated plot runs overwrite in place; a crash mid-write
    # must not truncate the previous good CSV (docs/static_analysis.md)
    with atomic_write(csv_path, mode="w") as f:
        f.write("run,step,validation_cost,validation_accuracy\n")
        for run, rows in curves.items():
            for step, cost, acc in rows:
                f.write(f"{run},{step},{cost},{acc}\n")
    print(f"wrote {csv_path}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; CSV only")
        return
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for run, rows in curves.items():
        if not rows:
            continue
        steps, costs, accs = zip(*rows)
        ax1.plot(steps, costs, label=run)
        ax2.plot(steps, accs, label=run)
    ax1.set_xlabel("step"); ax1.set_ylabel("validation NLL"); ax1.legend()
    ax2.set_xlabel("step"); ax2.set_ylabel("top-1 accuracy"); ax2.legend()
    fig.tight_layout()
    png_path = args.out + ".png"
    fig.savefig(png_path, dpi=120)
    print(f"wrote {png_path}")


if __name__ == "__main__":
    main()
