"""Where the bfloat16 gaps of a dual-head cell come from, on its card.

    python3 benchmark/precision_witness.py --workload agz40.train.b512 \
        --seeds 2 --blocks 10 20 40

Each arm runs the cell (set-up, a short window, the judgement) on each
seed, with the control computed in bfloat16 in place of float8 (the
traffic's ``control_precision``), and prints one JSON line of its
readings:

- ``float32``: the program in float32 with TF32 off, at the
  configuration's depth, against the float32 reference: what the
  program's own arithmetic (its channels-last convolutions and batch
  normalisation, its loss and step) adds beyond float32 round-off;
- ``bfloat16.<blocks>``: the program in bfloat16 at each depth, and, as
  its control, the reference itself with every tensor that the program
  holds in bfloat16 rounded so. Where both read alike at every depth, and
  grow with it, bfloat16's round-off through the trunk accounts for the
  gap, and not the program.

Needs the cell's cards.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from benchmark import control, harness  # noqa: E402

harness.prepare_environment(REPO)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="agz40.train.b512")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--first-seed", type=int, default=3_500_000_001)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--blocks", type=int, nargs="+", default=[10, 20, 40])
    args = ap.parse_args(argv)
    seeds = range(args.first_seed, args.first_seed + args.seeds)
    bf16 = {"control_precision": "bfloat16"}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    arms = {"float32": {"config": {"compute_dtype": "float32"},
                        "traffic": bf16}}
    arms.update({f"bfloat16.{b}": {"config": {"blocks": b}, "traffic": bf16}
                 for b in args.blocks})
    for arm, overrides in arms.items():
        got = control.readings(args.workload, seeds, args.seconds,
                               overrides=overrides)
        print(json.dumps({"arm": arm, "seeds": list(seeds),
                          "program": got["program"],
                          "reference_bf16": got["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
