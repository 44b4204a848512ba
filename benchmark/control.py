"""Readings that the limits of ``correct`` are set from.

    python3 benchmark/control.py --workload <name> --seeds 12 --seconds 3

Runs the cell on one seed after another in this process (each a whole run:
set-up, a short window, the judgement) and prints, per seed, the numbers
the run compared and the same numbers of the control: the reference put in
the program's place and computed in float8 e4m3, the precision below the
configuration's bfloat16. With ``--patch`` a fault of ``faults.py`` is
planted first, and the program's numbers are the fault's readings. Each
seed's line also gives both verdicts, by the cell's limits: the program's
``correct`` and the control's, which has to come out false. Last, one JSON
line: per number the largest reading of the program (the lower reading)
and the smallest of the control (the upper reading), and both verdicts per
seed. Exits 1 if the control came out correct on any seed. Needs the
cell's cards.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402

harness.prepare_environment(REPO)


def readings(workload: str, seeds, seconds: float, device: str = "cuda",
             overrides=None, patch=None) -> dict:
    program, control, verdicts = {}, {}, []
    for seed in seeds:
        line = harness.run(["--workload", workload, "--seed", str(seed),
                            "--seconds", str(seconds)], time.perf_counter(),
                           device=device, overrides=overrides, control=True,
                           patch=patch)
        got = {**line["control"]["program"],
               **{k: c["value"] for k, c in line["checks"].items()}}
        low = line["control"]["control"]
        verdicts.append({"seed": seed, "correct": line["correct"],
                         "control_correct": line["control"]["correct"]})
        print(f"seed {seed}: program {got} correct {line['correct']}; "
              f"control {low} correct {line['control']['correct']}",
              flush=True)
        for k, v in got.items():
            program.setdefault(k, []).append(v)
        for k, v in low.items():
            control.setdefault(k, []).append(v)
    return {"workload": workload, "seeds": list(seeds),
            "program_max": {k: max(v) for k, v in program.items()},
            "control_min": {k: min(v) for k, v in control.items()},
            "verdicts": verdicts, "program": program, "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--patch", help="a fault of benchmark/faults.py, as "
                    "benchmark.faults:<name>, planted before each run")
    args = ap.parse_args(argv)
    seeds = range(args.first_seed, args.first_seed + args.seeds)
    got = readings(args.workload, seeds, args.seconds, patch=args.patch)
    print(json.dumps(got), flush=True)
    return int(any(v["control_correct"] for v in got["verdicts"]))


if __name__ == "__main__":
    sys.exit(main())
