"""The control: the reference put in the program's place in the precision
below the configuration's (fp8 for bf16), which ``correct`` must refuse.

On the CPU, at a test's size, the control reads at least three times what
the program reads on the number that separates them. On the card
(``-m card``), at each cell's own size on three seeds, the program comes
out correct and the control, judged by the same limits, not correct.
"""

import json
import time
from pathlib import Path

import pytest

from benchmark import control, harness
from benchmark.tests.conftest import REPO, tiny

SPEC = json.loads((Path(REPO) / "BENCHMARK.json").read_text())
SEPARATING = {"train": "grad_diff", "infer": "logp_drift"}
# a batch of 64 rows, where the median leaf's gradient is steady enough to
# separate bfloat16 from fp8 at a test's width
SIZE = {"train": {"batch": 64}, "infer": {}}


def _kind(workload):
    files = harness.cell_files(SPEC, workload, Path(REPO))
    return files["traffic"]["kind"], files["limits"]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]
                                      if w["chips"] == 1])
def test_the_control_reads_well_above_the_program(workload):
    kind, _ = _kind(workload)
    got = control.readings(workload, [21, 22], 0.3, device="cpu",
                           overrides=tiny(kind, **SIZE[kind]))
    number = SEPARATING[kind]
    assert got["control_min"][number] >= 3 * got["program_max"][number]


def test_a_line_carries_the_control_only_when_asked():
    line = harness.run(["--workload", "full.infer.b8192", "--seed", "3",
                        "--seconds", "0.2"], time.perf_counter(),
                       device="cpu", overrides=tiny("infer"))
    assert "control" not in line and list(line)[-1] == "checks"


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_control_is_judged_by_the_cells_limits(workload):
    """The control's verdict comes from the same rule as ``correct``: under
    limits far above its readings it is correct, under limits of 0 not."""
    kind, limits = _kind(workload)

    def verdict(scale):
        line = harness.run(["--workload", workload, "--seed", "3",
                            "--seconds", "0.2"], time.perf_counter(),
                           device="cpu", control=True,
                           overrides={**tiny(kind), "limits": {
                               k: v * scale for k, v in limits.items()}})
        return line["control"]["correct"]

    assert verdict(1e6) and not verdict(0.0)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_on_the_card_the_limits_sit_between_program_and_control(workload):
    import torch

    chips = {w["name"]: w["chips"] for w in SPEC["workloads"]}[workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    got = control.readings(workload, [4_200_000_001 + i for i in range(3)],
                           2.0)
    for v in got["verdicts"]:
        assert v["correct"] and not v["control_correct"], (v, got)
