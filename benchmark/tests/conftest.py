"""Test configuration of the benchmark's own tests.

The tests run on the CPU at tiny sizes. Those marked ``card`` need the
cells' CUDA cards and skip without them: each decides inside the test, so
that every worker collects the same tests. On the card:

    python3 -m pytest benchmark/tests -m card
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = {"config": {"num_layers": 3, "channels": 16}}
TRAFFIC = {
    "train": {"batch": 16, "games": 20, "game_positions": 20,
              "warmup_steps": 2, "trace_seconds": 0.3,
              "host_trace_seconds": 0.2},
    "infer": {"batch": 64, "pool_batches": 2, "warmup_calls": 1,
              "trace_seconds": 0.3, "host_trace_seconds": 0.2},
}


def tiny(kind: str, **traffic) -> dict:
    """Overrides that shrink a cell of ``kind`` to a CPU test's size."""
    return {**TINY, "traffic": {**TRAFFIC[kind], **traffic}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the cells' CUDA cards; skips without them")
