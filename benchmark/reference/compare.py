"""The numbers that decide ``correct``: gaps between a run and the reference.

Plain numpy; nothing here imports the program.

Training is judged by the worst leaf (one leaf = one layer's weight or
bias): for the first gradient and for the change of the parameters over
the first three steps, the gap between the run's norm of a leaf and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger (some gradients are all but zero). A gap of norms is
blind to rounding, which moves a norm only in the second order, so the
first gradient is also judged by the norm of its difference from the
reference's, on the same scale, at the median leaf (the worst leaf's
reading of bfloat16 lies too near float8's to tell them apart). Leaves whose
reference gradient is under a thousandth of the median leaf's are left out:
they move by round-off alone. Serving is judged by the widest gap of a
log-probability, over the points the reference gives at least
``min_prob``.
"""

from __future__ import annotations

import numpy as np

NEGLIGIBLE = 1e-3  # of the median leaf's reference gradient norm


def leaf_norms(leaves) -> np.ndarray:
    return np.array([float(np.linalg.norm(np.asarray(x, dtype=np.float64)))
                     for x in leaves])


def worst_leaf_gap(run: np.ndarray, ref: np.ndarray, keep: np.ndarray
                   ) -> float:
    med = float(np.median(ref))
    gaps = np.abs(run - ref) / np.maximum(ref, med)
    return float(gaps[keep].max())


def train_gaps(run: dict, ref: dict) -> dict:
    """``run`` / ``ref``: {"losses": [L1, L2, L3], "grads": the first
    gradient by leaf, "changes": p3 - p0 by leaf} -> the compared numbers
    ``grad_gap`` and ``change_gap`` (worst leaf's gap of norms) and
    ``grad_diff`` (the median leaf's norm of the difference of the first
    gradients), and two that are read but not compared: ``loss_gap``, the
    widest relative gap of the three losses, and ``grad_diff_worst``, the
    worst leaf's difference."""
    g_ref = leaf_norms(ref["grads"])
    keep = g_ref >= NEGLIGIBLE * np.median(g_ref)
    losses = np.abs(np.asarray(run["losses"]) - np.asarray(ref["losses"]))
    diff = leaf_norms([a - b for a, b in zip(run["grads"], ref["grads"])])
    diff = (diff / np.maximum(g_ref, np.median(g_ref)))[keep]
    return {
        "loss_gap": float((losses / np.abs(ref["losses"])).max()),
        "grad_gap": worst_leaf_gap(leaf_norms(run["grads"]), g_ref, keep),
        "change_gap": worst_leaf_gap(leaf_norms(run["changes"]),
                                     leaf_norms(ref["changes"]), keep),
        "grad_diff": float(np.median(diff)),
        "grad_diff_worst": float(diff.max()),
    }


def logp_drift(run: np.ndarray, ref: np.ndarray, min_prob: float) -> float:
    """Widest |run - ref| of a log-probability over the points where the
    reference gives at least ``min_prob``; a non-finite run reads inf."""
    if not np.isfinite(run).all():
        return float("inf")
    mask = ref >= np.log(min_prob)
    return float(np.abs(run - ref)[mask].max())
