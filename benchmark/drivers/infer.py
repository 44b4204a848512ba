"""Bulk inference cells: the program's serving forward on large batches.

Set-up makes the weights on the card and a pool of ``pool_batches``
batches of ``batch`` packed records, with player and rank, on the host
from the seed, builds ``models.serving.make_log_prob_fn`` and calls it
``warmup_calls`` times. The window calls it back to back on the pool's
batches in turn until ``--seconds`` have passed: each call copies its
batch to the card, expands it, runs the network and returns the (batch,
361) log-probabilities to the host, so the host-to-device and
device-to-host copies stay in the window. The rate is the rows returned
over the window.

The judgement: from every call's answer, ``rows_per_call`` rows drawn from
the seed are kept; once the window has closed, ``judged_rows`` of them,
drawn from the seed, are computed by the reference in float32 from the same
records and weights, and the widest log-probability gap is compared. A run
judges the same number of rows whatever the length of its window.
"""

from __future__ import annotations

import time

import numpy as np

from .. import data
from .. import weights as weights_mod
from ..reference import compare, policy


def build_model(ctx, device):
    from deepgo_tpu_torch.models import policy_cnn
    import torch

    cfgd = ctx.cfg
    cfg = policy_cnn.ModelConfig(
        num_layers=cfgd["num_layers"], channels=cfgd["channels"],
        first_kernel=cfgd["first_kernel"], kernel=cfgd["kernel"],
        input_planes=cfgd["input_planes"], final_relu=cfgd["final_relu"],
        compute_dtype=cfgd["compute_dtype"])
    weights = weights_mod.make(cfgd, ctx.seed, device)
    with torch.device(device):
        model = policy_cnn.PolicyCNN(cfg)
    weights_mod.load_into(model, weights)
    return cfg, model, weights


def judge_rows(ctx, weights, packed, player, rank, rows) -> tuple:
    """(drift, control drift or None) of the kept rows against the
    reference computed from the same records."""
    import torch

    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (packed, player, rank)]
    ref = policy.log_probs(weights, *args).cpu().numpy()
    drift = compare.logp_drift(rows, ref, ctx.traffic["min_prob"])
    control = None
    if getattr(ctx, "control", False):
        low = policy.log_probs(weights, *args, precision="fp8").cpu().numpy()
        control = compare.logp_drift(low, ref, ctx.traffic["min_prob"])
    return drift, control


def run(ctx) -> dict:
    import torch

    from deepgo_tpu_torch.models import serving

    from .. import trace

    tr = ctx.traffic
    cuda = ctx.device == "cuda"
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    rng = np.random.default_rng(ctx.seed)
    pool = [data.records(rng, tr["batch"], tr["channel_max"])
            for _ in range(tr["pool_batches"])]
    cfg, model, weights = build_model(ctx, device)
    forward = serving.make_log_prob_fn(cfg, device=device)
    for i in range(tr["warmup_calls"]):
        forward(model, *pool[i % len(pool)])
    pick = np.random.default_rng(ctx.seed + 1)

    kept = []  # (pool index, row indices, rows)
    calls = [0]

    def drive(seconds: float) -> dict:
        """Forwards back to back for ``seconds``, each on the pool's next
        batch; each returns to the host, so the window ends synchronised."""
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            b = calls[0] % len(pool)
            out = forward(model, *pool[b])
            rows = pick.choice(tr["batch"], tr["rows_per_call"],
                               replace=False)
            kept.append((b, rows, out[rows].copy()))
            calls[0] += 1
            n += 1
        return {"calls": n, "rows": n * tr["batch"],
                "window_s": time.perf_counter() - t0}

    setup_s = time.perf_counter() - ctx.t_start
    if ctx.trace:
        summaries, counters = trace.phases(
            drive, tr["trace_seconds"], tr["host_trace_seconds"], 0)
        window = counters["clock"]
    else:
        summaries, counters = None, drive(ctx.seconds)
        window = counters
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del model, forward
    if cuda:
        torch.cuda.empty_cache()

    packed = np.concatenate([pool[b][0][r] for b, r, _ in kept])
    player = np.concatenate([pool[b][1][r] for b, r, _ in kept])
    rank = np.concatenate([pool[b][2][r] for b, r, _ in kept])
    rows = np.concatenate([x for _, _, x in kept])
    judged = pick.choice(len(rows), min(tr["judged_rows"], len(rows)),
                         replace=False)
    drift, control = judge_rows(ctx, weights, packed[judged], player[judged],
                                rank[judged], rows[judged])
    return {
        "setup_s": setup_s,
        "e2e": {"infer_boards_per_s": window["rows"] / window["window_s"]},
        "attempted": window["calls"], "failed": 0,
        "memory_peak_bytes": peak,
        "checks": {"logp_drift": (drift, ctx.limits["logp_drift"])},
        "control": {"program": {"logp_drift": drift},
                    "control": {"logp_drift": control}}
        if control is not None else None,
        "trace": summaries,
        "counters": counters,
    }
