"""Training cells of a dual-head network: AlphaGo Zero's residual network
trained on moves and game outcomes through the program's train step, fed
by its loader, on one card.

As ``drivers/train.py``, with the outcome column and batch normalisation:
set-up writes a synthetic split from the seed (``data.write_split``) and a
``winner.npy`` beside it (one winner a game, black or white, every game
decided), makes the leaves on the card (``weights_resnet``), and builds
one training object: ``models.resnet.DualResNet``, momentum SGD,
``training.steps.make_train_step`` over the nibble wire and
``data.loader.AsyncLoader(..., outcome=True)``. That object takes its
first three steps through the window's own call and feed, the parameters
read after the first and the third and the BN running statistics after
the third, then the traffic's warm-up steps, and goes on into the window.

The judgement, once the window has closed and the program's state is
freed: each row of the three batches, read back from the wire form, is
looked up among the split's raw records (a wrong player, rank, target or
outcome counts in ``rows_unmatched``), and the reference
(``reference/agz.py``) steps on them in float32 from the benchmark's
leaves. It compares ``train.py``'s numbers (``compare.train_gaps``) and
two more:

- ``head_gap``: ``grad_gap`` over the two heads' 12 leaves alone. The
  heads sit at the top of the backward, where bfloat16's round-off has not
  yet grown through 79 layers, so a wrong target (a move or an outcome)
  shows there far above the noise that the trunk's leaves carry;
- ``policy_fc_diff``: the norm of the first gradient's difference at the
  policy head's dense weight, over the reference's norm. That gradient is
  the move loss's own product of the logits' gradient and the head's
  features, so bfloat16 barely moves it, while a loss over other rows (a
  part of the batch, a wrong move) keeps its norm and turns its
  direction, which a gap of norms cannot see;
- ``stats_gap``: for the change of each BN layer's running mean and
  running variance over the three steps, the worst layer's gap between
  the run's norm and the reference's, over the reference's norm or the
  median layer's, whichever is larger.

The loss is compared (``loss_gap``) but not judged: bfloat16 and float8
move it alike, and no limit of the accepted cells leaves it room.

The traffic's ``control_precision`` (default ``"fp8"``, the control) sets
the precision that the reference is computed in for ``control``;
``benchmark/precision_witness.py`` sets it to ``"bfloat16"``. Set-up's
parts are printed to stderr, one line a run.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np

from .. import data, weights_resnet
from ..reference import agz, compare, policy
from .train import _readings


def _outcomes(rng: np.random.Generator, player: np.ndarray, games: int,
              game_positions: int) -> tuple[np.ndarray, np.ndarray]:
    """(z per position for its side to move, winner per position: 1 or 2,
    one draw a game)."""
    winner = np.repeat(rng.integers(1, 3, size=games), game_positions)
    z = np.where(winner == player, 1.0, -1.0).astype(np.float32)
    return z, winner.astype(np.int8)


def run(ctx) -> dict:
    import torch

    from deepgo_tpu_torch.data.dataset import GoDataset
    from deepgo_tpu_torch.data.loader import AsyncLoader
    from deepgo_tpu_torch.models import resnet
    from deepgo_tpu_torch.training import optimizers, steps

    from .. import trace

    tr, cfgd = ctx.traffic, ctx.cfg
    cuda = ctx.device == "cuda"
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    torch.set_num_threads(os.cpu_count() or 8)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    parts = {"start": time.perf_counter() - ctx.t_start}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name], t_part = now - t_part, now

    root = tempfile.mkdtemp(prefix="bench-split-")
    rng = np.random.default_rng(ctx.seed)
    raw = data.write_split(f"{root}/train", rng, tr["games"],
                           tr["game_positions"], tr["target_points"],
                           tr["channel_max"])
    raw["z"], winner = _outcomes(rng, raw["player"], tr["games"],
                                 tr["game_positions"])
    np.save(f"{root}/train/winner.npy", winner)
    part("split")
    cfg = resnet.ResNetConfig(
        blocks=cfgd["blocks"], channels=cfgd["channels"],
        input_planes=cfgd["input_planes"], value_hidden=cfgd["value_hidden"],
        compute_dtype=cfgd["compute_dtype"], bn_eps=cfgd["bn_eps"],
        bn_momentum=cfgd["bn_momentum"])
    leaves = weights_resnet.make(cfgd, ctx.seed, device)
    with torch.device(device):
        model = resnet.DualResNet(cfg)
    weights_resnet.load_into(model, leaves)
    sync()
    part("weights")
    optimizer = optimizers.sgd(tr["rate"], momentum=tr["momentum"])
    opt_state = optimizer.init(model)
    step = steps.make_train_step(cfg, optimizer, wire=tr["wire"])
    loader = AsyncLoader(GoDataset(root, "train"), tr["batch"],
                         seed=ctx.seed, num_threads=tr["loader_threads"],
                         prefetch=tr["prefetch"], device=device,
                         wire=tr["wire"],
                         device_prefetch=tr["device_prefetch"], outcome=True)
    part("loader")
    params = list(model.parameters())
    bns = {name: model.get_submodule(name) for name in agz.fresh_stats(leaves)}

    def snapshot():
        return [p.detach().clone() for p in params]

    def running():
        return {n: (bn.running_mean.detach().clone(),
                    bn.running_var.detach().clone())
                for n, bn in bns.items()}

    # the first three steps, through the window's own call and feed
    p0, s0 = snapshot(), running()
    captured, losses, p1 = [], [], None
    for i in range(3):
        batch = loader.get()
        captured.append({k: v.cpu() for k, v in batch.items()})
        model, opt_state, loss = step(model, opt_state, batch)
        losses.append(loss)
        if i == 0:
            p1 = snapshot()
    p3, s3 = snapshot(), running()
    losses = [float(x) for x in losses]
    part("first_steps")
    for _ in range(tr["warmup_steps"]):
        model, opt_state, loss = step(model, opt_state, loader.get())
    float(loss)
    part("warmup")

    state = {"model": model, "opt": opt_state, "loss": loss}

    def drive(seconds: float) -> dict:
        """Steps back to back for ``seconds``, the card synchronised at
        both ends."""
        sync()
        t0 = time.perf_counter()
        n, wait = 0, 0.0
        while time.perf_counter() - t0 < seconds:
            tw = time.perf_counter()
            batch = loader.get()
            wait += time.perf_counter() - tw
            state["model"], state["opt"], state["loss"] = step(
                state["model"], state["opt"], batch)
            n += 1
        sync()
        return {"steps": n, "window_s": time.perf_counter() - t0,
                "loader_wait_s": wait, "rows_per_card": tr["batch"]}

    setup_s = time.perf_counter() - ctx.t_start
    print("setup_parts_s " + " ".join(f"{k} {v:.3f}" for k, v in
                                      parts.items()), file=sys.stderr,
          flush=True)
    if ctx.trace:
        summaries, counters = trace.phases(
            drive, tr["trace_seconds"], tr["host_trace_seconds"],
            device.index if cuda else -1)
        window = counters["clock"]
    else:
        summaries, counters = None, drive(ctx.seconds)
        window = counters
    last_loss = float(state["loss"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    loader.close()
    del model, opt_state, step, batch, params, state, bns
    if cuda:
        torch.cuda.empty_cache()

    run_stats = [b - a for n in s0 for a, b in zip(s0[n], s3[n])]
    checks, control = _judge(ctx, raw, leaves, captured, losses, p0, p1, p3,
                             run_stats, device)
    shutil.rmtree(root, ignore_errors=True)
    return {
        "setup_s": setup_s,
        "e2e": {"train_samples_per_s":
                window["steps"] * tr["batch"] / window["window_s"]},
        "attempted": window["steps"],
        "failed": 0 if np.isfinite(last_loss) else 1,
        "memory_peak_bytes": peak,
        "checks": checks, "control": control,
        "trace": summaries, "counters": counters,
    }


def _reference_batches(raw: dict, captured: list, device):
    """The reference's batch for each of the three steps (the planes of the
    raw split's rows, ``x``, their ``target`` and ``z``), and the count of
    delivered rows that are no row of the split or carry another row's
    player, rank, target or outcome."""
    import torch

    index = {row.tobytes(): i for i, row in
             enumerate(raw["packed"].reshape(len(raw["packed"]), -1))}
    batches, unmatched = [], 0
    for rows in captured:
        wire = rows["packed"]
        packed = policy.unpack_nibbles(wire) if wire.dim() == 2 else wire
        keys = packed.reshape(packed.shape[0], -1).numpy()
        idx = np.array([index.get(k.tobytes(), -1) for k in keys])
        unmatched += int((idx < 0).sum())
        idx = np.maximum(idx, 0)
        for name in ("player", "rank", "target", "z"):
            got = rows[name].numpy()
            unmatched += int((got != raw[name][idx]).sum())
        found = {k: torch.from_numpy(raw[k][idx]).to(device)
                 for k in ("packed", "player", "rank", "target", "z")}
        batches.append({"x": policy.planes(found["packed"], found["player"],
                                           found["rank"]),
                        "target": found["target"], "z": found["z"]})
    return batches, unmatched


def head_gap(run: list, ref: list, head: np.ndarray) -> float:
    """Worst gap of first-gradient norms over the leaves ``head`` marks."""
    r = compare.leaf_norms([g for g, h in zip(ref, head) if h])
    got = compare.leaf_norms([g for g, h in zip(run, head) if h])
    return compare.worst_leaf_gap(got, r, np.ones(len(r), dtype=bool))


def policy_fc_diff(run: list, ref: list, names: list) -> float:
    """Norm of the first-gradient difference at ``policy_fc.weight`` over
    the reference's norm."""
    i = names.index("policy_fc.weight")
    return float(np.linalg.norm(run[i] - ref[i]) / np.linalg.norm(ref[i]))


def stats_gap(run: list, ref: list) -> float:
    """Worst BN layer's gap of the norms of its running mean's and running
    variance's change (each list: mean, var, mean, var, ... by layer)."""
    gaps = []
    for part in (slice(0, None, 2), slice(1, None, 2)):
        r = compare.leaf_norms(ref[part])
        keep = np.ones(len(r), dtype=bool)
        gaps.append(compare.worst_leaf_gap(compare.leaf_norms(run[part]), r,
                                           keep))
    return max(gaps)


def _judge(ctx, raw, leaves, captured, losses, p0, p1, p3, run_stats,
           device):
    """(checks, control): each number beside its limit, and with
    ``ctx.control`` the same numbers of the reference computed in fp8 in
    the program's place."""
    tr, cfgd = ctx.traffic, ctx.cfg
    batches, unmatched = _reference_batches(raw, captured, device)
    rate = tr["rate"]
    r = np.float32(rate)
    host = [[t.double().cpu().numpy() for t in ps] for ps in (p0, p1, p3)]
    run = _readings(losses, [(a - b) / r for a, b in zip(host[0], host[1])],
                    host[0], host[2])
    run_stats = [t.double().cpu().numpy() for t in run_stats]

    def flat(named):
        return [t.double().cpu().numpy() for t in named.values()]

    def readings(precision):
        fresh = agz.fresh_stats(leaves)
        ls, g1, after, stats = agz.sgd_steps(
            leaves, fresh, batches, rate, tr["momentum"], cfgd["l2"],
            bn_eps=cfgd["bn_eps"], bn_momentum=cfgd["bn_momentum"],
            precision=precision)
        out = _readings(ls, [g.double().cpu().numpy() for g in g1],
                        flat(leaves), flat(after[2]))
        out["stats"] = [(stats[n][k] - fresh[n][k]).double().cpu().numpy()
                        for n in fresh for k in ("mean", "var")]
        return out

    head = np.array([n.startswith(("policy_", "value_")) for n in leaves])

    def gaps(got, ref):
        return {**compare.train_gaps(got, ref),
                "head_gap": head_gap(got["grads"], ref["grads"], head),
                "policy_fc_diff": policy_fc_diff(got["grads"], ref["grads"],
                                                 list(leaves)),
                "stats_gap": stats_gap(got["stats"], ref["stats"])}

    ref = readings("float32")
    run["stats"] = run_stats
    found = gaps(run, ref)
    checks = {k: (v, ctx.limits[k]) for k, v in found.items()
              if k in ctx.limits}
    checks["rows_unmatched"] = (unmatched, ctx.limits["rows_unmatched"])
    control = None
    if getattr(ctx, "control", False):
        control = {"program": found,
                   "control": gaps(readings(
                       tr.get("control_precision", "fp8")), ref)}
    return checks, control
