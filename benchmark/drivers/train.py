"""Training cells: the program's train step, fed by its loader, on one card.

Set-up writes a synthetic split from the seed (``data.write_split``) into
a temporary directory, makes the weights on the card, and builds one
training object: the network, SGD's state, ``training.steps.
make_train_step`` over the nibble wire and ``data.loader.AsyncLoader``.
That object takes its first three steps through the window's own call and
feed, the parameters read after the first and the third, then the traffic's
warm-up steps, and goes on into the window. The window runs steps back to
back until ``--seconds`` have passed on the host clock, then waits for the
card; the rate is every sample of the window over all its time.

The judgement, once the window has closed and the program's state is
freed: each row of the three batches, read back from the wire form with the
reference's own decoder, is looked up among the split's raw records, which
the reference then steps on in float32 from the benchmark's weights. It
compares each step's loss, each leaf's norm of the first gradient (the
run's worked out from its parameters: (p0 - p1) / rate) and of the change
over the three steps, and the norm of the first gradient's difference
from the reference's.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from .. import data
from .. import weights as weights_mod
from ..reference import compare, policy


def run(ctx) -> dict:
    import torch

    from deepgo_tpu_torch.data.dataset import GoDataset
    from deepgo_tpu_torch.data.loader import AsyncLoader
    from deepgo_tpu_torch.models import policy_cnn
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

    root = tempfile.mkdtemp(prefix="bench-split-")
    raw = data.write_split(f"{root}/train", np.random.default_rng(ctx.seed),
                           tr["games"], tr["game_positions"],
                           tr["target_points"], tr["channel_max"])
    cfg = policy_cnn.ModelConfig(
        num_layers=cfgd["num_layers"], channels=cfgd["channels"],
        first_kernel=cfgd["first_kernel"], kernel=cfgd["kernel"],
        input_planes=cfgd["input_planes"], final_relu=cfgd["final_relu"],
        compute_dtype=cfgd["compute_dtype"])
    weights = weights_mod.make(cfgd, ctx.seed, device)
    with torch.device(device):
        model = policy_cnn.PolicyCNN(cfg)
    weights_mod.load_into(model, weights)
    optimizer = optimizers.sgd(tr["rate"])
    opt_state = optimizer.init(model)
    step = steps.make_train_step(cfg, optimizer, wire=tr["wire"])
    loader = AsyncLoader(GoDataset(root, "train"), tr["batch"],
                         seed=ctx.seed, num_threads=tr["loader_threads"],
                         prefetch=tr["prefetch"], device=device,
                         wire=tr["wire"],
                         device_prefetch=tr["device_prefetch"])
    params = list(model.parameters())

    def snapshot():
        return [p.detach().clone() for p in params]

    # the first three steps, through the window's own call and feed
    p0 = snapshot()
    captured, losses, p1 = [], [], None
    for i in range(3):
        batch = loader.get()
        captured.append({k: v.cpu() for k, v in batch.items()})
        model, opt_state, loss = step(model, opt_state, batch)
        losses.append(loss)
        if i == 0:
            p1 = snapshot()
    p3 = snapshot()
    losses = [float(x) for x in losses]
    for _ in range(tr["warmup_steps"]):
        model, opt_state, loss = step(model, opt_state, loader.get())
    float(loss)

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
    del model, opt_state, step, batch, params, state
    if cuda:
        torch.cuda.empty_cache()

    checks, control = _judge(ctx, raw, weights, captured, losses, p0, p1,
                             p3, tr["rate"], device)
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
    """The raw split's rows for each of the three steps, and the count of
    delivered rows that are no row of the split or carry another row's
    player, rank or target."""
    import torch

    index = {row.tobytes(): i for i, row in
             enumerate(raw["packed"].reshape(len(raw["packed"]), -1))}
    batches, unmatched = [], 0
    for s in range(3):
        rows = captured[s]
        wire = rows["packed"]
        packed = policy.unpack_nibbles(wire) if wire.dim() == 2 else wire
        keys = packed.reshape(packed.shape[0], -1).numpy()
        idx = np.array([index.get(k.tobytes(), -1) for k in keys])
        unmatched += int((idx < 0).sum())
        idx = np.maximum(idx, 0)
        for name in ("player", "rank", "target"):
            got = rows[name].numpy()
            unmatched += int((got != raw[name][idx]).sum())
        batches.append({k: torch.from_numpy(raw[k][idx]).to(device)
                        for k in ("packed", "player", "rank", "target")})
    return batches, unmatched


def _readings(losses, first_grads, p0, p3) -> dict:
    return {"losses": losses, "grads": first_grads,
            "changes": [b - a for a, b in zip(p0, p3)]}


def _judge(ctx, raw, weights, captured, losses, p0, p1, p3, rate, device):
    """(checks, control): each number beside its limit, and with
    ``ctx.control`` the same numbers of the reference computed in fp8 in
    the program's place."""
    batches, unmatched = _reference_batches(raw, captured, device)
    r = np.float32(rate)
    host = [[t.double().cpu().numpy() for t in ps] for ps in (p0, p1, p3)]
    run = _readings(losses, [(a - b) / r for a, b in zip(host[0], host[1])],
                    host[0], host[2])

    def flat(pairs):
        return [t.double().cpu().numpy() for wb in pairs for t in wb]

    def readings(precision):
        ls, g1, after = policy.sgd_steps(weights, batches, rate, precision)
        return _readings(ls, [g.double().cpu().numpy() for g in g1],
                         flat(weights), flat(after[2]))

    ref = readings("float32")
    gaps = compare.train_gaps(run, ref)
    checks = {k: (v, ctx.limits[k]) for k, v in gaps.items()
              if k in ctx.limits}
    checks["rows_unmatched"] = (unmatched, ctx.limits["rows_unmatched"])
    control = None
    if getattr(ctx, "control", False):
        control = {"program": gaps,
                   "control": compare.train_gaps(readings("fp8"), ref)}
    return checks, control
