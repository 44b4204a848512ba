"""Train the value network: position -> P(side to move wins).

The port of ``tools/train_value.py``. Labels come from the winner sidecar
(``data/winners.py``): every position whose game has a decided result gets
z = 1 when the side to move won. The step expands the packed records on
the device (the hand-written CUDA kernel on the card, the plain version on
the CPU), runs ``ValueCNN`` in its compute dtype, takes the mean sigmoid
binary cross-entropy in float32, and updates the parameters in place with
the port's SGD. Checkpoints are the JAX package's value format
(``kind="value"``), which ``models.serving.load_value`` and the JAX
package read.

Usage:
  python -m deepgo_tpu_torch.training.value \\
      --data-root data/corpus/processed --iters 2000 --out runs/value

--data-root takes a comma-separated list of processed roots; batches are
sampled across them proportionally to decided-position counts. The tool
runs on ``--device`` (``cuda`` by default; it raises without CUDA).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import GoDataset, M_BLACK_RANK, M_PLAYER, M_WHITE_RANK
from ..experiments.checkpoint import save_checkpoint
from ..models import value_cnn
from ..models.convert import value_opt_state_to_jax, value_to_jax
from ..ops import expand_planes
from .optimizers import sgd


def decided_indices(ds: GoDataset, equal_rank: bool = False) -> np.ndarray:
    """Positions in decided games; ``equal_rank`` keeps only games whose
    players share a dan rank. The mixed-rank corpus leaks the pairing
    through the rank planes (8d-vs-4d is almost always an 8d win); on the
    equal-rank slice the planes carry no outcome information and accuracy
    measures board reading against ~50% chance."""
    if ds.winner is None:
        raise ValueError(f"no winner.npy in {ds.dir} — run "
                         "deepgo_tpu_torch.data.winners first")
    ix = np.nonzero(ds.winner != 0)[0]
    if equal_rank:
        meta = ds.meta[ix]
        ix = ix[meta[:, M_BLACK_RANK] == meta[:, M_WHITE_RANK]]
    return ix


def gather(ds: GoDataset, idx: np.ndarray):
    """(packed, player, rank, z) host arrays of the positions ``idx``; z is
    1.0 where the side to move won."""
    packed = np.asarray(ds.planes[idx])
    meta = ds.meta[idx]
    player = meta[:, M_PLAYER].astype(np.int32)
    rank = np.where(player == 1, meta[:, M_BLACK_RANK],
                    meta[:, M_WHITE_RANK]).astype(np.int32)
    z = (ds.winner[idx] == player).astype(np.float32)
    return packed, player, rank, z


def to_tensors(batch, device) -> tuple[torch.Tensor, ...]:
    """A ``gather`` batch -> contiguous tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in batch)


def bce_from_logits(logits: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy in float32, in the JAX tool's form
    ``max(l, 0) - l * z + log1p(exp(-|l|))``."""
    logits = logits.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * z
                      + torch.log1p(torch.exp(-logits.abs())))


def make_step(cfg: value_cnn.ValueConfig, optimizer):
    """Returns (step, evaluate) over tensors on the model's device:
    ``step(model, opt_state, packed, player, rank, z) -> (model, opt_state,
    loss)`` updates the model in place; ``evaluate(model, packed, player,
    rank, z) -> (loss, accuracy)``. Losses are 0-d float32 tensors on the
    device."""

    def loss_fn(model, packed, player, rank, z):
        logits = model(expand_planes(packed, player, rank,
                                     dtype=cfg.torch_dtype))
        return bce_from_logits(logits, z), logits

    def step(model, opt_state, packed, player, rank, z):
        with torch.enable_grad():
            loss, _ = loss_fn(model, packed, player, rank, z)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        opt_state = optimizer.update(model, list(grads), opt_state)
        return model, opt_state, loss.detach()

    @torch.no_grad()
    def evaluate(model, packed, player, rank, z):
        loss, logits = loss_fn(model, packed, player, rank, z)
        acc = ((logits > 0) == (z > 0.5)).float().mean()
        return loss, acc

    return step, evaluate


def main(argv=None) -> dict:
    """Train, write ``<out>/value_checkpoint.npz`` and return
    ``{"final": the last validation record, "history": every validation
    record, "path": the checkpoint}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-root", default="data/corpus/processed")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--rate", type=float, default=0.02)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--num-layers", type=int, default=3)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-interval", type=int, default=500)
    ap.add_argument("--val-size", type=int, default=4096)
    ap.add_argument("--print-interval", type=int, default=100)
    ap.add_argument("--out", default="runs/value")
    ap.add_argument("--equal-rank", action="store_true",
                    help="train/evaluate only on games between equal-rank "
                         "players: removes the rank-plane outcome shortcut "
                         "so accuracy is measured against ~50%% chance")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = value_cnn.ValueConfig(num_layers=args.num_layers,
                                channels=args.channels)
    roots = [r for r in args.data_root.split(",") if r]
    trains = [GoDataset(r, "train") for r in roots]
    vals = [GoDataset(r, "validation") for r in roots]
    tr_sets = [(d, decided_indices(d, args.equal_rank)) for d in trains]
    rng = np.random.default_rng(args.seed)
    sizes = np.array([len(ix) for _, ix in tr_sets], dtype=np.float64)
    if sizes.sum() <= 0:
        raise ValueError(
            "no decided training positions after filtering"
            + (" (--equal-rank: no equal-rank decided games in these roots)"
               if args.equal_rank else ""))
    weights = sizes / sizes.sum()
    # the validation probe is drawn from each root in proportion to its
    # TRAIN decided-position weight: it mirrors the sampling mixture
    va_parts = []
    for w, d in zip(weights, vals):
        ix = decided_indices(d, args.equal_rank)
        want = max(1, int(round(args.val_size * w))) if w > 0 else 0
        take = min(want, len(ix))
        if take == 0:
            if w > 0:
                print(f"warning: {d.dir} has no decided validation "
                      "positions; probe omits this root entirely",
                      flush=True)
            continue
        if take < want:
            print(f"warning: {d.dir} has only {len(ix)} decided validation "
                  f"positions (wanted {want}); probe under-represents this "
                  "root relative to the training mixture", flush=True)
        va_parts.append(gather(d, rng.choice(ix, size=take, replace=False)))
    if not va_parts:
        raise ValueError("no root contributed validation positions")
    va_batch = to_tensors(tuple(np.concatenate([p[j] for p in va_parts])
                                for j in range(4)), device)
    # the probe's majority-class rate is the chance floor for accuracy
    z_rate = float(va_batch[3].mean())
    print(f"train positions (decided{' equal-rank' if args.equal_rank else ''} "
          f"games): {int(sizes.sum()):,} of "
          f"{sum(len(d) for d in trains):,} across {len(roots)} root(s); "
          f"val probe {len(va_batch[0]):,}, chance floor "
          f"{max(z_rate, 1 - z_rate):.3f}", flush=True)

    def sample_batch(n: int):
        if len(tr_sets) == 1:
            ds, ix = tr_sets[0]
            return gather(ds, rng.choice(ix, size=n))
        counts = rng.multinomial(n, weights)
        parts = [gather(ds, rng.choice(ix, size=c))
                 for c, (ds, ix) in zip(counts, tr_sets) if c]
        return tuple(np.concatenate([p[j] for p in parts])
                     for j in range(4))

    optimizer = sgd(args.rate, 0.0, args.momentum)
    model = value_cnn.init(torch.Generator().manual_seed(args.seed), cfg,
                           device=device)
    opt_state = optimizer.init(model)
    step, evaluate = make_step(cfg, optimizer)

    os.makedirs(args.out, exist_ok=True)
    history = []
    ewma = None
    t0 = time.time()
    for i in range(1, args.iters + 1):
        batch = to_tensors(sample_batch(args.batch_size), device)
        model, opt_state, loss = step(model, opt_state, *batch)
        if i % args.print_interval == 0:
            loss = float(loss)
            ewma = loss if ewma is None else 0.95 * ewma + 0.05 * loss
            rate_s = i * args.batch_size / (time.time() - t0)
            print(f"value training {ewma:.4f} "
                  f"(samples per second {rate_s:.0f})", flush=True)
        if i % args.val_interval == 0 or i == args.iters:
            vl, va = evaluate(model, *va_batch)
            history.append({"step": i, "val_loss": float(vl),
                            "val_accuracy": float(va)})
            print(f"value validation at {i}: loss={float(vl):.4f} "
                  f"accuracy={float(va):.4f}", flush=True)
    path = os.path.join(args.out, "value_checkpoint.npz")
    save_checkpoint(path, value_to_jax(model),
                    value_opt_state_to_jax(opt_state), {
                        "kind": "value",
                        "config": {"num_layers": cfg.num_layers,
                                   "channels": cfg.channels,
                                   "head_hidden": cfg.head_hidden},
                        "step": args.iters,
                        "equal_rank": args.equal_rank,
                        "validation_history": history,
                    })
    print(f"saved {path}")
    final = history[-1] if history else None
    print(json.dumps({"final": final}))
    return {"final": final, "history": history, "path": path}


if __name__ == "__main__":
    main()
