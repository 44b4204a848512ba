"""The port's training step against the JAX package's, on shared state.

Weights, optimizer states and batches are made with numpy and handed to
both packages (``models/convert.py`` carries them across); the JAX side
expands with ``expand_backend="xla"``, which the JAX package's own tests
hold equal to its Pallas kernel in interpret mode. Bars:

* the nibble wire: bitwise. One optimizer update: bitwise against the
  JAX update under ``jax.jit`` (XLA's fused multiply-adds included), but
  for Adagrad's parameters: XLA:CPU computes ``x / sqrt(y)`` as ``x *
  rsqrt(y)`` with an approximate rsqrt (measured: 1 ulp off the correctly
  rounded value on 14 % of inputs), the port divides; there the bar is
  ``ADAGRAD_MAX_ULP`` ulps of |p| + |p'|.
* one float32 train step: loss within 1e-5 relative, every updated
  parameter and optimizer leaf within 1e-5 max-abs (the two packages sum
  the convolutions' gradients in another order).
* K = 4 chained steps in one call: bitwise equal to four single port steps
  on the CPU, and within the float32 bars of JAX's scanned call.
* one bfloat16 step: loss within ``BF16_LOSS_TOL`` of JAX's bf16 loss, and
  each leaf's update (new - old) with cosine >= 0.99 to JAX's. bf16
  may round at other places in the two frameworks; measured on these
  inputs (3 layers x 16 channels, B = 12): loss difference 9.5e-7,
  smallest cosine 0.99997.
* remat: gradients bitwise equal with and without it.
* the eval step, float32: sum_nll within 1e-4; top-1 counts equal on rows
  whose top-1 logit margin is >= 1e-4, and the totals differ by no more
  than the rows below it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepgo_tpu.models import policy_cnn as jax_policy
from deepgo_tpu.ops import wire as jax_wire
from deepgo_tpu.training import optimizers as jax_opt
from deepgo_tpu.training import steps as jax_steps

from deepgo_tpu_torch.experiments.checkpoint import tree_leaves
from deepgo_tpu_torch.models import convert, policy_cnn
from deepgo_tpu_torch.ops import wire
from deepgo_tpu_torch.training import optimizers, steps

from test_torch_policy import numpy_tree

torch.set_num_threads(2)

F32_LOSS_RTOL = 1e-5
F32_LEAF_TOL = 1e-5
BF16_LOSS_TOL = 1e-4
BF16_MIN_COSINE = 0.99
ADAGRAD_MAX_ULP = 2
EVAL_NLL_TOL = 1e-4
TOP1_MARGIN = 1e-4
B = 12


def model_cfg(dtype="float32", **kw):
    return policy_cnn.ModelConfig(**{"num_layers": 3, "channels": 16,
                                     "compute_dtype": dtype, **kw})


def jax_cfg(cfg):
    return jax_policy.ModelConfig(**dataclasses.asdict(cfg))


def make_batch(n=B, seed=0, augment=False, nibble=False):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 20, size=(n, 9, 19, 19), dtype=np.uint8)
    packed[:, 0] %= 3  # stones
    batch = {"packed": packed,
             "player": rng.integers(1, 3, size=n).astype(np.int32),
             "rank": rng.integers(1, 10, size=n).astype(np.int32),
             "target": rng.integers(0, 361, size=n).astype(np.int32)}
    if augment:
        batch["sym"] = rng.integers(0, 8, size=n).astype(np.int32)
    if nibble:
        batch["packed"] = wire.nibble_pack_np(packed)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def numpy_state(opt_name, cfg, seed=5):
    """A non-trivial optimizer state, JAX layout: a rate, and a random
    velocity or a random positive accumulator."""
    state = {"rate": np.float32(0.05)}
    tree = numpy_tree(cfg, seed=seed, bias_scale=0.01)
    if opt_name == "momentum":
        state["velocity"] = tree
    elif opt_name == "adagrad":
        state["accum"] = jax.tree.map(
            lambda a: (np.abs(a) + 0.01).astype(np.float32), tree)
    return state


def make_opts(opt_name):
    if opt_name == "sgd":
        return jax_opt.sgd(0.05, 1e-3), optimizers.sgd(0.05, 1e-3)
    if opt_name == "momentum":
        return (jax_opt.sgd(0.05, 1e-3, momentum=0.9),
                optimizers.sgd(0.05, 1e-3, momentum=0.9))
    return jax_opt.adagrad(0.05), optimizers.adagrad(0.05)


def leaves(params_tree, state_tree):
    return ([np.asarray(x) for x in tree_leaves(params_tree)],
            [np.asarray(x) for x in tree_leaves(state_tree)])


def port_leaves(model, state):
    return leaves(convert.params_to_jax(model),
                  convert.opt_state_to_jax(state))


def jax_leaves(params, state):
    return ([np.asarray(x) for x in jax.tree.leaves(params)],
            [np.asarray(x) for x in jax.tree.leaves(state)])


def max_abs(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


# ---- wire ----


@pytest.mark.parametrize("lead", [(), (1,), (7,), (3, 5)])
def test_nibble_wire_bitwise(lead):
    rng = np.random.default_rng(len(lead) * 10 + sum(lead))
    packed = rng.integers(0, 256, size=(*lead, 9, 19, 19), dtype=np.uint8)
    packed.reshape(-1)[:64] = np.arange(64)  # every value around 15
    got = wire.nibble_pack_np(packed)
    want = jax_wire.nibble_pack_np(packed)
    assert got.shape == want.shape == (*lead, wire.WIRE_BYTES)
    assert np.array_equal(got, want)
    unpacked = wire.nibble_unpack(torch.from_numpy(got)).numpy()
    assert np.array_equal(unpacked, np.asarray(jax_wire.nibble_unpack(
        jnp.asarray(want))))
    assert np.array_equal(unpacked, np.minimum(packed, 15))


def test_nibble_pack_refuses_other_shapes():
    with pytest.raises(ValueError):
        wire.nibble_pack_np(np.zeros((2, 9, 19, 18), np.uint8))


# ---- optimizers ----


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adagrad"])
def test_optimizer_update_bitwise(opt_name):
    cfg = model_cfg()
    tree = numpy_tree(cfg, seed=1)
    grads_tree = numpy_tree(cfg, seed=2, bias_scale=0.3)
    state_np = numpy_state(opt_name, cfg)
    jopt, opt = make_opts(opt_name)
    jparams, jstate = jax.jit(jopt.update)(
        jax_tree(tree), jax_tree(grads_tree), jax_tree(state_np))

    model = convert.model_from_jax(tree, cfg, device="cpu")
    named = convert.params_from_jax(grads_tree)
    grads = [named[n] for n, _ in model.named_parameters()]
    state = opt.update(model, grads, convert.opt_state_from_jax(
        state_np, device="cpu"))
    got_p, got_s = port_leaves(model, state)
    want_p, want_s = jax_leaves(jparams, jstate)
    assert [a.shape for a in got_s] == [a.shape for a in want_s]
    for a, b in zip(got_s, want_s):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b, old in zip(got_p, want_p, tree_leaves(tree)):
        assert a.dtype == b.dtype == np.float32
        if opt_name != "adagrad":
            assert np.array_equal(a, b)
        else:  # the step's error, in ulps of the operands of p - step
            ulp = np.spacing(np.abs(old) + np.abs(b))
            assert np.all(np.abs(a - b) <= ADAGRAD_MAX_ULP * ulp)


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adagrad"])
def test_optimizer_state_leaf_order(opt_name):
    cfg = model_cfg(channels=(16, 8))
    jopt, opt = make_opts(opt_name)
    jstate = jopt.init(jax_tree(numpy_tree(cfg)))
    model = convert.model_from_jax(numpy_tree(cfg), cfg, device="cpu")
    state = opt.init(model)
    assert state["rate"].dtype == torch.float32 and state["rate"].dim() == 0
    got = tree_leaves(convert.opt_state_to_jax(state))
    want = jax.tree.leaves(jstate)
    assert [(a.shape, a.dtype) for a in got] == \
        [(a.shape, a.dtype) for a in want]
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(got, want))
    back = convert.opt_state_from_jax(convert.opt_state_to_jax(state), "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(convert.opt_state_to_jax(back)), got))


def test_rate_decays_in_float32_like_jax():
    jopt, opt = make_opts("sgd")
    cfg = model_cfg(num_layers=2, channels=4)
    tree = numpy_tree(cfg)
    zeros = jax.tree.map(np.zeros_like, tree)
    jstate = jopt.init(jax_tree(tree))
    update = jax.jit(jopt.update)
    model = convert.model_from_jax(tree, cfg, device="cpu")
    state = opt.init(model)
    grads = [torch.zeros_like(p) for p in model.parameters()]
    for _ in range(300):
        _, jstate = update(jax_tree(tree), jax_tree(zeros), jstate)
        state = opt.update(model, grads, state)
    assert state["rate"].numpy().tobytes() == \
        np.asarray(jstate["rate"]).tobytes()


# ---- train step ----


def run_both(cfg, opt_name="sgd", augment=False, nibble=False,
             anchor=False, seed=0):
    tree = numpy_tree(cfg, seed=seed)
    state_np = numpy_state(opt_name, cfg)
    batch = make_batch(seed=seed + 1, augment=augment, nibble=nibble)
    jopt, opt = make_opts(opt_name)
    wire_name = "nibble" if nibble else "packed"
    j_anchor = p_anchor = None
    if anchor:
        a_cfg = model_cfg(num_layers=2, channels=8)
        a_tree = numpy_tree(a_cfg, seed=9, bias_scale=1.0)
        j_anchor = (jax_tree(a_tree), jax_cfg(a_cfg), 0.5)
        p_anchor = (convert.model_from_jax(a_tree, a_cfg, device="cpu"),
                    a_cfg, 0.5)
    jstep = jax_steps.make_train_step(
        jax_cfg(cfg), jopt, expand_backend="xla", augment=augment,
        anchor=j_anchor, wire=wire_name)
    jparams, jstate, jloss = jstep(jax_tree(tree), jax_tree(state_np),
                                   jax_tree(batch))
    step = steps.make_train_step(cfg, opt, augment=augment,
                                 anchor=p_anchor, wire=wire_name)
    model = convert.model_from_jax(tree, cfg, device="cpu")
    model, state, loss = step(model, convert.opt_state_from_jax(
        state_np, "cpu"), torch_batch(batch))
    return tree, (model, state, loss), (jparams, jstate, jloss)


@pytest.mark.parametrize("opt_name,augment,nibble,anchor", [
    ("sgd", False, False, False),
    ("sgd", True, False, False),
    ("sgd", False, True, False),
    ("sgd", False, False, True),
    ("momentum", True, True, False),
    ("adagrad", False, False, False),
    ("adagrad", True, True, True),
])
def test_train_step_f32_matches_jax(opt_name, augment, nibble, anchor):
    _, (model, state, loss), (jparams, jstate, jloss) = run_both(
        model_cfg(), opt_name, augment, nibble, anchor)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - float(jloss)) <= F32_LOSS_RTOL * abs(
        float(jloss))
    got_p, got_s = port_leaves(model, state)
    want_p, want_s = jax_leaves(jparams, jstate)
    assert max_abs(got_p, want_p) <= F32_LEAF_TOL
    assert max_abs(got_s, want_s) <= F32_LEAF_TOL


def test_train_step_bf16_matches_jax():
    cfg = model_cfg("bfloat16")
    tree, (model, _, loss), (jparams, _, jloss) = run_both(
        cfg, "sgd", augment=True)
    assert abs(float(loss) - float(jloss)) <= BF16_LOSS_TOL
    got, _ = port_leaves(model, {"rate": torch.tensor(0.0)})
    before = [np.asarray(x) for x in tree_leaves(tree)]
    for new, want, old in zip(got, jax.tree.leaves(jparams), before):
        a, b = (new - old).ravel(), (np.asarray(want) - old).ravel()
        cosine = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cosine >= BF16_MIN_COSINE


def superbatch(k, seed=0, **kw):
    parts = [make_batch(seed=seed + i, **kw) for i in range(k)]
    return {n: np.stack([p[n] for p in parts]) for n in parts[0]}


def test_train_step_many_equals_single_steps_and_jax():
    cfg, k = model_cfg(), 4
    tree = numpy_tree(cfg, seed=3)
    state_np = numpy_state("momentum", cfg)
    jopt, opt = make_opts("momentum")
    batches = superbatch(k, seed=20, augment=True, nibble=True)
    kw = dict(augment=True, wire="nibble")

    many = steps.make_train_step_many(cfg, opt, **kw)
    model, state, losses = many(
        convert.model_from_jax(tree, cfg, device="cpu"),
        convert.opt_state_from_jax(state_np, "cpu"), torch_batch(batches))
    assert losses.shape == (k,) and losses.dtype == torch.float32

    single = steps.make_train_step(cfg, opt, **kw)
    m1 = convert.model_from_jax(tree, cfg, device="cpu")
    s1 = convert.opt_state_from_jax(state_np, "cpu")
    singles = []
    for i in range(k):
        m1, s1, loss = single(m1, s1, torch_batch(
            {n: v[i] for n, v in batches.items()}))
        singles.append(loss)
    assert torch.equal(losses, torch.stack(singles))
    for a, b in zip(*(sum(port_leaves(m, s), []) for m, s in
                      ((model, state), (m1, s1)))):
        assert np.array_equal(a, b)

    jmany = jax_steps.make_train_step_many(jax_cfg(cfg), jopt,
                                           expand_backend="xla", **kw)
    jparams, jstate, jlosses = jmany(jax_tree(tree), jax_tree(state_np),
                                     jax_tree(batches))
    assert np.abs(losses.numpy() - np.asarray(jlosses)).max() <= \
        F32_LOSS_RTOL * np.abs(np.asarray(jlosses)).max()
    got_p, got_s = port_leaves(model, state)
    want_p, want_s = jax_leaves(jparams, jstate)
    assert max_abs(got_p + got_s, want_p + want_s) <= F32_LEAF_TOL


def test_train_step_many_on_fixed_batch_falls():
    cfg, k = model_cfg(), 10
    one = make_batch(seed=4)
    batches = {n: np.stack([v] * k) for n, v in one.items()}
    model = convert.model_from_jax(numpy_tree(cfg), cfg, device="cpu")
    opt = optimizers.sgd(0.1)
    many = steps.make_train_step_many(cfg, opt)
    _, _, losses = many(model, opt.init(model), torch_batch(batches))
    assert torch.isfinite(losses).all() and losses[-1] < losses[0]


def test_collective_site_checked_before_each_call():
    from deepgo_tpu_torch.utils import faults

    cfg = model_cfg(num_layers=2, channels=4)
    opt = optimizers.sgd(0.1)
    step = steps.make_train_step(cfg, opt, collective_site="dist_collective")
    model = convert.model_from_jax(numpy_tree(cfg), cfg, device="cpu")
    state = opt.init(model)
    before = [p.detach().clone() for p in model.parameters()]
    faults.install("dist_collective:fail@1")
    try:
        with pytest.raises(faults.InjectedFailure):
            step(model, state, torch_batch(make_batch()))
    finally:
        faults.reset()
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 model.parameters()))


def test_step_refuses_a_model_of_another_config():
    opt = optimizers.sgd(0.1)
    step = steps.make_train_step(model_cfg(), opt)
    model = convert.model_from_jax(numpy_tree(model_cfg(channels=8)),
                                   model_cfg(channels=8), device="cpu")
    with pytest.raises(ValueError, match="config"):
        step(model, opt.init(model), torch_batch(make_batch()))


# ---- remat ----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gradients_bitwise(dtype):
    tree = numpy_tree(model_cfg(dtype), seed=6)
    batch = torch_batch(make_batch(seed=7))
    grads = []
    for remat in (False, True):
        cfg = model_cfg(dtype, remat=remat)
        model = convert.model_from_jax(tree, cfg, device="cpu")
        planes = steps._planes(batch, batch["packed"], cfg)
        loss = steps.nll_from_logits(model(planes), batch["target"])
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_remat_leaves_the_no_grad_forward_unchanged():
    tree = numpy_tree(model_cfg("bfloat16"), seed=6)
    batch = torch_batch(make_batch(seed=8))
    outs = []
    for remat in (False, True):
        cfg = model_cfg("bfloat16", remat=remat)
        model = convert.model_from_jax(tree, cfg, device="cpu")
        with torch.no_grad():
            outs.append(model(steps._planes(batch, batch["packed"], cfg)))
    assert torch.equal(*outs)


# ---- eval step ----


@pytest.mark.parametrize("nibble", [False, True])
def test_eval_step_matches_jax(nibble):
    cfg = model_cfg()
    tree = numpy_tree(cfg, seed=11, bias_scale=0.5)
    batch = make_batch(n=64, seed=12)
    planes = steps._planes(torch_batch(batch),
                           torch.from_numpy(batch["packed"]), cfg)
    jlogits = np.asarray(jax_policy.apply(
        jax_tree(tree), jnp.asarray(planes.numpy()), jax_cfg(cfg)))
    model = convert.model_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        logits = model(planes).numpy()
    # half the targets at JAX's top-1, so that the counts are not all 0
    batch["target"][::2] = jlogits.argmax(axis=1)[::2]
    batch["mask"] = (np.arange(64) < 50).astype(np.float32)
    if nibble:
        batch["packed"] = wire.nibble_pack_np(batch["packed"])
    wire_name = "nibble" if nibble else "packed"

    jeval = jax_steps.make_eval_step(jax_cfg(cfg), expand_backend="xla",
                                     wire=wire_name)
    j_nll, j_correct = jeval(jax_tree(tree), jax_tree(batch))
    ev = steps.make_eval_step(cfg, wire=wire_name)
    nll, correct = ev(model, torch_batch(batch))
    assert abs(float(nll) - float(j_nll)) <= EVAL_NLL_TOL

    # top-1 equal on decided rows; near-ties may flip either way
    top2 = np.sort(jlogits, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= TOP1_MARGIN
    assert np.array_equal(logits.argmax(axis=1)[decided],
                          jlogits.argmax(axis=1)[decided])
    close = int((~decided)[batch["mask"] > 0].sum())
    assert float(j_correct) >= 20
    assert abs(float(correct) - float(j_correct)) <= close
    no_mask = {k: v for k, v in batch.items() if k != "mask"}
    _, all_correct = ev(model, torch_batch(no_mask))
    assert float(all_correct) >= float(correct)
