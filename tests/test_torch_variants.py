"""The port's serving variants (f32 | int8 | sym | int8+sym) against the JAX package.

Weights and boards are made with numpy (or by the JAX package's ``init``
and handed over as numpy arrays). Bars:

* exact: the copies of ``utils/digest`` and ``ops/augment``, the plain
  symmetric expansion (against the Pallas kernel in interpret mode and the
  XLA gather + expand), ``quantize_params`` on JAX-initialised ``small`` and
  ``full`` weights, the quantized tree through ``convert``;
* inside the port, bitwise (the twins of ``tests/test_quant.py``): int8
  forward == forward over the dequantized weights; grid net int8 == f32;
  fused S=1 == plain forward; int8+sym == sym on the grid net;
* against JAX in float32: max-abs <= 1e-4; in bf16 against the JAX float32
  reference, the bar of ``tests/test_torch_policy.py``: drift <= 0.5 over
  p >= 1e-3 and top-1 = 1.0 on rows whose reference margin is >= 0.05,
  with at least 32 such rows;
* fused ensemble against the port's unfused mixture: rtol 2e-4, atol 1e-5;
  equivariance under view 5: rtol 2e-4, atol 1e-6 (the JAX test's bars).

The one known difference between the packages is in the JAX scale's
``exp2`` and ``log2`` on XLA:CPU: ``test_po2_scale_exact_where_xla_exp2_is_not``
pins it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepgo_tpu.models import init as jax_init
from deepgo_tpu.models import policy_cnn as jax_policy
from deepgo_tpu.models import quant as jquant
from deepgo_tpu.obs.registry import MetricsRegistry as JaxRegistry
from deepgo_tpu.ops import augment as jaugment
from deepgo_tpu.ops.expand import expand_planes as jax_expand
from deepgo_tpu.ops.pallas_expand import expand_planes_sym_pallas
from deepgo_tpu.serving.variants import variant_fn_name as jax_fn_name
from deepgo_tpu.utils import digest as jdigest

from deepgo_tpu_torch.models import convert, policy_cnn, quant
from deepgo_tpu_torch.models.serving import make_log_prob_fn, \
    make_sym_policy_fn
from deepgo_tpu_torch.obs import get_registry
from deepgo_tpu_torch.obs.registry import MetricsRegistry
from deepgo_tpu_torch.ops import augment, cuda_expand, expand_planes_sym
from deepgo_tpu_torch.ops import expand as plain
from deepgo_tpu_torch.serving import (EngineConfig, ToleranceConfig,
                                      VariantToleranceError, policy_engine,
                                      variant_spec, verify_variant)
from deepgo_tpu_torch.serving.variants import VARIANTS, variant_fn_name
from deepgo_tpu_torch.utils import digest

from test_torch_policy import (DRIFT_CAP, F32_TOL, MARGIN, MIN_DECIDED_ROWS,
                               PROB_FLOOR, numpy_tree)

torch.set_num_threads(2)

JCFG = jax_policy.ModelConfig(num_layers=2, channels=8)
CFG = policy_cnn.ModelConfig(num_layers=2, channels=8)
ECFG = EngineConfig(buckets=(1, 8), max_wait_ms=0.0)
FAST_TOL = ToleranceConfig(boards=32)
ODD_PLAYERS = np.array([0, 3, -1, 255, 1, 2], np.int32)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def boards(n, seed=0, hi=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, size=(n, 9, 19, 19), dtype=np.uint8),
            rng.integers(1, 3, size=n).astype(np.int32),
            rng.integers(1, 10, size=n).astype(np.int32))


def f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_grid_net(jcfg=JCFG, seed=0, sharp=4.0):
    """tests/test_quant.py's grid net: JAX-initialised weights snapped onto
    the po2 int8 grid, plus a sharp last-layer bias from a numpy seed."""
    params = jax_init(jax.random.key(seed), jcfg)
    snapped = jquant.dequantize_params(jquant.quantize_params(params))
    rng = np.random.default_rng(seed)
    snapped["layers"][-1]["b"] = jnp.asarray(
        rng.normal(0.0, sharp, size=(19, 19, 1)).astype(np.float32))
    return snapped


def port_model(tree, cfg=CFG):
    return convert.model_from_jax(as_numpy(tree), cfg, device="cpu")


def grid_net(cfg=CFG, seed=0):
    return port_model(jax_grid_net(seed=seed), cfg)


def he_normal_net(cfg=CFG, seed=9):
    """A nearly flat net: He-normal weights, zero biases."""
    return port_model(numpy_tree(cfg, seed=seed, bias_scale=0.0), cfg)


# -- the copies: digest tables and functions, augment ----------------------


@pytest.mark.parametrize("what", ["tables", "exact_digest",
                                  "canonicalize", "remap", "views"])
def test_digest_copy_matches_jax(what):
    packed, player, rank = boards(3, seed=1, hi=256)
    if what == "tables":
        assert digest.NUM_SYMMETRIES == jdigest.NUM_SYMMETRIES
        assert (digest.BOARD_SIZE, digest.NUM_POINTS, digest.PACKED_SHAPE,
                digest.DIGEST_HEX) == (jdigest.BOARD_SIZE, jdigest.NUM_POINTS,
                                       jdigest.PACKED_SHAPE,
                                       jdigest.DIGEST_HEX)
        for name in ("PERMS", "INV_PERMS"):
            got, want = getattr(digest, name), getattr(jdigest, name)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert not got.flags.writeable
    for i in range(3):
        args = (packed[i], int(player[i]), int(rank[i]))
        if what == "exact_digest":
            assert digest.exact_digest(*args) == jdigest.exact_digest(*args)
            assert digest.canonical_digest(*args) == \
                jdigest.canonical_digest(*args)
        elif what == "canonicalize":
            got, want = digest.canonicalize(*args), jdigest.canonicalize(*args)
            assert got[0] == want[0] and got[2] == want[2]
            assert np.array_equal(got[1], want[1])
        elif what == "remap":
            row = np.random.default_rng(i).standard_normal(361)
            for k in range(8):
                assert np.array_equal(digest.remap_from_canonical(row, k),
                                      jdigest.remap_from_canonical(row, k))
        elif what == "views":
            for a, b in zip(digest.dihedral_views(packed[i]),
                            jdigest.dihedral_views(packed[i])):
                assert np.array_equal(a, b)


def test_augment_copy_matches_jax():
    assert augment.NUM_SYMMETRIES == jaugment.NUM_SYMMETRIES == 8
    assert np.array_equal(augment._PERM_NP, jaugment._PERM_NP)
    assert np.array_equal(augment._TARGET_MAP_NP, jaugment._TARGET_MAP_NP)


def test_augment_batch_matches_jax():
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 256, size=(16, 9, 19, 19), dtype=np.uint8)
    target = rng.integers(0, 361, size=16).astype(np.int32)
    sym = np.arange(16, dtype=np.int32) % 8
    want_p, want_t = jaugment.augment_batch(jnp.asarray(packed),
                                            jnp.asarray(target),
                                            jnp.asarray(sym))
    got_p, got_t = augment.augment_batch(torch.from_numpy(packed),
                                         torch.from_numpy(target),
                                         torch.from_numpy(sym))
    assert got_p.dtype == torch.uint8 and got_t.dtype == torch.int32
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))


# -- the plain symmetric expansion -----------------------------------------


def _sym_inputs(b, seed):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, size=(b, 9, 19, 19), dtype=np.uint8)
    player = ODD_PLAYERS[rng.permutation(6)[:b]]
    rank = rng.integers(0, 11, size=b).astype(np.int32)
    return packed, player, rank


def _jax_xla_sym(packed, player, rank, s, jdt):
    """The XLA branch of make_fused_sym_policy_fn (quant.py:229-234)."""
    b = len(packed)
    flat = jnp.asarray(packed).reshape(b, 9, 361)
    views = flat[:, :, jnp.asarray(jaugment._PERM_NP[:s])]
    views = views.transpose(2, 0, 1, 3).reshape(s * b, 9, 19, 19)
    out = jax_expand(views, jnp.tile(jnp.asarray(player), s),
                     jnp.tile(jnp.asarray(rank), s), dtype=jdt)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("b", [3, 4])
def test_plain_sym_expand_matches_pallas_and_xla(b, s, dtype):
    tdt, jdt = DTYPES[dtype]
    packed, player, rank = _sym_inputs(b, seed=10 * b + s)
    got = plain.expand_planes_sym(torch.from_numpy(packed),
                                  torch.from_numpy(player),
                                  torch.from_numpy(rank), symmetries=s,
                                  dtype=tdt)
    assert got.dtype == tdt and got.shape == (s * b, 19, 19, 37)
    got = got.float().numpy()
    pallas = np.asarray(expand_planes_sym_pallas(
        jnp.asarray(packed), jnp.asarray(player), jnp.asarray(rank),
        symmetries=s, dtype=jdt, interpret=True).astype(jnp.float32))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, _jax_xla_sym(packed, player, rank, s, jdt))


def test_plain_sym_expand_at_one_view_is_the_plain_expansion():
    packed, player, rank = (torch.from_numpy(a) for a in _sym_inputs(5, 3))
    assert torch.equal(
        plain.expand_planes_sym(packed, player, rank, symmetries=1),
        plain.expand_planes(packed, player, rank))


def test_sym_dispatch_sends_cpu_tensors_to_plain_version():
    packed, player, rank = (torch.from_numpy(a) for a in _sym_inputs(4, 4))
    before = (cuda_expand.launches, cuda_expand.sym_launches)
    got = expand_planes_sym(packed, player, rank, symmetries=3,
                            dtype=torch.float32)
    assert torch.equal(got, plain.expand_planes_sym(
        packed, player, rank, symmetries=3, dtype=torch.float32))
    assert (cuda_expand.launches, cuda_expand.sym_launches) == before
    meta = torch.empty((2, 9, 19, 19), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no expansion"):
        expand_planes_sym(meta, meta[:, 0, 0, 0].int(),
                          meta[:, 0, 0, 0].int())
    for bad in (0, 9):
        with pytest.raises(ValueError, match="symmetries"):
            plain.expand_planes_sym(packed, player, rank, symmetries=bad)


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "rank", "empty",
                                 "out_dtype", "zero_views", "nine_views",
                                 "float_views"])
def test_sym_kernel_wrapper_raises_on_what_it_cannot_take(bad):
    packed = torch.zeros((2, 9, 19, 19), dtype=torch.uint8)
    player = torch.ones(2, dtype=torch.int32)
    rank = torch.ones(2, dtype=torch.int32)
    kw = {"symmetries": 8, "dtype": torch.bfloat16}
    if bad == "dtype":
        packed = packed.int()
    elif bad == "shape":
        packed = packed[:, :, :18]
    elif bad == "rank":
        rank = rank[:1]
    elif bad == "empty":
        packed = packed[:0]
    elif bad == "out_dtype":
        kw["dtype"] = torch.float16
    elif bad == "zero_views":
        kw["symmetries"] = 0
    elif bad == "nine_views":
        kw["symmetries"] = 9
    elif bad == "float_views":
        kw["symmetries"] = 8.0
    before = (cuda_expand.launches, cuda_expand.sym_launches)
    with pytest.raises(ValueError):
        cuda_expand.expand_planes_sym_cuda(packed, player, rank, **kw)
    assert (cuda_expand.launches, cuda_expand.sym_launches) == before


def test_reset_launches_zeroes_both_counts(monkeypatch):
    monkeypatch.setattr(cuda_expand, "launches", 3)
    monkeypatch.setattr(cuda_expand, "sym_launches", 5)
    cuda_expand.reset_launches()
    assert (cuda_expand.launches, cuda_expand.sym_launches) == (0, 0)


def test_sym_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    # S * B * 361 * 37 planes not a whole number of 16-byte vectors at
    # B = 1, 7, 37 for odd S (and B = 1, S = 2): the last one is ragged
    cases = [(b, s) for b in (1, 8, 37) for s in (1, 3, 8)]
    cases += [(7, 1), (7, 5), (1, 2)]
    for b, s in cases:
        args = [torch.from_numpy(np.resize(a, (b,) + a.shape[1:]))
                for a in _sym_inputs(min(b, 6), b)]
        for tdt, _ in DTYPES.values():
            want = plain.expand_planes_sym(*args, symmetries=s, dtype=tdt)
            got = expand_planes_sym(*(a.cuda() for a in args),
                                    symmetries=s, dtype=tdt)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (b, s, tdt)


# -- quantization: bitwise against JAX, the exp2 finding --------------------


@pytest.mark.parametrize("name", ["small", "full"])
def test_quantize_matches_jax_bitwise(name):
    jcfg = jax_policy.CONFIGS[name]
    params = jax_init(jax.random.key(0), jcfg)
    want = as_numpy(jquant.quantize_params(params))
    qmodel = quant.quantize_params(port_model(params,
                                              policy_cnn.CONFIGS[name]))
    got = convert.qparams_to_jax(qmodel)
    for g, w in zip(got["layers"], want["layers"]):
        for key in ("w_q", "w_scale", "b"):
            assert g[key].dtype == w[key].dtype, key
            assert np.array_equal(g[key], w[key]), key


def test_quantized_tree_round_trips_through_convert():
    jtree = as_numpy(jquant.quantize_params(jax_init(jax.random.key(3),
                                                     JCFG)))
    qmodel = quant.QuantPolicyCNN(CFG)
    qmodel.load_state_dict(convert.qparams_from_jax(jtree))
    assert qmodel.layers[0].w_q.dtype == torch.int8
    assert tuple(qmodel.layers[0].w_q.shape) == (8, 37, 5, 5)
    back = convert.qparams_to_jax(qmodel)
    for g, w in zip(back["layers"], jtree["layers"]):
        for key in ("w_q", "w_scale", "b"):
            assert g[key].dtype == w[key].dtype
            assert np.array_equal(g[key], w[key])


def test_quantize_properties():
    qmodel = quant.quantize_params(he_normal_net(seed=4))
    for layer, qlayer in zip(quant.dequantize_params(qmodel).layers,
                             qmodel.layers):
        scale = qlayer.w_scale
        mantissa, _ = torch.frexp(scale)
        assert (mantissa == 0.5).all() and (scale > 0).all()
        assert qlayer.w_q.abs().max() <= quant.QUANT_MAX
    # an all-zero channel keeps scale 1.0
    model = he_normal_net(seed=5)
    with torch.no_grad():
        model.layers[0].weight[3] = 0.0
    qmodel = quant.quantize_params(model)
    assert qmodel.layers[0].w_scale[3] == 1.0
    assert not qmodel.layers[0].w_q[3].any()
    # the round trip stays within half a step of the weights
    for layer, qlayer in zip(model.layers, qmodel.layers):
        err = (qlayer.w_q.float() * qlayer.w_scale[:, None, None, None]
               - layer.weight).abs()
        assert (err <= qlayer.w_scale[:, None, None, None] / 2 + 1e-7).all()


def test_po2_scale_is_exact_over_the_float32_range():
    rng = np.random.default_rng(6)
    exps = rng.integers(-140, 120, size=4000)
    amax = (rng.uniform(0.5, 1.0, size=4000) * 2.0 ** exps).astype(np.float32)
    amax[:260] = (127.0 * 2.0 ** np.arange(-140, 120)).astype(np.float32)
    amax = amax[amax > 0]
    got = quant._po2_scale(torch.from_numpy(amax)).numpy()
    x = (amax / np.float32(127.0)).astype(np.float64)
    want = np.array([2.0 ** np.ceil(np.log2(v)) for v in x])
    assert np.array_equal(got.astype(np.float64), want)


def test_po2_scale_exact_where_xla_exp2_is_not():
    """A channel whose amax lies in (127 * 2**-14, 127 * 2**-13] needs the
    scale 2**-13. The JAX package computes ``exp2(ceil(log2(amax/127)))``,
    and XLA:CPU rounds both functions inexactly here (ROADMAP.md section C):

    * ``jnp.exp2(-13.0)`` is 0.000122070254, 8 float32 ulps below
      2**-13 = 0.00012207031 (relative error 4.6e-7), so inside the
      interval the JAX scale is not a power of two;
    * ``jnp.log2(2.0**-13)`` is -12.999999, so at the interval's top, where
      amax / 127 is exactly 2**-13, ``ceil`` gives -12 and the JAX scale is
      2**-12, twice the power of two the formula asks for.

    The port's scale is the exact power of two on every channel. The test
    holds each JAX channel to one of: equal to the port's; a few ulps off
    it (``exp2``; at most 16); or, only where amax / 127 is itself a power
    of two, twice it (``log2``). These are the expected differences: the
    JAX package keeps its formula."""
    c_out = 64
    rng = np.random.default_rng(7)
    lo = 127.0 * 2.0 ** -14
    amax = np.linspace(lo * 1.01, 2 * lo, c_out).astype(np.float32)
    amax[-1] = np.float32(127.0 * 2.0 ** -13)  # the top of the interval
    w = rng.uniform(-1.0, 1.0, size=(3, 3, 8, c_out)).astype(np.float32)
    w *= amax / np.abs(w).max(axis=(0, 1, 2))
    w[0, 0, 0] = amax  # make amax exact
    cfg = policy_cnn.ModelConfig(num_layers=2, channels=c_out,
                                 first_kernel=3, input_planes=8)
    b = np.zeros((19, 19, c_out), np.float32)
    tail = np.zeros((3, 3, c_out, 1), np.float32)
    tree = {"layers": [{"w": w, "b": b},
                       {"w": tail, "b": np.zeros((19, 19, 1), np.float32)}]}
    qmodel = quant.quantize_params(port_model(tree, cfg))
    port_scale = qmodel.layers[0].w_scale.numpy()
    assert np.array_equal(port_scale,
                          np.full(c_out, 2.0 ** -13, np.float32))
    jax_scale = np.asarray(jquant.quantize_params(
        jax.tree.map(jnp.asarray, tree))["layers"][0]["w_scale"])
    same = jax_scale == port_scale
    ulps = np.abs(jax_scale.view(np.int32) - port_scale.view(np.int32))
    mantissa, _ = np.frexp(jax_scale)
    on_po2 = amax / np.float32(127.0) == port_scale
    exp2_off = (mantissa != 0.5) & (ulps <= 16)
    log2_off = (mantissa == 0.5) & (jax_scale == 2 * port_scale) & on_po2
    assert (same | exp2_off | log2_off).all()
    assert on_po2.sum() == 1
    # the measured XLA:CPU behaviour, where it still holds
    if float(jnp.exp2(jnp.float32(-13.0))) != 2.0 ** -13:
        assert exp2_off[~on_po2].all()
        assert (ulps[~on_po2] == 8).all()
    if float(jnp.log2(jnp.float32(2.0 ** -13))) != -13.0:
        assert log2_off[on_po2].all()
    # the port's codes are the exact quotient by 2**-13, rounded
    want_q = np.clip(np.round(w * 2.0 ** 13), -127, 127).astype(np.int8)
    assert np.array_equal(convert.qparams_to_jax(qmodel)["layers"][0]["w_q"],
                          want_q)


# -- inside the port, bitwise ------------------------------------------------


def test_int8_forward_equals_forward_over_dequantized_weights():
    qmodel = quant.quantize_params(he_normal_net(seed=2))
    pk, pl, rk = boards(8, seed=2)
    a = make_log_prob_fn(CFG, device="cpu")(quant.dequantize_params(qmodel),
                                           pk, pl, rk)
    b = quant.make_quant_log_prob_fn(CFG, device="cpu")(qmodel, pk, pl, rk)
    assert np.array_equal(a, b)


def test_grid_net_int8_forward_equals_f32():
    model = grid_net()
    pk, pl, rk = boards(16, seed=1)
    a = make_log_prob_fn(CFG, device="cpu")(model, pk, pl, rk)
    b = quant.make_quant_log_prob_fn(CFG, device="cpu")(
        quant.quantize_params(model), pk, pl, rk)
    assert np.array_equal(a, b)


def test_fused_one_view_equals_plain_forward():
    model = he_normal_net(seed=0)
    pk, pl, rk = boards(8, seed=3)
    one = quant.make_fused_sym_policy_fn(CFG, symmetries=1, device="cpu")
    assert np.array_equal(one(model, pk, pl, rk),
                          make_log_prob_fn(CFG, device="cpu")(model, pk, pl,
                                                              rk))


def test_int8_sym_equals_sym_on_grid_net():
    model = grid_net()
    pk, pl, rk = boards(8, seed=7)
    f8 = quant.make_fused_sym_policy_fn(CFG, device="cpu")
    f8q = quant.make_fused_sym_policy_fn(CFG, quant=True, device="cpu")
    assert np.array_equal(f8(model, pk, pl, rk),
                          f8q(quant.quantize_params(model), pk, pl, rk))


def test_forwards_refuse_the_wrong_kind_of_model():
    model = he_normal_net()
    qmodel = quant.quantize_params(model)
    pk, pl, rk = boards(1)
    with pytest.raises(TypeError):
        quant.make_quant_log_prob_fn(CFG, device="cpu")(model, pk, pl, rk)
    with pytest.raises(TypeError):
        quant.make_fused_sym_policy_fn(CFG, device="cpu")(qmodel, pk, pl, rk)
    with pytest.raises(TypeError):
        quant.make_fused_sym_policy_fn(CFG, quant=True, device="cpu")(
            model, pk, pl, rk)
    with pytest.raises(ValueError, match="config"):
        quant.make_fused_sym_policy_fn(f32(CFG), device="cpu")(model, pk, pl,
                                                               rk)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="symmetries"):
            quant.make_fused_sym_policy_fn(CFG, symmetries=bad, device="cpu")


# -- against JAX ---------------------------------------------------------------


@pytest.mark.parametrize("forward", ["int8", "sym", "int8+sym", "sym3"])
def test_float32_forwards_match_jax(forward):
    jcfg, cfg = f32(JCFG), f32(CFG)
    params = jax_init(jax.random.key(1), jcfg)
    qparams = jquant.quantize_params(params)
    pk, pl, rk = boards(8, seed=5)
    if forward == "int8":
        want = jquant.make_quant_log_prob_fn(jcfg)(qparams, pk, pl, rk)
        got = quant.make_quant_log_prob_fn(cfg, device="cpu")(
            quant.quantize_params(port_model(params, cfg)), pk, pl, rk)
    else:
        q = forward == "int8+sym"
        s = 3 if forward == "sym3" else None
        want = jquant.make_fused_sym_policy_fn(jcfg, quant=q, symmetries=s)(
            qparams if q else params, pk, pl, rk)
        model = port_model(params, cfg)
        got = quant.make_fused_sym_policy_fn(cfg, quant=q, symmetries=s,
                                             device="cpu")(
            quant.quantize_params(model) if q else model, pk, pl, rk)
    assert got.shape == (8, 361) and got.dtype == np.float32
    assert np.abs(got - np.asarray(want)).max() <= F32_TOL


@pytest.mark.parametrize("forward", ["int8", "int8+sym"])
def test_bfloat16_forwards_meet_the_bar(forward):
    jcfg = jax_policy.CONFIGS["small"]
    tree = numpy_tree(jcfg, seed=1)
    qparams = jquant.quantize_params(jax.tree.map(jnp.asarray, tree))
    pk, pl, rk = boards(256, seed=6)
    cfg = policy_cnn.CONFIGS["small"]
    assert cfg.compute_dtype == "bfloat16"
    qmodel = quant.quantize_params(port_model(tree, cfg))
    if forward == "int8":
        ref = jquant.make_quant_log_prob_fn(f32(jcfg))(qparams, pk, pl, rk)
        got = quant.make_quant_log_prob_fn(cfg, device="cpu")(qmodel, pk, pl,
                                                             rk)
    else:
        ref = jquant.make_fused_sym_policy_fn(f32(jcfg), quant=True)(
            qparams, pk, pl, rk)
        got = quant.make_fused_sym_policy_fn(cfg, quant=True, device="cpu")(
            qmodel, pk, pl, rk)
    ref = np.asarray(ref)
    assert np.isfinite(got).all()
    assert np.abs(got - ref)[np.exp(ref) >= PROB_FLOOR].max() <= DRIFT_CAP
    top2 = np.sort(ref, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] >= MARGIN
    assert decided.sum() >= MIN_DECIDED_ROWS
    assert np.array_equal(got.argmax(1)[decided], ref.argmax(1)[decided])


def test_fused_matches_unfused_mixture():
    # log-sum-exp averaging == log of the softmax mixture
    cfg = f32(CFG)
    model = port_model(jax_init(jax.random.key(1), f32(JCFG)), cfg)
    pk, pl, rk = boards(4, seed=5)
    np.testing.assert_allclose(
        quant.make_fused_sym_policy_fn(cfg, device="cpu")(model, pk, pl, rk),
        make_sym_policy_fn(cfg, device="cpu")(model, pk, pl, rk),
        rtol=2e-4, atol=1e-5)


def test_unfused_mixture_matches_jax():
    from deepgo_tpu.models.serving import make_sym_policy_fn as jax_sym

    jcfg, cfg = f32(JCFG), f32(CFG)
    params = jax_init(jax.random.key(4), jcfg)
    pk, pl, rk = boards(4, seed=8)
    want = np.asarray(jax_sym(jcfg)(params, pk, pl, rk))
    got = make_sym_policy_fn(cfg, device="cpu")(port_model(params, cfg), pk,
                                                pl, rk)
    assert np.abs(got - want).max() <= F32_TOL


def test_fused_is_equivariant():
    cfg = f32(CFG)
    model = port_model(jax_init(jax.random.key(1), f32(JCFG)), cfg)
    fused = quant.make_fused_sym_policy_fn(cfg, device="cpu")
    pk, pl, rk = boards(4, seed=6)
    base = fused(model, pk, pl, rk)
    k = 5
    t_pk = pk.reshape(4, 9, 361)[:, :, augment._PERM_NP[k]].reshape(
        4, 9, 19, 19)
    t_out = fused(model, t_pk, pl, rk)
    np.testing.assert_allclose(t_out[:, augment._TARGET_MAP_NP[k]], base,
                               rtol=2e-4, atol=1e-6)


# -- the tolerance harness -----------------------------------------------------


def test_grid_net_passes_every_rung():
    model = grid_net()
    rep = quant.tolerance_report(
        make_log_prob_fn(CFG, device="cpu"), model,
        quant.make_quant_log_prob_fn(CFG, device="cpu"),
        quant.quantize_params(model), buckets=(1, 8, 32, 128, 512),
        config=FAST_TOL, registry=MetricsRegistry())
    assert rep["verdict"] == "pass"
    assert set(rep["rungs"]) == {"1", "8", "32", "128", "512"}
    for rung in rep["rungs"].values():
        assert rung["top1_agreement"] == 1.0
        assert rung["max_abs_logprob_drift"] == 0.0
        assert rung["boards"] == 32


def test_he_normal_net_refuses_typed():
    with pytest.raises(VariantToleranceError) as ei:
        verify_variant(CFG, he_normal_net(), "int8", buckets=(8, 32),
                       tolerance=ToleranceConfig(boards=64), device="cpu")
    report = ei.value.report
    assert report["verdict"] == "fail"
    assert report["worst_top1"] < 0.99


def test_exact_variants_pass_trivially():
    for v in ("f32", "sym"):
        out = verify_variant(CFG, he_normal_net(), v, device="cpu")
        assert out == {"variant": v, "verdict": "pass", "exact": True}


def test_int8_sym_gated_against_sym_reference():
    out = verify_variant(CFG, grid_net(), "int8+sym", buckets=(1, 8),
                         tolerance=FAST_TOL, device="cpu")
    assert out["verdict"] == "pass" and out["variant"] == "int8+sym"
    assert out["worst_top1"] == 1.0 and out["worst_drift"] == 0.0


def test_tolerance_publishes_gauges_in_the_port_registry():
    model = grid_net()
    quant.tolerance_report(
        make_log_prob_fn(CFG, device="cpu"), model,
        quant.make_quant_log_prob_fn(CFG, device="cpu"),
        quant.quantize_params(model), buckets=(8,), config=FAST_TOL,
        variant="int8")
    snap = get_registry().snapshot()["metrics"]
    assert snap["deepgo_quant_top1_agreement"]["series"][
        "bucket=8,variant=int8"] == 1.0
    assert snap["deepgo_quant_logprob_drift"]["series"][
        "bucket=8,variant=int8"] == 0.0


def test_unknown_variant_rejected():
    with pytest.raises(ValueError):
        variant_spec(CFG, "fp4", device="cpu")
    assert VARIANTS == ("f32", "int8", "sym", "int8+sym")
    for v in VARIANTS:
        assert variant_fn_name(v) == jax_fn_name(v)


def test_variant_specs_are_memoized_per_device():
    a = variant_spec(CFG, "int8+sym", device="cpu")
    assert variant_spec(CFG, "int8+sym", device="cpu") is a
    assert a.lossy and a.prepare is quant.quantize_params
    assert not variant_spec(CFG, "sym", device="cpu").lossy


# -- engines -------------------------------------------------------------------


def test_variant_engine_stamped_and_bitwise():
    model = grid_net()
    eng = policy_engine(model, CFG, config=ECFG, device="cpu",
                        variant="int8", tolerance=FAST_TOL, name="q-stamp")
    try:
        assert eng.variant == "int8"
        assert eng.prepare_params is quant.quantize_params
        pk, pl, rk = boards(4, seed=11)
        got = eng.evaluate(pk, pl, rk)
        ref = make_log_prob_fn(CFG, device="cpu")(model, pk, pl, rk)
        assert np.array_equal(got, ref)
    finally:
        eng.close()
    serving = get_registry().snapshot()["metrics"][
        "deepgo_quant_variants_serving"]["series"]
    assert serving["variant=int8"] == 1.0


def test_int8_sym_engine_rows_equal_the_fused_forward():
    model = grid_net()
    pk, pl, rk = boards(9, seed=12)
    with policy_engine(model, CFG, config=ECFG, device="cpu",
                       variant="int8+sym", tolerance=FAST_TOL) as eng:
        futures = [eng.submit(pk[i], pl[i], rk[i]) for i in range(9)]
        rows = [f.result(timeout=60) for f in futures]
        ladder = eng.ladder
    fused = quant.make_fused_sym_policy_fn(CFG, quant=True, device="cpu")
    qmodel = quant.quantize_params(model)
    for i, (row, f) in enumerate(zip(rows, futures)):
        want = fused(qmodel, *ladder.pad(pk[i:i + 1], pl[i:i + 1],
                                         rk[i:i + 1], f.bucket))[0]
        assert np.array_equal(row, want), i


def test_failing_variant_never_builds_an_engine():
    with pytest.raises(VariantToleranceError):
        policy_engine(he_normal_net(), CFG, config=ECFG, device="cpu",
                      variant="int8", tolerance=ToleranceConfig(boards=64),
                      name="q-refuse")


def test_variant_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quant.make_fused_sym_policy_fn(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quant.make_quant_log_prob_fn(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sym_policy_fn(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        variant_spec(CFG, "sym")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        policy_engine(he_normal_net(), CFG, variant="int8+sym")


# -- the registry copy ------------------------------------------------------


def _drive_registry(reg):
    c = reg.counter("deepgo_test_total", "a counter")
    c.inc(engine="a")
    c.inc(2.5, engine="b")
    g = reg.gauge("deepgo_test_gauge", "a gauge")
    g.set(3.0, variant="int8", bucket=8)
    g.inc(1.5, variant="int8", bucket=8)
    g.dec(0.5, variant="sym", bucket=1)
    g.set_function(lambda: 7.0, kind="live")
    h = reg.histogram("deepgo_test_seconds", "a histogram",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.002, 0.003, 0.05, 0.2, 0.7, 3.0):
        h.observe(v, engine="a")
    return reg.snapshot()


def test_registry_snapshot_matches_jax():
    got = _drive_registry(MetricsRegistry(clock=lambda: 123.0))
    want = _drive_registry(JaxRegistry(clock=lambda: 123.0))
    assert got == want
    assert got["metrics"]["deepgo_test_gauge"]["series"]["kind=live"] == 7.0


@pytest.mark.parametrize("registry", [MetricsRegistry, JaxRegistry])
def test_registry_refuses_what_jax_refuses(registry):
    reg = registry()
    with pytest.raises(ValueError):
        reg.counter("bad name")
    reg.counter("deepgo_x")
    with pytest.raises(ValueError):
        reg.gauge("deepgo_x")
    with pytest.raises(ValueError):
        reg.counter("deepgo_x").inc(-1)
    with pytest.raises(ValueError):
        reg.histogram("deepgo_h", buckets=(2.0, 1.0))
    assert reg.histogram("deepgo_h2").snapshot() is None
