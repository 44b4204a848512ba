"""The residual network's BN epilogue (batch normalisation, the block's
input added where there is one, ReLU).

On the CPU, ``ops.bn_relu`` is the plain expression ``models/resnet.py``
evaluated before the CUDA kernels: outputs, gradients and running
statistics stay bitwise what they were, so the comparisons with the
reference see the same numbers. The kernel wrappers refuse what their
kernels do not take without launching. The kernels (``csrc/bn_epilogue.cu``)
are held against the plain version in the last tests here when a card is
present, and in ``chip_smoke.py``."""

import copy
import math

import pytest
import torch
import torch.nn.functional as F

from deepgo_tpu_torch import ops
from deepgo_tpu_torch.models import resnet
from deepgo_tpu_torch.ops import bn_epilogue as plain
from deepgo_tpu_torch.ops import cuda_bn_epilogue

torch.set_num_threads(2)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _expression(x, bn, skip):
    """The epilogue as ``BatchNorm.forward``, ``ResidualBlock`` and
    ``DualResNet.forward`` wrote it out."""
    x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     bn.training, bn.momentum, bn.eps)
    return F.relu(x if skip is None else x + skip)


def _bn(c, seed, training, device="cpu"):
    """A BatchNorm with its scale, shift and running statistics drawn away
    from 1, 0, 0 and 1."""
    g = torch.Generator().manual_seed(seed)
    bn = resnet.BatchNorm(c, 1e-5, 0.1)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(1.0 + 0.1 * torch.randn(c, generator=g).abs())
    return bn.train(training).to(device)


def _conv_case(c, dtype, seed, b=3, c_in=5):
    g = torch.Generator().manual_seed(seed)
    planes = torch.randn(b, c_in, 19, 19, generator=g).to(
        dtype=dtype, memory_format=torch.channels_last)
    weight = torch.randn(c, c_in, 3, 3, generator=g).requires_grad_()
    skip = torch.randn(b, c, 19, 19, generator=g).to(
        dtype=dtype, memory_format=torch.channels_last).requires_grad_()
    probe = torch.randn(b, c, 19, 19, generator=g)
    return planes, weight, skip, probe


def _through(epilogue, bn, planes, weight, skip, probe):
    x = F.conv2d(planes, weight.to(planes.dtype), padding=1)
    y = epilogue(x, bn, skip)
    leaves = [weight, bn.weight, bn.bias] + ([] if skip is None else [skip])
    grads = torch.autograd.grad((y.float() * probe).sum(), leaves)
    return y, grads, (bn.running_mean.clone(), bn.running_var.clone())


@pytest.mark.parametrize("c", [1, 2, 16])
@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_path_is_the_expression_bitwise(dtype, training, with_skip, c):
    planes, weight, skip, probe = _conv_case(c, DTYPES[dtype], seed=c)
    skip = skip if with_skip else None
    bn = _bn(c, seed=c + 1, training=training)
    want = _through(_expression, copy.deepcopy(bn), planes, weight, skip,
                    probe)
    for epilogue in (ops.bn_relu, plain.bn_relu):
        got = _through(epilogue, copy.deepcopy(bn), planes, weight, skip,
                       probe)
        assert got[0].dtype == DTYPES[dtype]
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1] + got[2], want[1] + want[2]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert all(a.dtype == torch.float32 for a in got[1][:3] + got[2])
    # train mode moved the running statistics, eval mode left them
    assert torch.equal(want[2][0], bn.running_mean) != training


def _written_out(model, planes):
    """DualResNet's forward with the epilogues written out, as it was."""
    def conv_bn(layer, x):
        x = F.conv2d(x, layer.weight.to(x.dtype),
                     padding=layer.weight.shape[-1] // 2)
        bn = layer.bn
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, bn.training, bn.momentum, bn.eps)

    x = planes.permute(0, 3, 1, 2).to(model.cfg.torch_dtype)
    x = F.relu(conv_bn(model.stem, x))
    for block in model.blocks:
        y = F.relu(conv_bn(block.conv1, x))
        x = F.relu(conv_bn(block.conv2, y) + x)
    p = F.relu(conv_bn(model.policy_conv, x)).reshape(x.shape[0], -1)
    logits = model.policy_fc(p).float()
    v = F.relu(conv_bn(model.value_conv, x)).reshape(x.shape[0], -1)
    v = F.relu(model.value_fc1(v))
    return logits, torch.tanh(model.value_fc2(v).float())[:, 0]


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dual_resnet_on_the_cpu_is_unchanged(dtype, training):
    cfg = resnet.ResNetConfig(blocks=3, channels=8, value_hidden=16,
                              compute_dtype=dtype)
    base = resnet.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    with torch.no_grad():
        for name, bn in base.named_modules():
            if isinstance(bn, resnet.BatchNorm):
                fresh = _bn(bn.weight.shape[0], seed=len(name), training=True)
                bn.load_state_dict(fresh.state_dict())
    g = torch.Generator().manual_seed(4)
    planes = (torch.rand(4, 19, 19, 37, generator=g) < 0.3).float()
    target = torch.randint(0, 361, (4,), generator=g)
    results = []
    for forward in (lambda m, p: m(p), _written_out):
        model = copy.deepcopy(base).train(training)
        logits, value = forward(model, planes)
        loss = F.cross_entropy(logits, target) + value.square().mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append((logits, value, grads,
                        [b.clone() for b in model.buffers()]))
    (logits, value, grads, stats), want = results
    assert torch.equal(logits, want[0]) and torch.equal(value, want[1])
    for a, b in zip(grads + tuple(stats), want[2] + tuple(want[3])):
        assert torch.equal(a, b)


def test_every_bn_goes_through_ops_bn_relu(monkeypatch):
    calls = []
    real = ops.bn_relu

    def spy(x, bn, skip=None):
        calls.append((x.shape[1], skip is not None))
        return real(x, bn, skip)

    monkeypatch.setattr(ops, "bn_relu", spy)
    cfg = resnet.ResNetConfig(blocks=3, channels=8, value_hidden=16)
    model = resnet.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    model(torch.zeros(2, 19, 19, 37))
    # the stem, two a residual block (the second with the skip), the heads:
    # 2 * blocks + 1
    assert calls == [(8, False), (8, False), (8, True), (8, False),
                     (8, True), (2, False), (1, False)]


def test_cpu_tensors_never_reach_the_kernels():
    from deepgo_tpu_torch.training import make_eval_step, make_train_step, sgd

    cuda_bn_epilogue.reset_launches()
    cfg = resnet.ResNetConfig(blocks=2, channels=8, value_hidden=16,
                              compute_dtype="float32")
    model = resnet.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"packed": torch.randint(0, 3, (4, 9, 19, 19), generator=g,
                                     dtype=torch.uint8),
             "player": torch.randint(1, 3, (4,), generator=g,
                                     dtype=torch.int32),
             "rank": torch.randint(1, 10, (4,), generator=g,
                                   dtype=torch.int32),
             "target": torch.randint(0, 361, (4,), generator=g,
                                     dtype=torch.int32),
             "z": torch.ones(4)}
    optimizer = sgd(0.01)
    make_train_step(cfg, optimizer)(model, optimizer.init(model), batch)
    make_eval_step(cfg)(model, batch)
    assert (cuda_bn_epilogue.launches, cuda_bn_epilogue.bwd_launches) == (0, 0)


def test_other_devices_raise():
    x = torch.zeros(2, 4, 19, 19, device="meta")
    with pytest.raises(ValueError, match="no BN epilogue"):
        ops.bn_relu(x, _bn(4, seed=0, training=True, device="meta"))


def _bad_forward(bad):
    x = torch.zeros(4, 8, 19, 19).to(memory_format=torch.channels_last)
    bn = _bn(8, seed=0, training=True)
    skip = None
    match = "one CUDA device"  # the CPU tensors themselves
    if bad == "nchw":
        x, match = x.contiguous(), "channels-last"
    elif bad == "dtype":
        x, match = x.half(), "bfloat16 or float32"
    elif bad == "board":
        x = torch.zeros(4, 8, 9, 9).to(memory_format=torch.channels_last)
        match = r"\(1 <= B"
    elif bad == "batch":
        x = x[:1].expand(cuda_bn_epilogue.MAX_BATCH + 1, -1, -1, -1)
        match = r"\(1 <= B"
    elif bad == "weight_dtype":
        bn.weight.data = bn.weight.data.bfloat16()
        match = "weight must be float32"
    elif bad == "bias_shape":
        bn.bias.data = torch.zeros(4)
        match = "bias must be float32"
    elif bad == "running_var_shape":
        bn.running_var = torch.ones(8, 1)
        match = "running_var must be float32"
    elif bad == "skip_shape":
        skip = torch.zeros(4, 4, 19, 19).to(memory_format=torch.channels_last)
        match = "does not match"
    elif bad == "skip_dtype":
        skip, match = x.bfloat16(), "does not match"
    elif bad == "skip_nchw":
        skip, match = x.contiguous(), "channels-last"
    return x, bn, skip, match


@pytest.mark.parametrize("bad", ["nchw", "dtype", "board", "batch",
                                 "weight_dtype", "bias_shape",
                                 "running_var_shape", "skip_shape",
                                 "skip_dtype", "skip_nchw", "cpu"])
def test_forward_wrapper_raises_without_launching(bad):
    x, bn, skip, match = _bad_forward(bad)
    before = cuda_bn_epilogue.launches
    with pytest.raises(ValueError, match=match):
        cuda_bn_epilogue.bn_relu_cuda(x, bn, skip)
    assert cuda_bn_epilogue.launches == before


@pytest.mark.parametrize("bad", ["nchw", "x_mismatch", "y_mismatch",
                                 "dtype", "saved_shape", "weight_dtype",
                                 "cpu"])
def test_backward_wrapper_raises_without_launching(bad):
    dy = torch.zeros(4, 8, 19, 19).to(memory_format=torch.channels_last)
    x, y = dy.clone(), dy.clone()
    saved, weight, bias = torch.zeros(2, 8), torch.ones(8), torch.zeros(8)
    match = "one CUDA device"
    if bad == "nchw":
        dy, match = dy.contiguous(), "channels-last"
    elif bad == "x_mismatch":
        x, match = x.bfloat16(), "does not match"
    elif bad == "y_mismatch":
        y, match = y[:2], "does not match"
    elif bad == "dtype":
        dy, x, y = dy.double(), x.double(), y.double()
        match = "bfloat16 or float32"
    elif bad == "saved_shape":
        saved, match = torch.zeros(8), "saved must be float32"
    elif bad == "weight_dtype":
        weight, match = weight.bfloat16(), "weight must be float32"
    before = cuda_bn_epilogue.bwd_launches
    with pytest.raises(ValueError, match=match):
        cuda_bn_epilogue.bn_relu_backward_cuda(dy, x, saved, weight, bias, y)
    assert cuda_bn_epilogue.bwd_launches == before


@pytest.mark.parametrize("b", [1, 8, 512, 4096])
@pytest.mark.parametrize("c", [1, 2, 16, 256])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("resident", [None, 2, 3, 8])
def test_plan_is_fixed_by_the_shapes_and_covers_the_batch(b, c, elem_bytes,
                                                          resident):
    sms = 132
    got = cuda_bn_epilogue.plan(b, c, elem_bytes, sms, True, resident)
    assert got == cuda_bn_epilogue.plan.__wrapped__(b, c, elem_bytes, sms,
                                                    True, resident)
    vector, points, rows, slabs = got
    assert vector == (16 // elem_bytes if c % (16 // elem_bytes) == 0 else 1)
    # a block covers whole points, as many as its threads hold
    groups = c // vector
    assert points * groups <= cuda_bn_epilogue.THREADS
    assert (points + 1) * groups > cuda_bn_epilogue.THREADS
    assert rows * slabs >= b > rows * (slabs - 1)
    tiles = math.ceil(361 / points)
    if resident is None:
        # an elementwise pass: short slabs
        assert rows == min(b, cuda_bn_epilogue.APPLY_ROWS)
    else:
        # a reducing pass: one wave, as full as the tiles and rows allow
        assert slabs <= max(1, min(b, resident * sms // tiles))
        assert tiles * slabs <= max(tiles, resident * sms)
    # unaligned tensors take one value a thread
    assert cuda_bn_epilogue.plan(b, c, elem_bytes, sms, False,
                                 resident)[0] == 1


def test_plan_vectors_at_the_networks_widths():
    assert cuda_bn_epilogue.plan(512, 256, 2, 132)[:2] == (8, 8)
    assert cuda_bn_epilogue.plan(512, 2, 2, 132)[:2] == (1, 128)
    assert cuda_bn_epilogue.plan(512, 1, 2, 132)[:2] == (1, 256)
    with pytest.raises(ValueError, match="at most 2048 channels"):
        cuda_bn_epilogue.plan(8, 2056, 2, 132)


class _PlainKernels:
    """The kernel wrappers' contracts in plain PyTorch, for the CPU: the
    autograd node over them is then checked without a card."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _per_channel(t):
        return t.view(1, -1, 1, 1)

    @staticmethod
    def _acc(t):
        """float32, or float64 for float64 (the test's)."""
        return t.to(torch.promote_types(t.dtype, torch.float32))

    def forward(self, x, bn, skip=None):
        self.calls.append("forward")
        out, mean, invstd = torch.ops.aten.native_batch_norm(
            x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
            bn.training, bn.momentum, bn.eps)
        y = F.relu(out if skip is None else out + skip)
        return y, torch.stack([mean, invstd])

    def _mask(self, x, saved, weight, bias):
        m, s = (self._per_channel(t) for t in saved)
        bn = ((self._acc(x) - m) * s * self._per_channel(weight)
              + self._per_channel(bias)).to(x.dtype)
        return bn > 0

    def backward(self, dy, x, saved, weight, bias, y=None):
        self.calls.append("backward")
        mask = self._mask(x, saved, weight, bias) if y is None else y > 0
        e = torch.where(mask, dy, torch.zeros_like(dy))
        n = x.numel() // x.shape[1]
        m, s, w = (self._per_channel(t) for t in (*saved, weight))
        centred = self._acc(x) - m
        sum_dy = self._acc(e).sum((0, 2, 3))
        sum_dyx = (self._acc(e) * centred).sum((0, 2, 3))
        f1 = s * s * self._per_channel(sum_dyx) / n
        dx = ((self._acc(e) - self._per_channel(sum_dy) / n - centred * f1)
              * w * s).to(x.dtype)
        return dx, sum_dyx * saved[1], sum_dy, None if y is None else e


@pytest.mark.parametrize("with_skip", [False, True])
def test_autograd_node_over_the_kernels_gives_the_plain_gradients(
        monkeypatch, with_skip):
    """``BNReLU`` over the kernel wrappers' contracts gives the plain
    version's output, gradients (x, the scale and shift, the skip) and
    running statistics, with one forward and one backward call."""
    fake = _PlainKernels()
    monkeypatch.setattr(cuda_bn_epilogue, "bn_relu_cuda", fake.forward)
    monkeypatch.setattr(cuda_bn_epilogue, "bn_relu_backward_cuda",
                        fake.backward)
    planes, weight, skip, probe = _conv_case(8, torch.float64, seed=3)
    skip = skip if with_skip else None
    bn = _bn(8, seed=4, training=True).double()

    def node(x, b, s):
        return cuda_bn_epilogue.BNReLU.apply(x, b.weight, b.bias, s, b)

    got = _through(node, copy.deepcopy(bn), planes, weight, skip, probe)
    want = _through(plain.bn_relu, copy.deepcopy(bn), planes, weight, skip,
                    probe)
    assert fake.calls == ["forward", "backward"]
    assert torch.allclose(got[0], want[0], rtol=1e-12, atol=1e-12)
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-12)


# -- on the card --------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _spacing(v: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype``'s values at |v| (float32 v)."""
    bits = 8 if dtype == torch.bfloat16 else 24
    e = torch.frexp(v.abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(v), e - bits)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _card_case(b, c, dtype, seed, device):
    """x, a skip and a probe gradient, channels-last, with exact zeros and
    negative zeros in x; x's channels carry means and scales of their own."""
    g = torch.Generator(device=device).manual_seed(seed)
    scale = 0.5 + torch.rand(c, generator=g, device=device)
    shift = torch.randn(c, generator=g, device=device)
    x = torch.randn(b, 19, 19, c, generator=g, device=device) * scale + shift
    x.view(-1)[::7] = 0.0
    x.view(-1)[3::11] = -0.0
    skip = torch.randn(b, 19, 19, c, generator=g, device=device)
    probe = torch.randn(b, 19, 19, c, generator=g, device=device)
    return tuple(t.to(dtype).permute(0, 3, 1, 2) for t in (x, skip, probe))


def _scale(x, mean, invstd, bn):
    """(|x - mean| + |mean|) * |w invstd| + |shift| per element: the size of
    BN's terms, whose float32 roundings bound how far two computations of
    BN's value from the same statistics lie apart."""
    def per_channel(t):
        return t.float().view(1, -1, 1, 1)

    m = per_channel(mean)
    return (((x.float() - m).abs() + m.abs())
            * per_channel(bn.weight * invstd).abs()
            + per_channel(bn.bias).abs())


def _y_tolerance(y, y_want, pre, scale, dtype):
    """One spacing of ``dtype`` at |y| and one at BN's value ``pre`` (BN's
    rounded value may differ by its last bit, and a skip sum rounds that
    difference once more: two ties that round apart make two spacings of
    y), and 2^-19 of BN's terms' size (the statistics' and the transform's
    float32 roundings, in another order: where BN's value lies near 0 they
    outweigh its own spacing, and may set the ReLU mask apart)."""
    at = torch.maximum(y.float().abs(), y_want.float().abs())
    return (_spacing(at, dtype) + _spacing(pre.float(), dtype)
            + scale * 2.0 ** -19)


def _run(epilogue, bn, x, skip, probe):
    """Output, gradients (x, scale, shift[, skip]) and running statistics
    after one train-mode call."""
    x = x.detach().requires_grad_()
    skip = None if skip is None else skip.detach().requires_grad_()
    y = epilogue(x, bn, skip)
    leaves = [x, bn.weight, bn.bias] + ([] if skip is None else [skip])
    grads = torch.autograd.grad(y, leaves, probe)
    return y.detach(), grads, (bn.running_mean.clone(),
                               bn.running_var.clone())


def _check_against_plain(got, want, bn_want, scale, dtype, what):
    """Float32: every tensor within 1e-5 of its largest value. bf16: y
    within ``_y_tolerance``, dX within one spacing at |dX| or 1e-5 of its
    largest value. The ReLU mask is a step: where BN's value lies within a
    rounding of 0 the two statistics' last bits may set it apart. Such
    points are a millionth or less; their elements and the scale's and
    shift's gradients of their channels are left out of the gradient
    comparison."""
    y, grads, stats = got
    y_want, grads_want, stats_want = want
    flip = (y > 0) != (y_want > 0)
    assert int(flip.sum()) <= flip.numel() // 10**6 + 1, what
    if dtype == torch.float32:
        assert _rel(y, y_want) <= 1e-5, what
    else:
        tol = _y_tolerance(y, y_want, bn_want, scale, dtype)
        assert bool(((y.float() - y_want.float()).abs() <= tol).all()), what
    keep = ~flip
    kept_channels = ~flip.any(dim=(0, 2, 3))
    for i, (a, b) in enumerate(zip(grads, grads_want)):
        if a.dim() == 1:  # the scale's and shift's float32 gradients
            assert a.dtype == torch.float32, what
            assert _rel(a[kept_channels], b[kept_channels]) <= 1e-5, \
                (what, i)
        elif dtype == torch.float32:
            assert _rel(a[keep], b[keep]) <= 1e-5, (what, i)
        else:
            af, bf = a.float()[keep], b.float()[keep]
            floor = 1e-5 * bf.abs().max()
            tol = torch.maximum(_spacing(torch.maximum(af.abs(), bf.abs()),
                                         dtype), floor)
            assert bool(((af - bf).abs() <= tol).all()), (what, i)
    for a, b in zip(stats, stats_want):
        assert _rel(a, b) <= 1e-5, what


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_card_kernels_match_plain(dtype):
    device = _card()
    tdt = DTYPES[dtype]
    for b in (512, 8):
        for c in (256, 2, 1):
            for with_skip in (False, True):
                what = (b, c, dtype, with_skip)
                x, skip, probe = _card_case(b, c, tdt, b + c, device)
                skip = skip if with_skip else None
                bn = _bn(c, seed=c, training=True, device=device)
                got = _run(ops.bn_relu, copy.deepcopy(bn), x, skip, probe)
                again = _run(ops.bn_relu, copy.deepcopy(bn), x, skip, probe)
                want = _run(plain.bn_relu, copy.deepcopy(bn), x, skip, probe)
                bn_want, mean, invstd = torch.ops.aten.native_batch_norm(
                    x, bn.weight, bn.bias, bn.running_mean.clone(),
                    bn.running_var.clone(), True, bn.momentum, bn.eps)
                scale = _scale(x, mean, invstd, bn).detach()
                torch.cuda.synchronize(device)
                assert got[0].is_contiguous(
                    memory_format=torch.channels_last), what
                _check_against_plain(got, want, bn_want.detach(), scale, tdt,
                                     what)
                # bitwise the same from run to run
                for a, a2 in zip((got[0], *got[1], *got[2]),
                                 (again[0], *again[1], *again[2])):
                    assert torch.equal(a, a2), what
                # eval mode: the apply kernel alone on the running
                # statistics, bitwise PyTorch's transform in bf16; float32
                # runs through cuDNN's batch norm, whose transform orders
                # its operations otherwise: within _y_tolerance
                bn.eval()
                with torch.no_grad():
                    y = ops.bn_relu(x, bn, skip)
                    y_want = plain.bn_relu(x, bn, skip)
                    pre = F.batch_norm(x, bn.running_mean, bn.running_var,
                                       bn.weight, bn.bias, False, 0.0,
                                       bn.eps)
                if tdt == torch.bfloat16:
                    assert torch.equal(y, y_want), what
                else:
                    scale = _scale(x, bn.running_mean, torch.rsqrt(
                        bn.running_var + bn.eps), bn)
                    tol = _y_tolerance(y, y_want, pre, scale, tdt)
                    assert bool(((y - y_want).abs() <= tol).all()), what


def test_card_train_step_launches_each_way_per_bn():
    device = _card()
    from deepgo_tpu_torch.training import make_train_step, sgd

    cfg = resnet.ResNetConfig(blocks=3, channels=256)
    model = resnet.init(torch.Generator().manual_seed(0), cfg, device=device)
    optimizer = sgd(0.01, momentum=0.9)
    step = make_train_step(cfg, optimizer)
    g = torch.Generator().manual_seed(1)
    b = 8
    batch = {"packed": torch.randint(0, 3, (b, 9, 19, 19), generator=g,
                                     dtype=torch.uint8),
             "player": torch.randint(1, 3, (b,), generator=g,
                                     dtype=torch.int32),
             "rank": torch.randint(1, 10, (b,), generator=g,
                                   dtype=torch.int32),
             "target": torch.randint(0, 361, (b,), generator=g,
                                     dtype=torch.int32),
             "z": torch.ones(b)}
    batch = {k: v.to(device) for k, v in batch.items()}
    state = optimizer.init(model)
    step(model, state, batch)
    torch.cuda.synchronize(device)
    cuda_bn_epilogue.reset_launches()
    _, state, loss = step(model, state, batch)
    torch.cuda.synchronize(device)
    assert torch.isfinite(loss)
    # 2 * blocks + 1 each way: the stem, two a residual block, the heads
    assert cuda_bn_epilogue.launches == cuda_bn_epilogue.bwd_launches == 7
    # an eval-mode forward: one call a BN, no backward; with a gradient to
    # take it raises, as the kernels have no eval-mode backward
    cuda_bn_epilogue.reset_launches()
    planes = torch.zeros(b, 19, 19, 37, device=device)
    model.eval()
    with torch.no_grad():
        model(planes)
    assert (cuda_bn_epilogue.launches, cuda_bn_epilogue.bwd_launches) == (7, 0)
    with pytest.raises(ValueError, match="no eval-mode backward"):
        model(planes)
