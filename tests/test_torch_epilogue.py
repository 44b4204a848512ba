"""The convolution epilogue (a bias per channel and board point, then ReLU).

On the CPU, ``ops.bias_relu`` is the plain expression the network used
before the CUDA kernels: outputs and gradients stay bitwise what they were,
so the parity tests against the JAX package see the same numbers. The
kernel wrappers refuse what their kernels do not take without launching.
The kernels (``csrc/epilogue.cu``) are held against the plain version in
the last tests here when a card is present, and in ``chip_smoke.py``."""

import math

import pytest
import torch
import torch.nn.functional as F

from deepgo_tpu_torch import ops
from deepgo_tpu_torch.models import policy_cnn, value_cnn
from deepgo_tpu_torch.ops import cuda_epilogue
from deepgo_tpu_torch.ops import epilogue as plain

torch.set_num_threads(2)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _expression(x, bias, relu):
    """The epilogue as PositionBiasConv and _conv_layer wrote it out."""
    x = x + bias.to(x.dtype)[None]
    return F.relu(x) if relu else x


def _conv_case(c, dtype, seed, b=3, c_in=5):
    g = torch.Generator().manual_seed(seed)
    planes = torch.randn(b, c_in, 19, 19, generator=g).to(
        dtype=dtype, memory_format=torch.channels_last)
    weight = torch.randn(c, c_in, 3, 3, generator=g).requires_grad_()
    bias = (0.5 * torch.randn(c, 19, 19, generator=g)).requires_grad_()
    probe = torch.randn(b, c, 19, 19, generator=g)
    return planes, weight, bias, probe


def _through(epilogue, planes, weight, bias, probe, relu):
    x = F.conv2d(planes, weight.to(planes.dtype), padding=1)
    y = epilogue(x, bias, relu)
    grads = torch.autograd.grad((y.float() * probe).sum(), (weight, bias))
    return y, grads


@pytest.mark.parametrize("c", [1, 128, 256])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_path_is_the_expression_bitwise(dtype, relu, c):
    case = _conv_case(c, DTYPES[dtype], seed=c)
    want, want_grads = _through(_expression, *case, relu)
    for epilogue in (ops.bias_relu, plain.bias_relu):
        got, got_grads = _through(epilogue, *case, relu)
        assert got.dtype == DTYPES[dtype]
        assert torch.equal(got, want)
        for a, b in zip(got_grads, want_grads):
            assert a.dtype == torch.float32 and torch.equal(a, b)


def test_cpu_tensors_never_reach_the_kernels():
    cuda_epilogue.reset_launches()
    model = policy_cnn.init(torch.Generator().manual_seed(0),
                            policy_cnn.CONFIGS["small"], device="cpu")
    planes = torch.randn(2, 19, 19, 37)
    loss = model(planes).logsumexp(-1).sum()
    loss.backward()
    with torch.inference_mode():
        model(planes)
    assert (cuda_epilogue.launches, cuda_epilogue.bwd_launches) == (0, 0)


def _bad_forward(bad):
    x = torch.zeros(4, 8, 19, 19).to(memory_format=torch.channels_last)
    bias = torch.zeros(8, 19, 19)
    if bad == "nchw":
        x = x.contiguous()
        match = "channels-last"
    elif bad == "bias_shape":
        bias = torch.zeros(8, 361)
        match = "bias must be"
    elif bad == "bias_dtype":
        bias = bias.bfloat16()
        match = "bias must be"
    elif bad == "dtype":
        x = x.half()
        match = "bfloat16 or float32"
    elif bad == "board":
        x = torch.zeros(4, 8, 9, 9).to(memory_format=torch.channels_last)
        match = r"\(B >= 1"
    else:  # the CPU tensors themselves
        match = "one CUDA device"
    return x, bias, match


@pytest.mark.parametrize("bad", ["nchw", "bias_shape", "bias_dtype", "dtype",
                                 "board", "cpu"])
def test_forward_wrapper_raises_without_launching(bad):
    x, bias, match = _bad_forward(bad)
    before = cuda_epilogue.launches
    with pytest.raises(ValueError, match=match):
        cuda_epilogue.bias_relu_cuda(x, bias, True)
    assert cuda_epilogue.launches == before


@pytest.mark.parametrize("bad", ["nchw", "mismatch", "dtype", "cpu"])
def test_backward_wrapper_raises_without_launching(bad):
    dy = torch.zeros(4, 8, 19, 19).to(memory_format=torch.channels_last)
    y = dy.clone()
    match = "one CUDA device"
    if bad == "nchw":
        dy, match = dy.contiguous(), "channels-last"
    elif bad == "mismatch":
        y, match = y.bfloat16(), "does not match"
    elif bad == "dtype":
        dy, y, match = dy.double(), y.double(), "bfloat16 or float32"
    before = cuda_epilogue.bwd_launches
    with pytest.raises(ValueError, match=match):
        cuda_epilogue.bias_relu_backward_cuda(dy, y)
    assert cuda_epilogue.bwd_launches == before


def _written_out(model, planes):
    """PolicyCNN's forward with the epilogue written out, as it was."""
    cfg = model.cfg
    x = planes.permute(0, 3, 1, 2).to(cfg.torch_dtype)
    last = len(model.layers) - 1
    for i, layer in enumerate(model.layers):
        x = F.conv2d(x, layer.weight.to(x.dtype),
                     padding=layer.weight.shape[-1] // 2)
        x = _expression(x, layer.bias, i < last or cfg.final_relu)
    return x.reshape(x.shape[0], 361).float()


@pytest.mark.parametrize("name", ["small", "full"])
def test_policy_cnn_on_the_cpu_is_unchanged(name):
    cfg = policy_cnn.CONFIGS[name]
    model = policy_cnn.init(torch.Generator().manual_seed(7), cfg,
                            device="cpu")
    with torch.no_grad():
        for layer in model.layers:
            layer.bias.normal_(0.0, 0.05, generator=torch.Generator()
                               .manual_seed(layer.bias.shape[0]))
    g = torch.Generator().manual_seed(11)
    planes = (torch.rand(3, 19, 19, 37, generator=g) < 0.3).float()
    target = torch.randint(0, 361, (3,), generator=g)
    params = list(model.parameters())
    results = []
    for forward in (model, lambda p: _written_out(model, p)):
        logits = forward(planes)
        loss = F.cross_entropy(logits, target)
        results.append((logits, torch.autograd.grad(loss, params)))
    (got, got_grads), (want, want_grads) = results
    assert torch.equal(got, want)
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)


def test_every_layer_goes_through_ops_bias_relu(monkeypatch):
    calls = []
    real = ops.bias_relu

    def spy(x, bias, relu=True):
        calls.append((x.shape[1], relu))
        return real(x, bias, relu)

    monkeypatch.setattr(ops, "bias_relu", spy)
    for final_relu in (False, True):
        calls.clear()
        cfg = policy_cnn.ModelConfig(num_layers=3, channels=(8, 16),
                                     final_relu=final_relu)
        model = policy_cnn.init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        model(torch.zeros(2, 19, 19, 37))
        assert calls == [(8, True), (16, True), (1, final_relu)]
    calls.clear()
    vcfg = value_cnn.ValueConfig(num_layers=2, channels=8)
    value_cnn.init(torch.Generator().manual_seed(0), vcfg,
                   device="cpu")(torch.zeros(2, 19, 19, 37))
    assert calls == [(8, True), (8, True), (1, True)]


def test_value_cnn_on_the_cpu_is_unchanged():
    vcfg = value_cnn.ValueConfig(num_layers=2, channels=8)
    model = value_cnn.init(torch.Generator().manual_seed(3), vcfg,
                           device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape,
                                     generator=torch.Generator()
                                     .manual_seed(p.numel())))
    planes = torch.randn(2, 19, 19, 37)
    dtype = vcfg.torch_dtype
    x = planes.permute(0, 3, 1, 2).to(dtype)
    for layer in [*model.layers, model.head_conv]:
        x = F.conv2d(x, layer.weight.to(dtype),
                     padding=layer.weight.shape[-1] // 2)
        x = _expression(x, layer.bias, True)
    x = x.reshape(2, 361)
    x = F.relu(F.linear(x, model.dense1.weight.to(dtype),
                        model.dense1.bias.to(dtype)))
    want = F.linear(x, model.dense2.weight.to(dtype),
                    model.dense2.bias.to(dtype))[:, 0].float()
    assert torch.equal(model(planes), want)


@pytest.mark.parametrize("b", [1, 7, 64, 1024, 8192])
@pytest.mark.parametrize("c", [1, 128, 256])
@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_plan_covers_the_batch_and_fills_the_card(b, c, elem_bytes):
    sms = 132
    vector, rows, slabs = cuda_epilogue.plan(b, c, elem_bytes, sms)
    assert vector == (16 // elem_bytes if c % (16 // elem_bytes) == 0 else 1)
    assert rows * slabs >= b > rows * (slabs - 1)
    tiles = math.ceil(361 * c / vector / cuda_epilogue.THREADS)
    assert tiles * slabs >= min(sms, tiles * b)
    assert tiles * slabs <= 2 * cuda_epilogue.BLOCKS_PER_SM * sms
    # unaligned tensors take one value a thread
    assert cuda_epilogue.plan(b, c, elem_bytes, sms, aligned=False)[0] == 1


# -- on the card --------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _card_inputs(b, c, dtype, seed):
    """x with exact zeros, negative zeros and ties of x + bias to 0; bias
    with negative zeros; a probe gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, 19, 19, c, generator=g, device="cuda").to(dtype)
    x.view(-1)[::7] = 0.0
    x.view(-1)[3::11] = -0.0
    bias = 0.5 * torch.randn(c, 19, 19, generator=g, device="cuda")
    bias.view(-1)[::5] = -0.0
    # x = -bias.to(dtype) at some points: the sum is exactly 0
    tie = -bias.to(dtype).permute(1, 2, 0)
    x[::3, :, :, :] = torch.where(torch.rand(x[::3].shape, generator=g,
                                             device="cuda") < 0.1,
                                  tie[None].expand_as(x[::3]), x[::3])
    probe = torch.randn(b, 19, 19, c, generator=g, device="cuda").to(dtype)
    return (x.permute(0, 3, 1, 2), bias, probe.permute(0, 3, 1, 2))


def _spacing(v: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype``'s values at |v| (float32 v)."""
    bits = 8 if dtype == torch.bfloat16 else 24
    e = torch.frexp(v.abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(v), e - bits)


def _same_sum(got: torch.Tensor, want: torch.Tensor, dtype) -> bool:
    """Two bias gradients, one sum in two orders, each rounded to ``dtype``:
    within one spacing of ``dtype`` at the larger of the two, or of 1e-5 of
    the largest gradient where both lie nearer 0 (there float32's own
    rounding of a long sum, in either order, is above the spacing)."""
    floor = 1e-5 * want.abs().max()
    at = torch.maximum(torch.maximum(got.abs(), want.abs()), floor)
    return bool(((got - want).abs() <= torch.maximum(
        _spacing(at, dtype), floor)).all())


def _grads(epilogue, x, bias, probe, relu):
    x = x.detach().requires_grad_()
    bias = bias.detach().requires_grad_()
    y = epilogue(x, bias, relu)
    dx, db = torch.autograd.grad(y, (x, bias), probe)
    return y.detach(), dx, db


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_card_kernels_match_plain(dtype):
    device = _card()
    tdt = DTYPES[dtype]
    for b in (64, 1024, 8192):
        for c in (1, 128, 256):
            for relu in (True, False):
                x, bias, probe = _card_inputs(b, c, tdt, seed=b + c)
                assert x.is_contiguous(memory_format=torch.channels_last)
                got = _grads(ops.bias_relu, x, bias, probe, relu)
                want = _grads(plain.bias_relu, x, bias, probe, relu)
                again = _grads(ops.bias_relu, x, bias, probe, relu)
                torch.cuda.synchronize(device)
                what = (b, c, dtype, relu)
                assert got[0].is_contiguous(
                    memory_format=torch.channels_last), what
                assert torch.equal(got[0], want[0]), what
                assert torch.equal(got[1], want[1]), what
                # the same sum in another order, and bitwise the same from
                # run to run
                assert got[2].dtype == torch.float32, what
                assert _same_sum(got[2], want[2], tdt), what
                assert torch.equal(again[2], got[2]), what
                with torch.inference_mode():
                    assert torch.equal(ops.bias_relu(x, bias, relu),
                                       want[0]), what


def test_card_large_step_launches_each_kernel_per_layer():
    device = _card()
    from deepgo_tpu_torch.training import make_train_step, sgd

    cfg = policy_cnn.CONFIGS["large"]
    model = policy_cnn.init(torch.Generator().manual_seed(0), cfg,
                            device=device)
    optimizer = sgd(0.005)
    step = make_train_step(cfg, optimizer)
    g = torch.Generator().manual_seed(1)
    b = 64
    batch = {"packed": torch.randint(0, 3, (b, 9, 19, 19), generator=g,
                                     dtype=torch.uint8),
             "player": torch.randint(1, 3, (b,), generator=g,
                                     dtype=torch.int32),
             "rank": torch.randint(1, 10, (b,), generator=g,
                                   dtype=torch.int32),
             "target": torch.randint(0, 361, (b,), generator=g,
                                     dtype=torch.int32)}
    batch = {k: v.to(device) for k, v in batch.items()}
    state = optimizer.init(model)
    step(model, state, batch)
    torch.cuda.synchronize(device)
    cuda_epilogue.reset_launches()
    _, state, loss = step(model, state, batch)
    torch.cuda.synchronize(device)
    assert torch.isfinite(loss)
    assert cuda_epilogue.launches == cfg.num_layers == 13
    assert cuda_epilogue.bwd_launches == 13


def test_card_remat_and_a_tensor_parallel_shard():
    device = _card()
    g = torch.Generator().manual_seed(2)
    planes = (torch.rand(64, 19, 19, 37, generator=g) < 0.3).float()
    base = policy_cnn.init(torch.Generator().manual_seed(0),
                           policy_cnn.ModelConfig(num_layers=4, channels=256),
                           device=device)
    with torch.no_grad():
        for layer in base.layers:
            layer.bias.copy_(0.05 * torch.randn(layer.bias.shape,
                                                generator=g))
    grads = []
    for remat in (False, True):
        model = policy_cnn.PolicyCNN(policy_cnn.ModelConfig(
            num_layers=4, channels=256, remat=remat)).to(device)
        model.load_state_dict(base.state_dict())
        cuda_epilogue.reset_launches()
        loss = model(planes.to(device)).logsumexp(-1).sum()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
        torch.cuda.synchronize(device)
        # remat replays each layer's forward in the backward, up to what it
        # saved: the last layer's epilogue (no ReLU) saves nothing, so its
        # replay stops at the convolution
        assert cuda_epilogue.launches == (7 if remat else 4)
        assert cuda_epilogue.bwd_launches == 4
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # a model rank's shard: 128 of a 256-wide layer's channels
    x, bias, probe = _card_inputs(64, 256, torch.bfloat16, seed=5)
    shard = slice(128, 256)

    def part(t):
        return t[:, shard].contiguous(memory_format=torch.channels_last)

    got = _grads(ops.bias_relu, part(x), bias[shard].contiguous(),
                 part(probe), True)
    full = _grads(ops.bias_relu, x, bias, probe, True)
    torch.cuda.synchronize(device)
    assert torch.equal(got[0], full[0][:, shard])
    assert torch.equal(got[1], full[1][:, shard])
    assert _same_sum(got[2], full[2][shard], torch.bfloat16)
