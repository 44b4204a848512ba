"""The port's packed-record expansion against the JAX package.

The plain PyTorch ``expand_planes`` must equal, exactly, the JAX XLA
expansion, the Pallas kernel in interpret mode and the NumPy reference, for
random records over the whole uint8 range. The CUDA kernel is held against
the plain version on the card (``chip_smoke.py``, and the last test here
when a card is present)."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepgo_tpu import features as jfeatures
from deepgo_tpu.ops.expand import expand_planes as jax_expand
from deepgo_tpu.ops.pallas_expand import expand_planes_pallas

from deepgo_tpu_torch import features
from deepgo_tpu_torch.ops import _build, cuda_expand, expand_planes
from deepgo_tpu_torch.ops import expand as plain

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(b, seed, players=(1, 2), ranks=(1, 9)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(b, 9, 19, 19), dtype=np.uint8),
            rng.integers(players[0], players[1] + 1, size=b).astype(np.int32),
            rng.integers(ranks[0], ranks[1] + 1, size=b).astype(np.int32))


def _port(packed, player, rank, dtype):
    out = plain.expand_planes(torch.from_numpy(packed),
                              torch.from_numpy(player),
                              torch.from_numpy(rank), dtype=dtype)
    return out.float().numpy()


def _jax(fn, packed, player, rank, dtype, **kw):
    out = fn(jnp.asarray(packed), jnp.asarray(player), jnp.asarray(rank),
             dtype=dtype, **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["random", "age255", "any_player_rank"])
def test_plain_matches_jax_xla(dtype, case):
    tdt, jdt = DTYPES[dtype]
    if case == "any_player_rank":
        # out-of-range player / rank: int32 semantics, no rank plane fires
        packed, player, rank = _inputs(24, 3, players=(-1, 4), ranks=(-2, 11))
    else:
        packed, player, rank = _inputs(24, 1)
    if case == "age255":
        packed[:, 6] = 255
    got = _port(packed, player, rank, tdt)
    want = _jax(jax_expand, packed, player, rank, jdt)
    assert got.shape == (24, 19, 19, 37)
    assert np.array_equal(got, want)
    if case == "age255":
        assert got[..., 21:26].sum() == 0  # no age plane fires at 255


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_interpret(dtype):
    tdt, jdt = DTYPES[dtype]
    packed, player, rank = _inputs(16, 2)
    packed[:8, 1] = 255  # liberties at the top of the range
    got = _port(packed, player, rank, tdt)
    want = _jax(expand_planes_pallas, packed, player, rank, jdt,
                interpret=True)
    assert np.array_equal(got, want)


def test_plain_matches_numpy_reference_both_players_all_ranks():
    packed, _, _ = _inputs(18, 4)
    player = np.array([1, 2] * 9, dtype=np.int32)
    rank = np.repeat(np.arange(1, 10, dtype=np.int32), 2)
    got = _port(packed, player, rank, torch.float32)
    for i in range(len(packed)):
        want = features.expand_planes_np(packed[i], int(player[i]),
                                         int(rank[i]))
        assert np.array_equal(got[i], want.transpose(1, 2, 0)), i


def test_numpy_reference_copy_matches_jax_features():
    for name in ("P_STONES", "P_LIBERTIES", "P_LIB_AFTER", "P_KILLS", "P_AGE",
                 "P_LADDERS", "PACKED_CHANNELS", "X_STONE", "X_LIBERTIES",
                 "X_LIB_AFTER", "X_KILLS", "X_AGE", "X_LADDER", "X_RANK_BASE",
                 "NUM_PLANES"):
        assert getattr(features, name) == getattr(jfeatures, name), name
    assert features.target_index(3, 7) == jfeatures.target_index(3, 7)
    packed, _, _ = _inputs(4, 5)
    for i, (player, rank) in enumerate([(1, 1), (2, 9), (1, 5), (2, 3)]):
        assert np.array_equal(
            features.expand_planes_np(packed[i], player, rank),
            jfeatures.expand_planes_np(packed[i], player, rank))


def test_numpy_reference_rejects_out_of_range():
    packed, _, _ = _inputs(1, 0)
    with pytest.raises(ValueError):
        features.expand_planes_np(packed[0], 3, 1)
    with pytest.raises(ValueError):
        features.expand_planes_np(packed[0], 1, 10)
    with pytest.raises(ValueError):
        features.expand_planes_np(packed[0, :8], 1, 1)


def test_dispatch_sends_cpu_tensors_to_plain_version():
    packed, player, rank = _inputs(5, 6)
    args = (torch.from_numpy(packed), torch.from_numpy(player),
            torch.from_numpy(rank))
    before = cuda_expand.launches
    got = expand_planes(*args, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, plain.expand_planes(*args, dtype=torch.bfloat16))
    assert cuda_expand.launches == before
    # the NHWC output seen as NCHW is the conv's channels-last layout
    assert got.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)


def test_dispatch_refuses_other_devices():
    meta = torch.empty((2, 9, 19, 19), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no expansion"):
        expand_planes(meta, meta[:, 0, 0, 0].int(), meta[:, 0, 0, 0].int())


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "player", "empty",
                                 "out_dtype"])
def test_kernel_wrapper_raises_on_what_it_cannot_take(bad):
    packed = torch.zeros((2, 9, 19, 19), dtype=torch.uint8)
    player = torch.ones(2, dtype=torch.int32)
    rank = torch.ones(2, dtype=torch.int32)
    dtype = torch.bfloat16
    if bad == "dtype":
        packed = packed.int()
    elif bad == "shape":
        packed = packed[:, :8]
    elif bad == "player":
        player = player.long()
    elif bad == "empty":
        packed = packed[:0]
    elif bad == "out_dtype":
        dtype = torch.float16
    before = cuda_expand.launches
    with pytest.raises(ValueError):
        cuda_expand.expand_planes_cuda(packed, player, rank, dtype=dtype)
    assert cuda_expand.launches == before


def test_nvcc_command_targets_hopper():
    cmd = _build.nvcc_command("nvcc", _build.CSRC / "expand.cu",
                              _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    assert [s.stem for s in _build.sources()] == ["bn_epilogue", "epilogue",
                                                 "expand"]
    # the library name follows the source's content
    assert _build.library_path(_build.CSRC / "expand.cu").suffix == ".so"


def test_build_without_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["expand"])
    assert not build_dir.exists()


def test_cuda_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    # B = 1, 7, 37: B * 361 * 37 planes is not a whole number of 16-byte
    # vectors, so the last one is ragged; "sliced" starts at an odd address
    for b, sliced in ((1, False), (7, False), (8, False), (37, False),
                      (37, True)):
        packed, player, rank = _inputs(b + sliced, b, players=(0, 3),
                                       ranks=(0, 10))
        args = [torch.from_numpy(a)[int(sliced):]
                for a in (packed, player, rank)]
        for tdt, _ in DTYPES.values():
            want = plain.expand_planes(*args, dtype=tdt)
            got = expand_planes(*(a.cuda() for a in args), dtype=tdt)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (b, sliced, tdt)
    assert isinstance(cuda_expand._kernel(), ctypes._CFuncPtr)
