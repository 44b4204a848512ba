// Packed record -> 37 binary model planes, on Hopper (sm_90a).
//
// Replaces the TPU kernel deepgo_tpu/ops/pallas_expand.py::_expand_kernel
// (its plane grammar is _planes_from_packed). The function is exactly
// deepgo_tpu/ops/expand.py::expand_planes and its plain PyTorch port,
// deepgo_tpu_torch/ops/expand.py, for any uint8 record and any int32
// player / rank:
//
//   planes 0-2    empty, mine (stones == player), theirs (stones == 3 - player)
//   planes 3-6    liberties == 1, 2, 3, >= 4
//   plane  7      empty && lib_after == 0
//   planes 8-13   lib_after == 1..5, >= 6
//   planes 14-20  kills == 1..6, >= 7
//   planes 21-25  age == 1..5
//   plane  26     ladder >= 1
//   plane  27     always 0
//   planes 28-36  rank == 1..9 (a rank outside 1..9 sets no plane)
//
// with lib_after / kills / ladder read from channels 2/4/7 when player == 1
// and from 3/5/8 otherwise. Channel values are compared as int, so 255
// fires no "== i" plane.
//
// Bound on an H100 (3.35 TB/s): per board it reads 3,249 + 8 bytes and
// writes 13,357 planes (26,714 bytes in bf16, 53,428 in f32). At the top
// serving rung, B = 512 in bf16, that is 15.3 MB, about 4.6 us. The work is
// a few integer compares per output, so bytes bound it; at the serving
// shapes the launch itself dominates.
//
// Design: one block per board, one thread per point (384 threads, 361
// active). A thread reads its point's 9 channel bytes (coalesced across the
// threads of a channel), compares them once, and writes its 37 planes into
// a shared-memory byte tile laid out as the board's NHWC output. The block
// then stores the whole tile as one contiguous run of 13,357 elements,
// writing 1.0 / 0.0 as bit patterns (0x3F80 / 0x0000 for bf16), so no
// float arithmetic and no transpose pass follow. Player and rank are read
// once per block.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPoints = 361;
constexpr int kChannels = 9;
constexpr int kPlanes = 37;
constexpr int kTile = kPoints * kPlanes;  // outputs per board
constexpr int kThreads = 384;             // 12 warps cover the 361 points

template <typename T, T kOne>
__global__ void __launch_bounds__(kThreads)
expand_planes_kernel(const uint8_t* __restrict__ packed,
                     const int32_t* __restrict__ player,
                     const int32_t* __restrict__ rank,
                     T* __restrict__ out) {
  __shared__ uint8_t tile[kTile];
  const int64_t b = blockIdx.x;
  const int p = threadIdx.x;
  const int me = player[b];
  const int rk = rank[b];

  if (p < kPoints) {
    const uint8_t* src = packed + b * (kChannels * kPoints) + p;
    const bool black = me == 1;
    const int stones = src[0 * kPoints];
    const int libs = src[1 * kPoints];
    const int lib_after = src[(black ? 2 : 3) * kPoints];
    const int kills = src[(black ? 4 : 5) * kPoints];
    const int age = src[6 * kPoints];
    const int ladder = src[(black ? 7 : 8) * kPoints];
    const bool empty = stones == 0;

    uint8_t* t = tile + p * kPlanes;
    t[0] = empty;
    t[1] = stones == me;
    t[2] = stones == 3 - me;
#pragma unroll
    for (int i = 1; i <= 3; ++i) t[2 + i] = libs == i;
    t[6] = libs >= 4;
    t[7] = empty && lib_after == 0;
#pragma unroll
    for (int i = 1; i <= 5; ++i) t[7 + i] = lib_after == i;
    t[13] = lib_after >= 6;
#pragma unroll
    for (int i = 1; i <= 6; ++i) t[13 + i] = kills == i;
    t[20] = kills >= 7;
#pragma unroll
    for (int i = 1; i <= 5; ++i) t[20 + i] = age == i;
    t[26] = ladder >= 1;
    t[27] = 0;
#pragma unroll
    for (int i = 1; i <= 9; ++i) t[27 + i] = rk == i;
  }
  __syncthreads();

  T* dst = out + b * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    dst[i] = tile[i] ? kOne : T(0);
  }
}

}  // namespace

// Launches the expansion of `batch` boards on `stream`.
//   packed: (batch, 9, 19, 19) uint8, contiguous
//   player, rank: (batch,) int32
//   out: (batch, 19, 19, 37), contiguous, bf16 (out_bytes == 2) or
//        float32 (out_bytes == 4)
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int deepgo_expand_planes(const void* packed, const void* player,
                                    const void* rank, void* out, int batch,
                                    int out_bytes, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(packed);
  const auto* pl = static_cast<const int32_t*>(player);
  const auto* rk = static_cast<const int32_t*>(rank);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_bytes == 2) {
    expand_planes_kernel<uint16_t, uint16_t{0x3F80}><<<batch, kThreads, 0, s>>>(
        in, pl, rk, static_cast<uint16_t*>(out));
  } else if (out_bytes == 4) {
    expand_planes_kernel<uint32_t, 0x3F800000u><<<batch, kThreads, 0, s>>>(
        in, pl, rk, static_cast<uint32_t*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
