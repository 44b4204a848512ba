// Packed record -> 37 binary model planes, on Hopper (sm_90a): the plain
// expansion and the expansion fused with the dihedral-view gather.
//
// Replaces the TPU kernels in deepgo_tpu/ops/pallas_expand.py:
//   expand_planes_kernel      <- _expand_kernel      (launcher expand_planes_pallas)
//   expand_planes_sym_kernel  <- _sym_expand_kernel  (launcher expand_planes_sym_pallas)
// Both share one plane grammar, point_planes() below, as the two Pallas
// kernels share _planes_from_packed, so the two cannot drift. The functions
// are exactly deepgo_tpu/ops/expand.py::expand_planes and its plain PyTorch
// port, deepgo_tpu_torch/ops/expand.py (expand_planes, expand_planes_sym),
// for any uint8 record and any int32 player / rank:
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
// Bounds on an H100 (3.35 TB/s). Per board the input is 3,249 + 8 bytes and
// each output view is 13,357 planes (26,714 bytes in bf16, 53,428 in f32).
// Plain, B = 512 bf16: 15.3 MB, about 4.6 us. Sym, B = 512, S = 8: the
// board is read once for all views and 8 views are written, 111 MB in bf16
// (about 33 us) and 220 MB in f32 (about 66 us). The work is a few integer
// compares per output, so bytes bound both; at the serving shapes the
// launch itself dominates the plain kernel.
//
// Design of the plain kernel: one block per board, one thread per point
// (384 threads, 361 active). A thread reads its point's 9 channel bytes
// (coalesced across the threads of a channel), compares them once, and
// writes its 37 planes into a shared-memory byte tile laid out as the
// board's NHWC output. The block then stores the whole tile as one
// contiguous run of 13,357 elements, writing 1.0 / 0.0 as bit patterns
// (0x3F80 / 0x0000 for bf16), so no float arithmetic and no transpose pass
// follow. Player and rank are read once per block.
//
// Design of the sym kernel: one block per board as well. It stages the
// board's 9 x 361 bytes into shared memory with coalesced loads, so device
// memory is read once for all S views and not S times, and stages the first
// S rows of the (8, 361) permutation table beside it. The table is read
// through __ldg and kept in shared memory, not in __constant__ memory: the
// 32 threads of a warp read 32 different entries, which constant memory
// would serialise. Then, for each view k, thread p expands the point
// perm[k][p] of the staged board into the byte tile, and the block stores
// the tile contiguously at output row k * B + b (symmetry-major, as the
// Pallas kernel and the XLA gather lay it out), with the same stores as
// the plain kernel. Output offsets are 64-bit: at B = 512, S = 8 the output
// holds 54.7M elements.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPoints = 361;
constexpr int kChannels = 9;
constexpr int kBoardBytes = kChannels * kPoints;
constexpr int kPlanes = 37;
constexpr int kTile = kPoints * kPlanes;  // outputs per board
constexpr int kThreads = 384;             // 12 warps cover the 361 points
constexpr int kMaxSymmetries = 8;

// The 37 planes of one point into t[0..36]. ch0 points at the point's byte
// in channel 0; channel c lies at ch0[c * kPoints], in device memory for the
// plain kernel and in the staged shared-memory board for the sym kernel.
__device__ __forceinline__ void point_planes(const uint8_t* ch0, int me,
                                             int rk, uint8_t* t) {
  const bool black = me == 1;
  const int stones = ch0[0 * kPoints];
  const int libs = ch0[1 * kPoints];
  const int lib_after = ch0[(black ? 2 : 3) * kPoints];
  const int kills = ch0[(black ? 4 : 5) * kPoints];
  const int age = ch0[6 * kPoints];
  const int ladder = ch0[(black ? 7 : 8) * kPoints];
  const bool empty = stones == 0;

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

// The block's byte tile -> one board's contiguous NHWC output.
template <typename T, T kOne>
__device__ __forceinline__ void store_tile(const uint8_t* tile, T* dst) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    dst[i] = tile[i] ? kOne : T(0);
  }
}

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
    point_planes(packed + b * kBoardBytes + p, me, rk, tile + p * kPlanes);
  }
  __syncthreads();
  store_tile<T, kOne>(tile, out + b * kTile);
}

template <typename T, T kOne>
__global__ void __launch_bounds__(kThreads)
expand_planes_sym_kernel(const uint8_t* __restrict__ packed,
                         const int32_t* __restrict__ player,
                         const int32_t* __restrict__ rank,
                         const int32_t* __restrict__ perm,
                         T* __restrict__ out, int batch, int symmetries) {
  __shared__ uint8_t board[kBoardBytes];
  __shared__ int16_t view_perm[kMaxSymmetries * kPoints];
  __shared__ uint8_t tile[kTile];
  const int64_t b = blockIdx.x;
  const int p = threadIdx.x;
  const int me = player[b];
  const int rk = rank[b];

  const uint8_t* src = packed + b * kBoardBytes;
  for (int i = p; i < kBoardBytes; i += kThreads) board[i] = src[i];
  for (int i = p; i < symmetries * kPoints; i += kThreads) {
    view_perm[i] = static_cast<int16_t>(__ldg(perm + i));
  }
  __syncthreads();

  for (int k = 0; k < symmetries; ++k) {
    if (p < kPoints) {
      point_planes(board + view_perm[k * kPoints + p], me, rk,
                   tile + p * kPlanes);
    }
    __syncthreads();
    store_tile<T, kOne>(tile, out + (static_cast<int64_t>(k) * batch + b) *
                                        kTile);
    __syncthreads();  // the next view overwrites the tile
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

// Launches the fused gather + expansion of `symmetries` dihedral views of
// `batch` boards on `stream`.
//   packed, player, rank: as for deepgo_expand_planes
//   perm: (>= symmetries, 361) int32 gather table, entries in [0, 361):
//         view k of a board is flat[:, perm[k, p]] at point p
//   out: (symmetries * batch, 19, 19, 37), contiguous, view k of board b at
//        row k * batch + b; bf16 (out_bytes == 2) or float32 (out_bytes == 4)
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int deepgo_expand_planes_sym(const void* packed, const void* player,
                                        const void* rank, const void* perm,
                                        void* out, int batch, int symmetries,
                                        int out_bytes, void* stream) {
  if (batch < 1 || symmetries < 1 || symmetries > kMaxSymmetries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* in = static_cast<const uint8_t*>(packed);
  const auto* pl = static_cast<const int32_t*>(player);
  const auto* rk = static_cast<const int32_t*>(rank);
  const auto* pm = static_cast<const int32_t*>(perm);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_bytes == 2) {
    expand_planes_sym_kernel<uint16_t, uint16_t{0x3F80}>
        <<<batch, kThreads, 0, s>>>(in, pl, rk, pm,
                                    static_cast<uint16_t*>(out), batch,
                                    symmetries);
  } else if (out_bytes == 4) {
    expand_planes_sym_kernel<uint32_t, 0x3F800000u>
        <<<batch, kThreads, 0, s>>>(in, pl, rk, pm,
                                    static_cast<uint32_t*>(out), batch,
                                    symmetries);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
