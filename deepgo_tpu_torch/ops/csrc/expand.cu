// Packed record -> 37 binary model planes, on Hopper (sm_90a): the plain
// expansion and the expansion fused with the dihedral-view gather, one
// kernel body for both.
//
// Replaces the TPU kernels in deepgo_tpu/ops/pallas_expand.py:
//   deepgo_expand_planes      <- _expand_kernel      (launcher expand_planes_pallas)
//   deepgo_expand_planes_sym  <- _sym_expand_kernel  (launcher expand_planes_sym_pallas)
// Both entry points run expand_planes_kernel; the plain expansion is its
// one-view case without the gather (kGather = false). The plane grammar,
// point_planes() below, is the single definition of the planes, as the two
// Pallas kernels share _planes_from_packed. The functions are exactly
// deepgo_tpu/ops/expand.py::expand_planes and its plain PyTorch port,
// deepgo_tpu_torch/ops/expand.py (expand_planes, expand_planes_sym), for
// any uint8 record and any int32 player / rank:
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
// compares per output and no products, so bytes bound both and tensor
// cores have nothing to do here.
//
// Design. The output is S * B * 361 points of 37 planes, laid out flat:
// point q = (k * B + b) * 361 + p is point p of view k of board b (row
// k * B + b, symmetry-major, as the Pallas kernel and the XLA gather lay it
// out); its source point is perm[k][p], or p without the gather. Each warp
// owns a chunk of 32 consecutive points, and the grid has a warp for every
// chunk, so all SMs work at any B and S (one block per board left most SMs
// idle at B <= 37 and ran the S views of a board in series). A warp:
//
// 1. Computes the 37 planes of its lane's point once, as one 64-bit mask,
//    from the point's 9 channel bytes. The 9 loads and the player and rank
//    loads go out together, the player choosing among the bytes only
//    afterwards. Boards are read byte-wise, from L2 after the first view: the
//    input may be a slice at an odd address. The permutation entry comes
//    through __ldg, not __constant__ memory: the lanes read 32 different
//    entries.
// 2. Lays the 32 masks end to end as 37 words of 32 bits, by warp shuffles:
//    no shared memory and no barrier, so every warp runs on its own.
// 3. Stores the chunk, which is contiguous in the output, as 16-byte vectors
//    (8 bf16 or 4 f32 planes, each taken from one word at a fixed offset),
//    writing 1.0 as its bit pattern with one st.global.cs.v4 per vector: 512
//    bytes per warp instruction, marked evict-first so that the lines
//    stream out of L2 (at B = 512, S = 8 the output is twice L2's 50 MB,
//    and the default write-back store took 11-13 % longer). 8 points x 37
//    planes x 2 bytes = 592 bytes = 37 x 16 bytes, and 4 points make the
//    same in f32, so a chunk of 32 points starts on a 16-byte boundary (the
//    output comes from torch.empty) and holds whole vectors. Only the last
//    vector of the output, when S * B * 361 is not a multiple of 8 (bf16)
//    or 4 (f32), is written element by element.
//
// Point indices and every offset are 64-bit: a caller may pass tens of
// thousands of boards (B = 512, S = 8 alone is 54.7M planes), and a grid too
// large to launch walks its chunks with a grid stride.
//
// Timed against the alternatives on an NVIDIA H100 80GB HBM3 at 700 W, in
// turns within one run, each slower at the top shapes (PERF.md holds the
// times): a persistent grid whose warps stage each chunk in a
// double-buffered shared tile and drain it with a TMA bulk copy
// (cp.async.bulk, L2 evict-first hint; 7-11 % slower at S = 8, bf16), a
// persistent grid of direct stores that issues the next chunk's loads
// first, and the default write-back store. The one-block-per-board kernels
// this replaces took 70.14 us (sym, B = 512, S = 8, bf16), 18.5-19.1 us
// (sym, B = 1, 8, 37, S = 8) and 13.50 us (plain, B = 512, bf16).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPoints = 361;
constexpr int kChannels = 9;
constexpr int kBoardBytes = kChannels * kPoints;
constexpr int kPlanes = 37;
constexpr int kMaxSymmetries = 8;
constexpr int kWarp = 32;  // points per chunk: a warp, one point a lane
constexpr int kThreads = 128;
constexpr int64_t kMaxBlocks = int64_t{1} << 24;
constexpr int kVectorBytes = 16;

static_assert(kWarp % 8 == 0, "chunks start on 592-byte groups");
static_assert(kWarp * kPlanes / 32 <= 2 * kWarp, "a lane holds two words");

// Plane `first + i - 1` for v == i in 1..n - 1, plane `first + n - 1` for
// v >= n, none for v < 1.
__device__ __forceinline__ uint64_t count_planes(int first, int v, int n) {
  return v >= 1 ? uint64_t{1} << (first + min(v, n) - 1) : 0;
}

// Plane `first + i - 1` for v == i in 1..n, none for v outside 1..n.
__device__ __forceinline__ uint64_t value_planes(int first, int v, int n) {
  return v >= 1 && v <= n ? uint64_t{1} << (first + v - 1) : 0;
}

// One point's inputs: its 9 channel bytes, the player to move and the rank.
struct PointInputs {
  int c[kChannels];
  int me;
  int rk;
  bool valid;  // false past the end of the output
};

// The inputs of flat point q (row k * batch + b, point p), all 11 loads
// issued together.
template <bool kGather>
__device__ __forceinline__ PointInputs load_point(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ player,
    const int32_t* __restrict__ rank, const int32_t* __restrict__ perm,
    int64_t q, int64_t points, int batch) {
  PointInputs in{};
  in.valid = q < points;
  if (in.valid) {
    int64_t b = q / kPoints;
    const int p = static_cast<int>(q - b * kPoints);
    int k = 0;
    while (b >= batch) {  // row k * batch + b; k < symmetries <= 8
      b -= batch;
      ++k;
    }
    const int src = kGather ? __ldg(perm + k * kPoints + p) : p;
    const uint8_t* ch0 = packed + b * kBoardBytes + src;
#pragma unroll
    for (int i = 0; i < kChannels; ++i) in.c[i] = ch0[i * kPoints];
    in.me = player[b];
    in.rk = rank[b];
  }
  return in;
}

// The 37 planes of one point as bits 0..36.
__device__ __forceinline__ uint64_t point_planes(const PointInputs& in) {
  const int me = in.me;
  const bool black = me == 1;
  const int stones = in.c[0];
  const int libs = in.c[1];
  const int lib_after = black ? in.c[2] : in.c[3];
  const int kills = black ? in.c[4] : in.c[5];
  const int age = in.c[6];
  const int ladder = black ? in.c[7] : in.c[8];
  const bool empty = stones == 0;
  return uint64_t{empty}                               // plane 0
         | uint64_t{stones == me} << 1                 // mine
         | uint64_t{stones == 3 - me} << 2             // theirs
         | count_planes(3, libs, 4)                    // planes 3-6
         | uint64_t{empty && lib_after == 0} << 7      // plane 7
         | count_planes(8, lib_after, 6)               // planes 8-13
         | count_planes(14, kills, 7)                  // planes 14-20
         | value_planes(21, age, 5)                    // planes 21-25
         | uint64_t{ladder >= 1} << 26                 // plane 26; 27 is 0
         | value_planes(28, in.rk, 9);                 // planes 28-36
}

// 1.0 as the bit pattern of T: bf16 (uint16_t) or float32 (uint32_t).
template <typename T>
constexpr T kOne = sizeof(T) == 2 ? T(0x3F80) : T(0x3F800000u);

// 16 bytes of planes, element i = 1.0 if bit i of `bits` (16 / sizeof(T)
// bits, nothing above them) is set, else 0.0.
template <typename T>
__device__ __forceinline__ uint4 planes_vector(uint32_t bits) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 2) {
      // bits 2j and 2j + 1 to bits 0 and 16, then each to 0x3F80
      w[j] = ((bits >> (2 * j)) * 0x8001u & 0x10001u) * kOne<T>;
    } else {
      w[j] = (bits >> j & 1u) * kOne<T>;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, bool kGather>
__global__ void __launch_bounds__(kThreads)
expand_planes_kernel(const uint8_t* __restrict__ packed,
                     const int32_t* __restrict__ player,
                     const int32_t* __restrict__ rank,
                     const int32_t* __restrict__ perm,
                     T* __restrict__ out, int batch, int symmetries) {
  constexpr int kVec = kVectorBytes / sizeof(T);    // planes per vector
  constexpr int kVecs = kWarp * kPlanes / kVec;      // vectors per chunk
  constexpr int kPerWord = 32 / kVec;                // vectors per word
  const int lane = threadIdx.x % kWarp;
  const int64_t points = int64_t{symmetries} * batch * kPoints;
  const int64_t stride = int64_t{gridDim.x} * kThreads;
  for (int64_t q0 = int64_t{blockIdx.x} * kThreads + threadIdx.x - lane;
       q0 < points; q0 += stride) {
    // The mask of point q0 + lane (0 past the end).
    const PointInputs in = load_point<kGather>(packed, player, rank, perm,
                                               q0 + lane, points, batch);
    const uint64_t m = in.valid ? point_planes(in) : 0;

    // The chunk's 32 x 37 plane bits, end to end, as 37 words of 32 bits:
    // lane l holds word l in w0 and, for l < 5, word 32 + l in w1. Word w
    // starts at bit w * 32 % 37 of point w * 32 / 37's mask and may run into
    // the next point's (a lane index past 31 wraps, and then reads bits the
    // word does not keep).
    auto word = [m](int w) {
      const int pt = w * 32 / kPlanes;
      const int bit = w * 32 - pt * kPlanes;
      const uint64_t lo = __shfl_sync(~0u, m, pt);
      const uint64_t hi = __shfl_sync(~0u, m, pt + 1);
      return static_cast<uint32_t>(lo >> bit | hi << (kPlanes - bit));
    };
    const uint32_t w0 = word(lane);
    const uint32_t w1 = word(kWarp + lane);

    // The chunk's planes, contiguous from out + q0 * 37, as 16-byte
    // vectors; vector v is planes v * kVec .. v * kVec + kVec - 1, the bits
    // of word v / kPerWord from bit v % kPerWord * kVec.
    const int n = static_cast<int>(points - q0 < kWarp ? points - q0 : kWarp) *
                  kPlanes;
    T* dst = out + q0 * kPlanes;
#pragma unroll
    for (int i = 0; i * kWarp < kVecs; ++i) {
      const int v = i * kWarp + lane;
      // whether v's word is in w1 is the same for every lane at a given i
      const uint32_t word_v = __shfl_sync(
          ~0u, i * kWarp / kPerWord >= kWarp ? w1 : w0, v / kPerWord);
      const uint32_t bits =
          word_v >> (v % kPerWord * kVec) & ((1u << kVec) - 1);
      const int e = v * kVec;
      if (e + kVec <= n) {
        __stcs(reinterpret_cast<uint4*>(dst + e), planes_vector<T>(bits));
      } else {  // the output's ragged end
        for (int j = 0; e + j < n; ++j) {
          dst[e + j] = (bits >> j) & 1 ? kOne<T> : T(0);
        }
      }
    }
  }
}

template <typename T, bool kGather>
int launch(const void* packed, const void* player, const void* rank,
           const void* perm, void* out, int batch, int symmetries,
           void* stream) {
  const int64_t chunks =
      (int64_t{symmetries} * batch * kPoints + kWarp - 1) / kWarp;
  const int64_t blocks = (chunks + kThreads / kWarp - 1) / (kThreads / kWarp);
  const int grid = static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  expand_planes_kernel<T, kGather>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(packed),
          static_cast<const int32_t*>(player),
          static_cast<const int32_t*>(rank),
          static_cast<const int32_t*>(perm), static_cast<T*>(out), batch,
          symmetries);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the expansion of `batch` boards on `stream`.
//   packed: (batch, 9, 19, 19) uint8, contiguous, at any address
//   player, rank: (batch,) int32
//   out: (batch, 19, 19, 37), contiguous and 16-byte aligned, bf16
//        (out_bytes == 2) or float32 (out_bytes == 4)
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int deepgo_expand_planes(const void* packed, const void* player,
                                    const void* rank, void* out, int batch,
                                    int out_bytes, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (out_bytes == 2) {
    return launch<uint16_t, false>(packed, player, rank, nullptr, out, batch,
                                   1, stream);
  }
  if (out_bytes == 4) {
    return launch<uint32_t, false>(packed, player, rank, nullptr, out, batch,
                                   1, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the fused gather + expansion of `symmetries` dihedral views of
// `batch` boards on `stream`.
//   packed, player, rank: as for deepgo_expand_planes
//   perm: (>= symmetries, 361) int32 gather table, entries in [0, 361):
//         view k of a board is flat[:, perm[k, p]] at point p
//   out: (symmetries * batch, 19, 19, 37), contiguous and 16-byte aligned,
//        view k of board b at row k * batch + b; bf16 (out_bytes == 2) or
//        float32 (out_bytes == 4)
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int deepgo_expand_planes_sym(const void* packed, const void* player,
                                        const void* rank, const void* perm,
                                        void* out, int batch, int symmetries,
                                        int out_bytes, void* stream) {
  if (batch < 1 || symmetries < 1 || symmetries > kMaxSymmetries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (out_bytes == 2) {
    return launch<uint16_t, true>(packed, player, rank, perm, out, batch,
                                  symmetries, stream);
  }
  if (out_bytes == 4) {
    return launch<uint32_t, true>(packed, player, rank, perm, out, batch,
                                  symmetries, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
