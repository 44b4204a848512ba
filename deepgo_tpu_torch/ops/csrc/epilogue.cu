// The convolution epilogue of PositionBiasConv on Hopper (sm_90a): a bias
// per channel and board point, then ReLU, forward and backward.
//
// Replaces no Pallas kernel. In the JAX package XLA fuses this epilogue
// into the convolution's consumers; PyTorch runs it as four passes over the
// activation: the broadcast add (x + bias.to(x.dtype)[None]) and ReLU
// forward, and ReLU's backward (threshold_backward) and the bias gradient
// (a reduction of dX over the batch) backward. The reduction read its input
// at about 5 % of the card's bandwidth (B = 1,024, C = 256).
//
//   deepgo_bias_relu_forward   y = relu(x + bias) (relu = 0: x + bias)
//   deepgo_bias_relu_backward  dX = dY * [y > 0] and one float32 partial
//                              sum of dX over each slab of batch rows
//   deepgo_bias_grad_finish    the partials summed over the slabs, in slab
//                              order, rounded to the compute type, widened
//
// The functions are those of deepgo_tpu_torch/ops/epilogue.py::bias_relu
// and autograd's backward of it, bit for bit in the forward and in dX:
// the bias is rounded to x's type first, added in float32, the sum rounded
// once (round to nearest even, as __float2bfloat16 in PyTorch's kernels),
// then ReLU as PyTorch's clamp_min (a NaN passes, else fmaxf(v, 0)); dX is
// threshold_backward's `y <= 0 ? 0 : dY`. The bias gradient is the same
// float32 sum of the bf16 (or float32) dX over the batch, rounded to the
// compute type and widened to float32 as autograd of .to(x.dtype) does; only
// the order of the sum differs. No float atomics: the order is fixed by the
// shapes, so the gradient is bitwise the same from run to run.
//
// Bounds on an H100 (3.35 TB/s). The activation x, y, dY and dX are
// (B, C, 19, 19) channels-last: per batch row a contiguous plane of 361 * C
// values, point p's C channels side by side. Forward: read x, write y,
// 2 * B * 361 * C * bytes (B = 1,024, C = 256, bf16: 378 MB, 113 us).
// Backward: read dY and y, write dX, 3 * B * 361 * C * bytes (568 MB, 170
// us), plus the partials: slabs * 361 * C float32 written and read again
// (12 slabs at that shape: 8.9 MB). A few operations per byte: bytes bound
// both, and tensor cores have nothing to do.
//
// Design. The plane of 361 * C values is cut into tiles of kThreads
// vectors; a thread owns one 16-byte vector of a tile (8 bf16 or 4 float32
// channels of one point; one value where C is not a multiple of that, as
// for the 1-channel head) and walks the rows of one slab of the batch, so
// neighbouring threads touch neighbouring addresses in every row. The grid
// is tiles x slabs. A slab's rows are what the reduction needs: a thread
// sums its vector over its slab's rows in float32 registers and writes one
// partial per slab, so the sum over the batch takes no atomics and no
// second read of dX; the small finishing pass adds the slabs. The caller
// (ops/cuda_epilogue.plan) picks the slabs from the shapes so that the grid
// holds about four blocks per SM at any B and C, with at least a few rows
// each: B = 1,024, C = 256 gives 46 tiles x 12 slabs of 86 rows. The
// forward takes the same partition; its block stages the tile's bias once
// in shared memory, read from the (C, 361) float32 parameter in point-major
// runs (the transposed read is coalesced over the points of a tile) and
// rounded to x's type, and then adds it to every row of the slab. Rows go
// kUnroll at a time, their loads issued together. Offsets are 64-bit.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPoints = 361;
constexpr int kThreads = 256;  // ops/cuda_epilogue.THREADS
constexpr int kUnroll = 4;
constexpr int kVectorBytes = 16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V values of one point's neighbouring channels, loaded and stored as one
// 16-byte access when V * sizeof(T) == 16.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The tile [f0, f0 + len) of a plane, walked in the bias's (channel, point)
// order: walk index i is channel i / points, point p0 + i % points.
struct TileWalk {
  int64_t f0;
  int len;
  int channels;
  int p0;
  int points;

  __device__ TileWalk(int64_t first, int length, int c)
      : f0(first), len(length), channels(c) {
    p0 = static_cast<int>(first / c);
    points = static_cast<int>((first + length - 1) / c) - p0 + 1;
  }
  __device__ int count() const { return channels * points; }
  // the plane offset of walk index i, or -1 outside the tile; *at is the
  // bias's offset c * 361 + p
  __device__ int64_t flat(int i, int* at) const {
    const int c = i / points;
    const int p = p0 + i % points;
    *at = c * kPoints + p;
    const int64_t f = int64_t{p} * channels + c;
    return f >= f0 && f < f0 + len ? f : -1;
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bias_relu_forward_kernel(const T* __restrict__ x,
                             const float* __restrict__ bias,
                             T* __restrict__ y, int batch, int channels,
                             int rows, bool relu) {
  __shared__ float tile_bias[kThreads * V];
  const int64_t plane = int64_t{kPoints} * channels;
  const int64_t f0 = int64_t{blockIdx.x} * kThreads * V;
  const int len = static_cast<int>(
      plane - f0 < kThreads * V ? plane - f0 : kThreads * V);
  const TileWalk walk(f0, len, channels);
  for (int i = threadIdx.x; i < walk.count(); i += kThreads) {
    int at;
    const int64_t f = walk.flat(i, &at);
    if (f >= 0) tile_bias[f - f0] = widen(narrow<T>(bias[at]));
  }
  __syncthreads();
  const int local = threadIdx.x * V;
  if (local >= len) return;
  float b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) b[j] = tile_bias[local + j];

  using P = Pack<T, V>;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(batch, r0 + rows);
  const P* in = reinterpret_cast<const P*>(x + r0 * plane + f0 + local);
  P* out = reinterpret_cast<P*>(y + r0 * plane + f0 + local);
  const int64_t stride = plane / V;  // in packs
  auto apply = [&](const P& v) {
    P o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T s = narrow<T>(widen(v.v[j]) + b[j]);
      const float sf = widen(s);
      o.v[j] = relu && !isnan(sf) ? narrow<T>(fmaxf(sf, 0.0f)) : s;
    }
    return o;
  };
  int r = r0;
  for (; r + kUnroll <= r1; r += kUnroll) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = in[u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) out[u * stride] = apply(v[u]);
    in += kUnroll * stride;
    out += kUnroll * stride;
  }
  for (; r < r1; ++r) {
    *out = apply(*in);
    in += stride;
    out += stride;
  }
}

// kMask: ReLU's backward (y given, dX written); without it dX is dY and
// only the partial sums are written.
template <typename T, int V, bool kMask>
__global__ void __launch_bounds__(kThreads)
    bias_relu_backward_kernel(const T* __restrict__ dy,
                              const T* __restrict__ y, T* __restrict__ dx,
                              float* __restrict__ partial, int batch,
                              int channels, int rows) {
  const int64_t plane = int64_t{kPoints} * channels;
  const int64_t f = (int64_t{blockIdx.x} * kThreads + threadIdx.x) * V;
  if (f >= plane) return;

  using P = Pack<T, V>;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(batch, r0 + rows);
  const int64_t start = r0 * plane + f;
  const P* g = reinterpret_cast<const P*>(dy + start);
  const P* m = reinterpret_cast<const P*>(y + start);
  P* out = reinterpret_cast<P*>(dx + start);
  const int64_t stride = plane / V;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  auto apply = [&](const P& gv, const P& mv) {
    P o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o.v[j] = kMask && widen(mv.v[j]) <= 0.0f ? narrow<T>(0.0f) : gv.v[j];
      acc[j] += widen(o.v[j]);
    }
    return o;
  };
  int r = r0;
  for (; r + kUnroll <= r1; r += kUnroll) {
    P gv[kUnroll], mv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      gv[u] = g[u * stride];
      if (kMask) mv[u] = m[u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const P o = apply(gv[u], mv[u]);
      if (kMask) out[u * stride] = o;
    }
    g += kUnroll * stride;
    m += kUnroll * stride;
    out += kUnroll * stride;
  }
  for (; r < r1; ++r) {
    const P o = apply(*g, kMask ? *m : *g);
    if (kMask) *out = o;
    g += stride;
    m += stride;
    out += stride;
  }
  using F = Pack<float, V>;
  F sums;
#pragma unroll
  for (int j = 0; j < V; ++j) sums.v[j] = acc[j];
  *reinterpret_cast<F*>(partial + blockIdx.y * plane + f) = sums;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bias_grad_finish_kernel(const float* __restrict__ partial,
                            float* __restrict__ grad, int slabs,
                            int channels) {
  const int64_t plane = int64_t{kPoints} * channels;
  const int64_t f = int64_t{blockIdx.x} * kThreads + threadIdx.x;
  if (f >= plane) return;
  float s = 0.0f;
  for (int k = 0; k < slabs; ++k) s += partial[k * plane + f];
  const int p = static_cast<int>(f / channels);
  const int c = static_cast<int>(f % channels);
  grad[c * kPoints + p] = widen(narrow<T>(s));
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVectorBytes == 0;
}

int blocks(int64_t n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

template <typename T, int V>
int forward(const void* x, const void* bias, void* y, int batch,
            int channels, int rows, int slabs, int relu,
            cudaStream_t stream) {
  const dim3 grid(blocks(int64_t{kPoints} * channels / V), slabs);
  bias_relu_forward_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(bias),
      static_cast<T*>(y), batch, channels, rows, relu != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int backward(const void* dy, const void* y, void* dx, void* partial,
             int batch, int channels, int rows, int slabs,
             cudaStream_t stream) {
  const dim3 grid(blocks(int64_t{kPoints} * channels / V), slabs);
  if (y != nullptr) {
    bias_relu_backward_kernel<T, V, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(y),
        static_cast<T*>(dx), static_cast<float*>(partial), batch, channels,
        rows);
  } else {
    bias_relu_backward_kernel<T, V, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(dy),
        static_cast<T*>(nullptr), static_cast<float*>(partial), batch,
        channels, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The partition's arguments, as ops/cuda_epilogue.plan gives them: vector
// is 1, or 16 / elem_bytes with C a multiple of it and every tensor 16-byte
// aligned; slabs * rows covers the batch.
bool valid(int batch, int channels, int elem_bytes, int vector, int rows,
           int slabs) {
  if (batch < 1 || channels < 1 || rows < 1 || slabs < 1) return false;
  if (int64_t{rows} * (slabs - 1) >= batch || int64_t{rows} * slabs < batch)
    return false;
  if (slabs > 65535) return false;
  if (elem_bytes != 2 && elem_bytes != 4) return false;
  return vector == 1 ||
         (vector == kVectorBytes / elem_bytes && channels % vector == 0);
}

}  // namespace

// Launches y = relu(x + bias) (relu == 0: x + bias) on `stream`.
//   x, y: (batch, channels, 19, 19) channels-last, bf16 (elem_bytes == 2)
//         or float32 (elem_bytes == 4); 16-byte aligned when vector > 1
//   bias: (channels, 19, 19) float32, contiguous
//   vector, rows, slabs: the partition (ops/cuda_epilogue.plan)
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int deepgo_bias_relu_forward(const void* x, const void* bias,
                                        void* y, int batch, int channels,
                                        int elem_bytes, int vector, int rows,
                                        int slabs, int relu, void* stream) {
  if (!valid(batch, channels, elem_bytes, vector, rows, slabs) ||
      (vector > 1 && !(aligned(x) && aligned(y)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return vector == 1
               ? forward<__nv_bfloat16, 1>(x, bias, y, batch, channels, rows,
                                           slabs, relu, s)
               : forward<__nv_bfloat16, 8>(x, bias, y, batch, channels, rows,
                                           slabs, relu, s);
  }
  return vector == 1 ? forward<float, 1>(x, bias, y, batch, channels, rows,
                                         slabs, relu, s)
                     : forward<float, 4>(x, bias, y, batch, channels, rows,
                                         slabs, relu, s);
}

// Launches the backward on `stream`: dX = (y <= 0 ? 0 : dY) and the
// bias gradient, in two kernels.
//   dy, dx: as x above; y: the forward's output, or null for the epilogue
//           without ReLU (dX is then dY and dx is not written; may be null)
//   partial: (slabs, 361 * channels) float32 scratch, 16-byte aligned
//   grad: (channels, 19, 19) float32, written whole
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int deepgo_bias_relu_backward(const void* dy, const void* y,
                                         void* dx, void* partial, void* grad,
                                         int batch, int channels,
                                         int elem_bytes, int vector, int rows,
                                         int slabs, void* stream) {
  if (!valid(batch, channels, elem_bytes, vector, rows, slabs) ||
      !aligned(partial) || (y != nullptr && dx == nullptr) ||
      (vector > 1 && !(aligned(dy) && (y == nullptr ||
                                       (aligned(y) && aligned(dx)))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (elem_bytes == 2) {
    err = vector == 1
              ? backward<__nv_bfloat16, 1>(dy, y, dx, partial, batch,
                                           channels, rows, slabs, s)
              : backward<__nv_bfloat16, 8>(dy, y, dx, partial, batch,
                                           channels, rows, slabs, s);
  } else {
    err = vector == 1 ? backward<float, 1>(dy, y, dx, partial, batch,
                                           channels, rows, slabs, s)
                      : backward<float, 4>(dy, y, dx, partial, batch,
                                           channels, rows, slabs, s);
  }
  if (err != 0) return err;
  const int grid = blocks(int64_t{kPoints} * channels);
  if (elem_bytes == 2) {
    bias_grad_finish_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(grad), slabs,
        channels);
  } else {
    bias_grad_finish_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(grad), slabs,
        channels);
  }
  return static_cast<int>(cudaGetLastError());
}
