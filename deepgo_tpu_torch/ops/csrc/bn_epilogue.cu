// The residual network's batch-normalisation epilogue on Hopper (sm_90a):
// batch normalisation (train or eval mode), the block's input added where
// there is one, then ReLU, forward and backward.
//
// Replaces no Pallas kernel. In the JAX package XLA fuses BN, the skip add
// and ReLU into the convolutions' consumers. PyTorch runs them as separate
// passes over the activation: per residual block, BN's statistics and
// transform twice, the add and two ReLUs forward (13 passes); two
// threshold_backwards and BN's reduce and element passes twice backward
// (16, and autograd's sum of the skip's gradient, 3). At AlphaGo Zero's
// widths (B = 512, C = 256) an activation is 94.6 MB, and BN's statistics
// pass read it at about 21 % of the card's bandwidth.
//
//   deepgo_bn_relu_forward   train: bn_stats_kernel (one float32 Welford
//                            partial of each channel's count, mean and M2
//                            per block), bn_stats_finish_kernel (the
//                            partials merged in order into the mean and
//                            invstd, the running statistics updated),
//                            bn_apply_kernel (y); eval: bn_apply_kernel
//                            alone, on the running statistics
//   deepgo_bn_relu_backward  bn_backward_reduce_kernel (dY masked by ReLU,
//                            float32 partial sums of dy and dy * (x - mean)
//                            per block; with a skip it writes the masked dY,
//                            the skip's gradient), bn_backward_finish_kernel
//                            (the partials summed in order; BN's scale and
//                            shift gradients), bn_backward_apply_kernel (dX)
//
// The functions are those of deepgo_tpu_torch/ops/bn_epilogue.py::bn_relu
// (F.batch_norm, + skip, F.relu) and autograd's backward of it, with its
// rounding points and operation order:
//   1. BN's result in float32 as PyTorch's channels-last transform
//      computes it, w * (x - mean) * invstd + shift with the last product
//      and the sum fused, rounded to the compute type;
//   2. widened, the skip added in float32 and the sum rounded once (round
//      to nearest even, as __float2bfloat16 in PyTorch's kernels);
//   3. ReLU as PyTorch's clamp_min: a NaN passes, else fmaxf(v, 0).
//   The running statistics as PyTorch updates them: the biased variance
//   M2 / N gives invstd = rsqrtf(var + eps), the unbiased one (times
//   N / (N - 1)) and the mean move the running ones by momentum. The
//   backward is threshold_backward's `y <= 0 ? 0 : dY` and BN's element
//   formula (dy - sum_dy / N - (x - mean) * invstd^2 * sum_dy_xmu / N) *
//   w * invstd in float32, rounded once; the scale's gradient sum_dy_xmu *
//   invstd, the shift's sum_dy. The only departure is the order in which
//   the statistics and the two sums are summed. No float atomics: the
//   order is fixed by the shapes, so every result is bitwise the same from
//   run to run. Without a skip the backward does not read y: it recomputes
//   the ReLU mask from x and the saved statistics with the forward's own
//   instructions (bn_value), so the mask is bitwise the forward's.
//
// Bound: bytes. An operation or a few per byte, and tensor cores have
// nothing to do. Passes over a (B, C, 19, 19) activation a residual block,
// at B = 512, C = 256, bf16 (94.6 MB, 28.2 us at 3.35 TB/s each):
//   forward  first BN: statistics 1 + apply 2 (read x, write y);
//            second BN: statistics 1 + apply 3 (read x and the skip,
//            write y); 7 in all, where 5 is the least (x, and the skip,
//            read once, y written once).
//   backward first BN: reduce 2 (dY, x) + apply 3 (dY, x, write dX);
//            second BN: reduce 3 (dY, y, x) + the masked dY written 1 +
//            apply 3 (masked dY, x, write dX); autograd's add of the
//            skip's gradient 3; 15 in all, where 9 is the least.
// The float32 partials add (tiles x slabs) x C x 8 bytes (1.1 MB at that
// shape) written and read again each way, and the finishing steps a few
// microseconds each.
//
// Design. The activation is channels-last: per batch row a contiguous plane
// of 361 * C values, point p's C channels side by side. A thread owns one
// 16-byte vector of neighbouring channels (8 bf16 or 4 float32; one value
// where C is not a multiple of that, as for the heads' C = 2 and 1) of one
// point, and walks the rows of one slab of the batch: neighbouring threads
// touch neighbouring addresses in every row. A block covers `points` whole
// points (kThreads / (C / V): 8 at C = 256 bf16), so the threads of one
// channel in a block are a fixed set; the grid is tiles of points x slabs
// of rows (ops/cuda_bn_epilogue.plan). A reducing pass takes one wave of
// the blocks the card holds at once, by its own registers, so no block
// waits for a second wave (at B = 512, C = 256: 46 tiles x 8 slabs of 64
// rows at three blocks a SM); its slabs interleave (slab s holds rows s,
// s + S, ...), so they walk the batch side by side and the pass ends on
// its last rows. An elementwise pass takes slabs of 16 rows, many short
// blocks whose last wave is small, from the batch's last rows back: its
// first reads may find in L2 what the reducing pass read last. A reducing
// thread keeps its sums in registers over its rows (Welford's update for
// the statistics: no sum of squares, so no cancellation), the block merges
// its points in shared memory in a fixed tree (Chan's formula for the
// statistics), and writes one partial a channel; a finishing block merges a
// channel's partials in a fixed order, 8 or more lanes each over a strided
// share, then a tree over the lanes. Rows go kUnroll at a time, their loads
// issued together. Offsets are 64-bit.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPoints = 361;
constexpr int kThreads = 256;  // ops/cuda_bn_epilogue.THREADS
constexpr int kUnroll = 4;
constexpr int kVectorBytes = 16;
constexpr int kMaxVector = 8;  // a 16-byte vector of bf16
// channels a finishing block takes, at most; its other threads are lanes
// over the partials (32 a channel at C >= 8)
constexpr int kFinishChannels = 8;
// partials a finishing lane loads before it merges them
constexpr int kFinishUnroll = 4;

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

// This thread's place in the partition: vector `group` (channels
// [group * V, group * V + V)) of point `point`, the `local`-th of the
// block's `points`; `valid` of them lie on the board.
template <int V>
struct Tile {
  int points;
  int local;
  int group;
  int point;
  int valid;

  __device__ explicit Tile(int channels) {
    const int groups = channels / V;
    points = kThreads / groups;
    local = threadIdx.x / groups;
    group = threadIdx.x % groups;
    const int first = blockIdx.x * points;
    point = first + local;
    valid = min(points, kPoints - first);
  }
  __device__ bool active() const { return local < valid; }
  __device__ int64_t offset(int channels) const {
    return int64_t{point} * channels + group * V;
  }
};

// BN's result, as PyTorch's channels-last transform computes it: w * (x -
// mean) * invstd + shift, the last product and the sum fused. The same
// instructions in the forward and in the backward's mask.
__device__ __forceinline__ float bn_value(float x, float mean, float w,
                                          float invstd, float shift) {
  return __fmaf_rn(__fmul_rn(w, __fsub_rn(x, mean)), invstd, shift);
}

// ReLU as PyTorch's clamp_min: a NaN passes.
template <typename T>
__device__ __forceinline__ T relu(T s) {
  const float sf = widen(s);
  return isnan(sf) ? s : narrow<T>(fmaxf(sf, 0.0f));
}

// threshold_backward's mask: relu(s) <= 0 exactly where s <= 0.
template <typename T>
__device__ __forceinline__ bool passes(T s) {
  return !(widen(s) <= 0.0f);
}

// Chan's merge of (nb, mb, m2b) into (na, ma, m2a); nothing to merge when
// nb is 0.
__device__ __forceinline__ void chan(float& na, float& ma, float& m2a,
                                     float nb, float mb, float m2b) {
  if (nb == 0.0f) return;
  const float n = na + nb;
  const float d = mb - ma;
  const float f = nb / n;
  ma = fmaf(d, f, ma);
  m2a = m2a + m2b + d * d * (na * f);
  na = n;
}

// Points of a block's tree slot `slot` before the level of stride `s`: the
// slot then holds points slot, slot + 2s, slot + 4s, ... below `valid`.
__device__ __forceinline__ int slot_points(int slot, int s, int valid) {
  return slot < valid ? (valid - slot + 2 * s - 1) / (2 * s) : 0;
}

__device__ __forceinline__ int tree_span(int n) {
  int span = 1;
  while (span < n) span <<= 1;
  return span;
}

// The rows of a reducing pass's slab blockIdx.y: every gridDim.y-th row
// from it, so the slabs walk the batch side by side and the pass ends on
// the batch's last rows.
struct Rows {
  int first;
  int step;
  int count;

  __device__ explicit Rows(int batch)
      : first(blockIdx.y),
        step(gridDim.y),
        count((batch - static_cast<int>(blockIdx.y) + gridDim.y - 1) /
              gridDim.y) {}
};

// The first row of an elementwise pass's slab of `rows`: the slabs from
// the batch's last, where the reducing pass before ended, so their first
// reads may find it in L2.
__device__ __forceinline__ int apply_first_row(int rows) {
  return (gridDim.y - 1 - blockIdx.y) * rows;
}

// The statistics of one slab of rows at one tile of points: each thread
// Welford's update over its rows for its V channels, the block's points
// merged by Chan's formula in a fixed tree; one partial per channel.
// partial: mean (parts, C), M2 (parts, C), count (parts), part =
// blockIdx.y * gridDim.x + blockIdx.x.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    int batch, int channels) {
  __shared__ float s_mean[kThreads * kMaxVector];
  __shared__ float s_m2[kThreads * kMaxVector];
  const Tile<V> t(channels);
  const Rows rows(batch);
  float mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.0f;
  if (t.active()) {
    using P = Pack<T, V>;
    const int64_t plane = int64_t{kPoints} * channels;
    const P* in = reinterpret_cast<const P*>(x + rows.first * plane +
                                             t.offset(channels));
    const int64_t stride = rows.step * plane / V;  // in packs
    float k = 0.0f;
    auto add = [&](const P& v) {
      k += 1.0f;
      const float inv = __frcp_rn(k);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xv = widen(v.v[j]);
        const float d = xv - mean[j];
        mean[j] = fmaf(d, inv, mean[j]);
        m2[j] = fmaf(d, xv - mean[j], m2[j]);
      }
    };
    int r = 0;
    for (; r + kUnroll <= rows.count; r += kUnroll) {
      P v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = in[u * stride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(v[u]);
      in += kUnroll * stride;
    }
    for (; r < rows.count; ++r) {
      add(*in);
      in += stride;
    }
  }
  // the slot of (local, group) is threadIdx.x * V; a point's is C further
  const int base = threadIdx.x * V;
  const float n = static_cast<float>(rows.count);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_mean[base + j] = mean[j];
    s_m2[base + j] = m2[j];
  }
  for (int s = tree_span(t.points) / 2; s >= 1; s /= 2) {
    __syncthreads();
    if (t.local < s && t.local + s < t.valid) {
      const int other = base + s * channels;
      const float na = n * slot_points(t.local, s, t.valid);
      const float nb = n * slot_points(t.local + s, s, t.valid);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float count = na;
        chan(count, mean[j], m2[j], nb, s_mean[other + j], s_m2[other + j]);
        s_mean[base + j] = mean[j];
        s_m2[base + j] = m2[j];
      }
    }
  }
  if (t.local == 0) {
    const int64_t part = int64_t{blockIdx.y} * gridDim.x + blockIdx.x;
    const int64_t parts = int64_t{gridDim.x} * gridDim.y;
    float* out_mean = partial + part * channels + t.group * V;
    float* out_m2 = partial + (parts + part) * channels + t.group * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out_mean[j] = mean[j];
      out_m2[j] = m2[j];
    }
    if (t.group == 0) partial[2 * parts * channels + part] = n * t.valid;
  }
}

// The finishing block's channel and lane: channels a block `cpb` (a power
// of two up to kFinishChannels), lanes kThreads / cpb.
struct Finish {
  int cpb;
  int lanes;
  int lane;
  int channel;

  __device__ explicit Finish(int channels) {
    const int most = min(channels, kFinishChannels);
    cpb = 1;
    while (cpb * 2 <= most) cpb *= 2;
    lanes = kThreads / cpb;
    lane = threadIdx.x / cpb;
    channel = blockIdx.x * cpb + threadIdx.x % cpb;
  }
};

// A channel's partials merged in a fixed order: lane l takes partials l,
// l + lanes, ... in turn, then a tree over the lanes. Writes saved = (mean,
// invstd) (2, C) and moves the running statistics.
__global__ void __launch_bounds__(kThreads)
    bn_stats_finish_kernel(const float* __restrict__ partial, int parts,
                           int channels, float eps, float momentum,
                           float bessel, float* __restrict__ saved,
                           float* __restrict__ running_mean,
                           float* __restrict__ running_var) {
  __shared__ float s_n[kThreads], s_mean[kThreads], s_m2[kThreads];
  const Finish f(channels);
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  if (f.channel < channels) {
    const float* p_mean = partial + f.channel;
    const float* p_m2 = partial + int64_t{parts} * channels + f.channel;
    const float* p_count = partial + 2 * int64_t{parts} * channels;
    int k = f.lane;
    for (; k + (kFinishUnroll - 1) * f.lanes < parts;
         k += kFinishUnroll * f.lanes) {
      float pn[kFinishUnroll], pm[kFinishUnroll], pq[kFinishUnroll];
#pragma unroll
      for (int u = 0; u < kFinishUnroll; ++u) {
        const int64_t at = k + u * f.lanes;
        pn[u] = p_count[at];
        pm[u] = p_mean[at * channels];
        pq[u] = p_m2[at * channels];
      }
#pragma unroll
      for (int u = 0; u < kFinishUnroll; ++u) {
        chan(n, mean, m2, pn[u], pm[u], pq[u]);
      }
    }
    for (; k < parts; k += f.lanes) {
      chan(n, mean, m2, p_count[k], p_mean[int64_t{k} * channels],
           p_m2[int64_t{k} * channels]);
    }
  }
  s_n[threadIdx.x] = n;
  s_mean[threadIdx.x] = mean;
  s_m2[threadIdx.x] = m2;
  for (int s = f.lanes / 2; s >= 1; s /= 2) {
    __syncthreads();
    if (f.lane < s) {
      const int other = threadIdx.x + s * f.cpb;
      chan(n, mean, m2, s_n[other], s_mean[other], s_m2[other]);
      s_n[threadIdx.x] = n;
      s_mean[threadIdx.x] = mean;
      s_m2[threadIdx.x] = m2;
    }
  }
  if (f.lane == 0 && f.channel < channels) {
    const int c = f.channel;
    const float var = m2 / n;
    saved[c] = mean;
    saved[channels + c] = rsqrtf(var + eps);
    const float unbiased = var * bessel;
    running_mean[c] = mean * momentum + (1 - momentum) * running_mean[c];
    running_var[c] = unbiased * momentum + (1 - momentum) * running_var[c];
  }
}

// y = relu(bn(x) [+ skip]). Train: mean and invstd from `saved`; eval
// (saved null): the running mean and rsqrtf(running_var + eps).
template <typename T, int V, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                    T* __restrict__ y, const float* __restrict__ saved,
                    const float* __restrict__ running_mean,
                    const float* __restrict__ running_var,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias, int batch, int channels,
                    int rows, float eps) {
  const Tile<V> t(channels);
  if (!t.active()) return;
  float m[V], is[V], w[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = t.group * V + j;
    if (saved != nullptr) {
      m[j] = saved[c];
      is[j] = saved[channels + c];
    } else {
      m[j] = running_mean[c];
      is[j] = rsqrtf(running_var[c] + eps);
    }
    w[j] = weight[c];
    sh[j] = bias[c];
  }
  using P = Pack<T, V>;
  const int64_t plane = int64_t{kPoints} * channels;
  const int r0 = apply_first_row(rows);
  const int r1 = min(batch, r0 + rows);
  const int64_t start = r0 * plane + t.offset(channels);
  const P* in = reinterpret_cast<const P*>(x + start);
  const P* add = reinterpret_cast<const P*>(skip + start);
  P* out = reinterpret_cast<P*>(y + start);
  const int64_t stride = plane / V;
  auto apply = [&](const P& xv, const P& sv) {
    P o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      T s = narrow<T>(bn_value(widen(xv.v[j]), m[j], w[j], is[j], sh[j]));
      if (kSkip) s = narrow<T>(widen(s) + widen(sv.v[j]));
      o.v[j] = relu(s);
    }
    return o;
  };
  int r = r0;
  for (; r + kUnroll <= r1; r += kUnroll) {
    P xv[kUnroll], sv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u] = in[u * stride];
      if (kSkip) sv[u] = add[u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) out[u * stride] = apply(xv[u], sv[u]);
    in += kUnroll * stride;
    add += kUnroll * stride;
    out += kUnroll * stride;
  }
  for (; r < r1; ++r) {
    out[0] = apply(*in, kSkip ? *add : *in);
    in += stride;
    add += stride;
    out += stride;
  }
}

// The per-channel constants a backward thread keeps: the forward's mean,
// invstd, scale and shift.
template <int V>
struct Channels {
  float m[V], is[V], w[V], sh[V];

  __device__ Channels(int group, int channels, const float* saved,
                      const float* weight, const float* bias) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = group * V + j;
      m[j] = saved[c];
      is[j] = saved[channels + c];
      w[j] = weight[c];
      sh[j] = bias[c];
    }
  }
};

// dY through ReLU's mask. With a skip the mask is y's (the block's output);
// without one it is recomputed from x as the forward computed y.
template <typename T, int V, bool kSkip>
__device__ __forceinline__ T masked(const Channels<V>& k, int j, T g, T xv,
                                    T yv) {
  const bool pass = kSkip ? passes(yv)
                          : passes(narrow<T>(bn_value(widen(xv), k.m[j],
                                                      k.w[j], k.is[j],
                                                      k.sh[j])));
  return pass ? g : narrow<T>(0.0f);
}

// Sums of dy_eff and dy_eff * (x - mean) over one slab of rows at one tile
// of points, the block's points summed in a fixed tree; one partial per
// channel: (parts, C) each. With a skip, dy_eff is written (the skip's
// gradient).
template <typename T, int V, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    bn_backward_reduce_kernel(const T* __restrict__ dy,
                              const T* __restrict__ x,
                              const T* __restrict__ y,
                              T* __restrict__ dy_eff,
                              const float* __restrict__ saved,
                              const float* __restrict__ weight,
                              const float* __restrict__ bias,
                              float* __restrict__ partial, int batch,
                              int channels) {
  __shared__ float s_dy[kThreads * kMaxVector];
  __shared__ float s_dyx[kThreads * kMaxVector];
  const Tile<V> t(channels);
  float sdy[V], sdyx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sdy[j] = sdyx[j] = 0.0f;
  if (t.active()) {
    const Channels<V> k(t.group, channels, saved, weight, bias);
    using P = Pack<T, V>;
    const int64_t plane = int64_t{kPoints} * channels;
    const Rows rows(batch);
    const int64_t start = rows.first * plane + t.offset(channels);
    const P* g = reinterpret_cast<const P*>(dy + start);
    const P* in = reinterpret_cast<const P*>(x + start);
    const P* out = reinterpret_cast<const P*>(y + start);
    P* eff = reinterpret_cast<P*>(dy_eff + start);
    const int64_t stride = rows.step * plane / V;
    auto add = [&](const P& gv, const P& xv, const P& yv) {
      P o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o.v[j] = masked<T, V, kSkip>(k, j, gv.v[j], xv.v[j], yv.v[j]);
        const float e = widen(o.v[j]);
        sdy[j] += e;
        sdyx[j] += e * (widen(xv.v[j]) - k.m[j]);
      }
      return o;
    };
    int r = 0;
    for (; r + kUnroll <= rows.count; r += kUnroll) {
      P gv[kUnroll], xv[kUnroll], yv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        gv[u] = g[u * stride];
        xv[u] = in[u * stride];
        if (kSkip) yv[u] = out[u * stride];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const P o = add(gv[u], xv[u], kSkip ? yv[u] : xv[u]);
        if (kSkip) eff[u * stride] = o;
      }
      g += kUnroll * stride;
      in += kUnroll * stride;
      out += kUnroll * stride;
      eff += kUnroll * stride;
    }
    for (; r < rows.count; ++r) {
      const P o = add(*g, *in, kSkip ? *out : *in);
      if (kSkip) *eff = o;
      g += stride;
      in += stride;
      out += stride;
      eff += stride;
    }
  }
  const int base = threadIdx.x * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_dy[base + j] = sdy[j];
    s_dyx[base + j] = sdyx[j];
  }
  for (int s = tree_span(t.points) / 2; s >= 1; s /= 2) {
    __syncthreads();
    if (t.local < s && t.local + s < t.valid) {
      const int other = base + s * channels;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sdy[j] += s_dy[other + j];
        sdyx[j] += s_dyx[other + j];
        s_dy[base + j] = sdy[j];
        s_dyx[base + j] = sdyx[j];
      }
    }
  }
  if (t.local == 0) {
    const int64_t part = int64_t{blockIdx.y} * gridDim.x + blockIdx.x;
    const int64_t parts = int64_t{gridDim.x} * gridDim.y;
    float* out_dy = partial + part * channels + t.group * V;
    float* out_dyx = partial + (parts + part) * channels + t.group * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out_dy[j] = sdy[j];
      out_dyx[j] = sdyx[j];
    }
  }
}

// A channel's partial sums added in a fixed order (as the statistics'),
// into sums = (sum_dy, sum_dy_xmu) (2, C) and the scale's and shift's
// gradients.
__global__ void __launch_bounds__(kThreads)
    bn_backward_finish_kernel(const float* __restrict__ partial, int parts,
                              int channels, const float* __restrict__ saved,
                              float* __restrict__ sums,
                              float* __restrict__ grad_weight,
                              float* __restrict__ grad_bias) {
  __shared__ float s_dy[kThreads], s_dyx[kThreads];
  const Finish f(channels);
  float dy = 0.0f, dyx = 0.0f;
  if (f.channel < channels) {
    const float* p_dy = partial + f.channel;
    const float* p_dyx = partial + int64_t{parts} * channels + f.channel;
    int k = f.lane;
    for (; k + (kFinishUnroll - 1) * f.lanes < parts;
         k += kFinishUnroll * f.lanes) {
      float a[kFinishUnroll], b[kFinishUnroll];
#pragma unroll
      for (int u = 0; u < kFinishUnroll; ++u) {
        const int64_t at = (k + u * f.lanes) * int64_t{channels};
        a[u] = p_dy[at];
        b[u] = p_dyx[at];
      }
#pragma unroll
      for (int u = 0; u < kFinishUnroll; ++u) {
        dy += a[u];
        dyx += b[u];
      }
    }
    for (; k < parts; k += f.lanes) {
      dy += p_dy[int64_t{k} * channels];
      dyx += p_dyx[int64_t{k} * channels];
    }
  }
  s_dy[threadIdx.x] = dy;
  s_dyx[threadIdx.x] = dyx;
  for (int s = f.lanes / 2; s >= 1; s /= 2) {
    __syncthreads();
    if (f.lane < s) {
      const int other = threadIdx.x + s * f.cpb;
      dy += s_dy[other];
      dyx += s_dyx[other];
      s_dy[threadIdx.x] = dy;
      s_dyx[threadIdx.x] = dyx;
    }
  }
  if (f.lane == 0 && f.channel < channels) {
    const int c = f.channel;
    sums[c] = dy;
    sums[channels + c] = dyx;
    grad_bias[c] = dy;
    grad_weight[c] = dyx * saved[channels + c];
  }
}

// dX by BN's element formula, from dy_eff: the masked dY written by the
// reduce (skip given), or dY masked again here (no skip).
template <typename T, int V, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    bn_backward_apply_kernel(const T* __restrict__ g_in,
                             const T* __restrict__ x, T* __restrict__ dx,
                             const float* __restrict__ saved,
                             const float* __restrict__ sums,
                             const float* __restrict__ weight,
                             const float* __restrict__ bias, int batch,
                             int channels, int rows, float norm) {
  const Tile<V> t(channels);
  if (!t.active()) return;
  const Channels<V> k(t.group, channels, saved, weight, bias);
  float m_dy[V], f1[V], f2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = t.group * V + j;
    m_dy[j] = sums[c] * norm;
    f2[j] = k.w[j] * k.is[j];
    f1[j] = k.is[j] * k.is[j] * sums[channels + c] * norm;
  }
  using P = Pack<T, V>;
  const int64_t plane = int64_t{kPoints} * channels;
  const int r0 = apply_first_row(rows);
  const int r1 = min(batch, r0 + rows);
  const int64_t start = r0 * plane + t.offset(channels);
  const P* g = reinterpret_cast<const P*>(g_in + start);
  const P* in = reinterpret_cast<const P*>(x + start);
  P* out = reinterpret_cast<P*>(dx + start);
  const int64_t stride = plane / V;
  auto apply = [&](const P& gv, const P& xv) {
    P o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T e = kSkip ? gv.v[j]
                        : masked<T, V, false>(k, j, gv.v[j], xv.v[j],
                                              xv.v[j]);
      const float xf = widen(xv.v[j]);
      o.v[j] = narrow<T>((widen(e) - m_dy[j] - (xf - k.m[j]) * f1[j]) *
                         f2[j]);
    }
    return o;
  };
  int r = r0;
  for (; r + kUnroll <= r1; r += kUnroll) {
    P gv[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      gv[u] = g[u * stride];
      xv[u] = in[u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) out[u * stride] = apply(gv[u], xv[u]);
    g += kUnroll * stride;
    in += kUnroll * stride;
    out += kUnroll * stride;
  }
  for (; r < r1; ++r) {
    *out = apply(*g, *in);
    g += stride;
    in += stride;
    out += stride;
  }
}

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % kVectorBytes == 0;
}

int finish_blocks(int channels) {
  const int most = channels < kFinishChannels ? channels : kFinishChannels;
  int cpb = 1;
  while (cpb * 2 <= most) cpb *= 2;
  return (channels + cpb - 1) / cpb;
}

// The grid of one pass: tiles of points x slabs of `rows` rows.
struct Pass {
  int rows;
  int slabs;
};

dim3 grid(int channels, int vector, Pass pass) {
  const int points = kThreads / (channels / vector);
  return dim3((kPoints + points - 1) / points, pass.slabs);
}

int parts(int channels, int vector, Pass pass) {
  const dim3 g = grid(channels, vector, pass);
  return static_cast<int>(g.x * g.y);
}

template <typename T, int V>
int forward(const void* x, const void* skip, void* y, const float* weight,
            const float* bias, float* running_mean, float* running_var,
            float* saved, float* partial, int batch, int channels,
            Pass reduce, Pass apply, bool train, float eps, float momentum,
            float bessel, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (train) {
    bn_stats_kernel<T, V><<<grid(channels, V, reduce), kThreads, 0,
                            stream>>>(xt, partial, batch, channels);
    bn_stats_finish_kernel<<<finish_blocks(channels), kThreads, 0,
                             stream>>>(partial, parts(channels, V, reduce),
                                       channels, eps, momentum, bessel, saved,
                                       running_mean, running_var);
  }
  const float* use = train ? saved : nullptr;
  const dim3 g = grid(channels, V, apply);
  if (skip != nullptr) {
    bn_apply_kernel<T, V, true><<<g, kThreads, 0, stream>>>(
        xt, static_cast<const T*>(skip), static_cast<T*>(y), use,
        running_mean, running_var, weight, bias, batch, channels, apply.rows,
        eps);
  } else {
    bn_apply_kernel<T, V, false><<<g, kThreads, 0, stream>>>(
        xt, xt, static_cast<T*>(y), use, running_mean, running_var, weight,
        bias, batch, channels, apply.rows, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool kSkip>
void backward_passes(const T* dy, const T* x, const T* y, T* dy_eff, T* dx,
                     const float* weight, const float* bias,
                     const float* saved, float* partial, float* sums,
                     float* grad_weight, float* grad_bias, int batch,
                     int channels, Pass reduce, Pass apply, float norm,
                     cudaStream_t stream) {
  bn_backward_reduce_kernel<T, V, kSkip>
      <<<grid(channels, V, reduce), kThreads, 0, stream>>>(
          dy, x, y, dy_eff, saved, weight, bias, partial, batch, channels);
  bn_backward_finish_kernel<<<finish_blocks(channels), kThreads, 0,
                              stream>>>(partial, parts(channels, V, reduce),
                                        channels, saved, sums, grad_weight,
                                        grad_bias);
  bn_backward_apply_kernel<T, V, kSkip>
      <<<grid(channels, V, apply), kThreads, 0, stream>>>(
          kSkip ? dy_eff : dy, x, dx, saved, sums, weight, bias, batch,
          channels, apply.rows, norm);
}

template <typename T, int V>
int backward(const void* dy, const void* x, const void* y, void* dy_eff,
             void* dx, const float* weight, const float* bias,
             const float* saved, float* partial, float* sums,
             float* grad_weight, float* grad_bias, int batch, int channels,
             Pass reduce, Pass apply, float norm, cudaStream_t stream) {
  const T* g = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  if (y != nullptr) {
    backward_passes<T, V, true>(g, xt, static_cast<const T*>(y),
                                static_cast<T*>(dy_eff), static_cast<T*>(dx),
                                weight, bias, saved, partial, sums,
                                grad_weight, grad_bias, batch, channels,
                                reduce, apply, norm, stream);
  } else {
    backward_passes<T, V, false>(g, xt, xt, static_cast<T*>(nullptr),
                                 static_cast<T*>(dx), weight, bias, saved,
                                 partial, sums, grad_weight, grad_bias,
                                 batch, channels, reduce, apply, norm,
                                 stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a SM of the three reducing passes (the statistics, the
// backward's reduce without and with a skip) at one type and vector.
template <typename T, int V>
int blocks_per_sm(int* out) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, bn_stats_kernel<T, V>, kThreads, 0);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, bn_backward_reduce_kernel<T, V, false>, kThreads, 0);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, bn_backward_reduce_kernel<T, V, true>, kThreads, 0);
  }
  return static_cast<int>(err);
}

bool valid_pass(int batch, Pass pass) {
  return pass.rows >= 1 && pass.slabs >= 1 && pass.slabs <= 65535 &&
         int64_t{pass.rows} * (pass.slabs - 1) < batch &&
         int64_t{pass.rows} * pass.slabs >= batch;
}

// The partition's arguments, as ops/cuda_bn_epilogue.plan gives them:
// vector is 1, or 16 / elem_bytes with C a multiple of it and every tensor
// 16-byte aligned; C / vector threads cover a point, so at most kThreads;
// each pass's slabs * rows covers the batch; the counts stay exact in
// float32.
bool valid(int batch, int channels, int elem_bytes, int vector, Pass reduce,
           Pass apply) {
  if (batch < 1 || channels < 1 || !valid_pass(batch, reduce) ||
      !valid_pass(batch, apply)) {
    return false;
  }
  if (int64_t{batch} * kPoints >= (int64_t{1} << 24)) return false;
  if (elem_bytes != 2 && elem_bytes != 4) return false;
  if (vector != 1 &&
      (vector != kVectorBytes / elem_bytes || channels % vector != 0))
    return false;
  return channels / vector <= kThreads;
}

}  // namespace

// Writes the resident blocks a SM of the statistics pass and of the
// backward's reduce without and with a skip (out[0..2]) at bf16
// (elem_bytes == 2) or float32 and `vector` (1 or 16 / elem_bytes), on the
// current device: ops/cuda_bn_epilogue.plan sizes the reducing passes to
// one wave with them. Returns a cudaError_t (0 on success).
extern "C" int deepgo_bn_blocks_per_sm(int elem_bytes, int vector,
                                       int* out) {
  if (elem_bytes == 2) {
    return vector == 1 ? blocks_per_sm<__nv_bfloat16, 1>(out)
                       : blocks_per_sm<__nv_bfloat16, 8>(out);
  }
  return vector == 1 ? blocks_per_sm<float, 1>(out)
                     : blocks_per_sm<float, 4>(out);
}

// Launches the forward on `stream`: y = relu(bn(x) [+ skip]).
//   x, skip, y: (batch, channels, 19, 19) channels-last, bf16 (elem_bytes
//               == 2) or float32 (elem_bytes == 4), 16-byte aligned when
//               vector > 1; skip null for none
//   weight, bias, running_mean, running_var: (channels,) float32
//   train != 0: batch statistics; saved (2, channels) float32 receives the
//               mean and invstd, partial is (tiles * reduce_slabs * (2 *
//               channels + 1)) float32 scratch, the running statistics are
//               moved by momentum (the variance's by bessel = N / (N - 1)
//               first);
//   train == 0: the running statistics; saved and partial unused
//   vector, reduce_rows, reduce_slabs (the statistics pass), rows, slabs
//   (the apply pass): the partition (ops/cuda_bn_epilogue.plan)
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int deepgo_bn_relu_forward(
    const void* x, const void* skip, void* y, const float* weight,
    const float* bias, float* running_mean, float* running_var, float* saved,
    float* partial, int batch, int channels, int elem_bytes, int vector,
    int reduce_rows, int reduce_slabs, int rows, int slabs, int train,
    float eps, float momentum, float bessel, void* stream) {
  const Pass reduce{reduce_rows, reduce_slabs}, apply{rows, slabs};
  if (!valid(batch, channels, elem_bytes, vector, reduce, apply) ||
      (train && (saved == nullptr || partial == nullptr)) ||
      (vector > 1 && !(aligned(x) && aligned(skip) && aligned(y)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool t = train != 0;
  if (elem_bytes == 2) {
    return vector == 1
               ? forward<__nv_bfloat16, 1>(x, skip, y, weight, bias,
                                           running_mean, running_var, saved,
                                           partial, batch, channels, reduce,
                                           apply, t, eps, momentum, bessel, s)
               : forward<__nv_bfloat16, 8>(x, skip, y, weight, bias,
                                           running_mean, running_var, saved,
                                           partial, batch, channels, reduce,
                                           apply, t, eps, momentum, bessel,
                                           s);
  }
  return vector == 1
             ? forward<float, 1>(x, skip, y, weight, bias, running_mean,
                                 running_var, saved, partial, batch, channels,
                                 reduce, apply, t, eps, momentum, bessel, s)
             : forward<float, 4>(x, skip, y, weight, bias, running_mean,
                                 running_var, saved, partial, batch, channels,
                                 reduce, apply, t, eps, momentum, bessel, s);
}

// Launches the train-mode backward on `stream`.
//   dy, x, dx: as x above; y: the forward's output where it added a skip
//              (the mask is then y's, and dy_eff, as x, receives the masked
//              dY: the skip's gradient), else null (the mask is recomputed
//              from x; dy_eff unused)
//   weight, bias: (channels,) float32; saved: the forward's (2, channels)
//   partial: (tiles * reduce_slabs * 2 * channels) float32 scratch; sums
//            (2, channels) float32 receives sum_dy and sum_dy_xmu
//   grad_weight, grad_bias: (channels,) float32, written whole
//   vector, reduce_rows, reduce_slabs (the reduce), rows, slabs (the
//   apply pass): the partition; norm: float32 of 1 / (batch * 361)
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int deepgo_bn_relu_backward(
    const void* dy, const void* x, const void* y, void* dy_eff, void* dx,
    const float* weight, const float* bias, const float* saved,
    float* partial, float* sums, float* grad_weight, float* grad_bias,
    int batch, int channels, int elem_bytes, int vector, int reduce_rows,
    int reduce_slabs, int rows, int slabs, float norm, void* stream) {
  const Pass reduce{reduce_rows, reduce_slabs}, apply{rows, slabs};
  if (!valid(batch, channels, elem_bytes, vector, reduce, apply) ||
      (y != nullptr && dy_eff == nullptr) ||
      (vector > 1 && !(aligned(dy) && aligned(x) && aligned(y) &&
                       aligned(dy_eff) && aligned(dx)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return vector == 1
               ? backward<__nv_bfloat16, 1>(dy, x, y, dy_eff, dx, weight,
                                            bias, saved, partial, sums,
                                            grad_weight, grad_bias, batch,
                                            channels, reduce, apply, norm, s)
               : backward<__nv_bfloat16, 8>(dy, x, y, dy_eff, dx, weight,
                                            bias, saved, partial, sums,
                                            grad_weight, grad_bias, batch,
                                            channels, reduce, apply, norm, s);
  }
  return vector == 1
             ? backward<float, 1>(dy, x, y, dy_eff, dx, weight, bias, saved,
                                  partial, sums, grad_weight, grad_bias,
                                  batch, channels, reduce, apply, norm, s)
             : backward<float, 4>(dy, x, y, dy_eff, dx, weight, bias, saved,
                                  partial, sums, grad_weight, grad_bias,
                                  batch, channels, reduce, apply, norm, s);
}
