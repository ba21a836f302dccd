// GroupNorm, relu and the residual add in one pass over channels-last
// activations: the served AZNet's norms (gymgo_tpu_torch/models/az_net.py).
// Hand kernel for Hopper (sm_90a), built with nvcc into a shared library with
// a plain C interface and called through ctypes
// (gymgo_tpu_torch/ops/group_norm_act.py).
//
// It replaces no TPU kernel.  It is the counterpart of the fusion XLA makes of
// each conv + GroupNorm + relu block of gymgo_tpu/models/az_net.py (ResBlock and
// the stem), where the activations are NHWC too.  For x (B, H, W, C) NHWC and
// G groups it computes, per board and group,
//
//   mean, var   over the group's H*W*C/G values, in float32 (var without
//               Bessel's correction), rstd = rsqrtf(var + eps)
//   y           relu(round(x * a + b)), a = rstd * gamma[c],
//               b = beta[c] - a * mean
//   with a residual r: relu(round(r + round(x * a + b)))
//
// with the rounding points of PyTorch's group_norm, relu and add on the card:
// the library keeps mean and rstd in the working type, and forms a and b
// from those rounded values, as ComputeFusedParams does; the residual is
// added in float32 to the rounded norm.  Only the order of the statistics'
// sums differs from the library.
//
// What bounds it.  Bytes: x read once and y written once (and r read once),
// 2 or 3 passes of the activation, where the library makes 3 for the norm
// (statistics, apply) and 2 more for relu and 3 for the add.  At B = 256,
// 19x19, C = 256 in bfloat16 the activation is 47,316,992 bytes.
//
// Design: one cluster of `cs` blocks per (board, group), each block taking a
// contiguous share of the group's cells.  A group's C/G channels of one cell
// lie side by side, as p vectors of 16 bytes (of one element where the
// channels or the pointers allow no 16-byte vector); thread t of a block
// always takes vector t % p of a cell, so its channels, and their scale and
// shift, are its own for the whole launch.  `cs` is 1 when the groups alone
// fill the card, and up to 8 when they do not (batch 1 has 8 groups).  Each
// thread takes the mean and the sum of squared deviations of its own values,
// and the threads' and then the blocks' moments are merged pairwise (Chan et
// al.): as accurate as a pass for the mean and one for the deviations, with
// one reduction instead of two.  The blocks of a cluster read each other's
// moments through distributed shared memory, each merging them in rank
// order, so all get the same statistics.
//   resident  a share of up to kMaxK vectors a thread (16 KB of 16-byte
//             vectors for 128 threads, 64 KB for 512) is loaded into
//             registers once, and the result is written from them; the
//             residual is prefetched into L2 meanwhile.
//   streamed  a larger share (boards of 64x64 and up, at batches that fill
//             the card) is read twice: once for the moments, once to apply.  A
//             block re-reads its own share, so the second read mostly hits L2.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxK = 8;            // vectors a thread holds in the resident form
constexpr int kMaxThreads = 512;
constexpr int kMinThreads = 64;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxVectorsACell = kMaxThreads;  // p: a block takes at least one cell a pass

template <class T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to the working type and back
template <class T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// relu that lets NaN through, as the library's does
__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

template <class T, int VB>
struct alignas(VB) Vec {
  static constexpr int kN = VB / sizeof(T);
  T e[kN];
};

template <class T>
struct Args {
  const T* x;
  const T* res;    // nullptr: no residual
  const T* gamma;  // (C,)
  const T* beta;   // (C,)
  T* out;
  int hw;          // cells of a board
  int c;           // channels
  int groups;
  int d;           // channels of a group
  int p;           // vectors of a group in one cell
  int rows;        // cells a pass of the block, p threads each
  int cs;          // blocks of a cluster
  float eps;
};

// A thread's place: the group's first element, the block's cells [lo, hi),
// and the thread's first cell and its vector of each cell.
struct Place {
  size_t base;
  int g, lo, hi, first, part;
};

template <class T>
__device__ __forceinline__ Place place_of(const Args<T>& a) {
  const int rank = blockIdx.x % a.cs, grp = blockIdx.x / a.cs;
  const int per = (a.hw + a.cs - 1) / a.cs;
  Place s;
  s.g = grp % a.groups;
  s.base = static_cast<size_t>(grp / a.groups) * a.hw * a.c + static_cast<size_t>(s.g) * a.d;
  s.lo = min(a.hw, rank * per);
  s.hi = min(a.hw, s.lo + per);
  s.part = threadIdx.x % a.p;
  // the threads past rows * p that round the block up to whole warps take no cell
  s.first = static_cast<int>(threadIdx.x) < a.rows * a.p ? s.lo + static_cast<int>(threadIdx.x) / a.p : s.hi;
  return s;
}

// Count, mean and sum of squared deviations from the mean of some values.
struct Moments {
  float n, mean, m2;
};

// the moments of the union of a's values and b's (Chan, Golub and LeVeque)
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  const float n = a.n + b.n;
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float delta = b.mean - a.mean, wb = b.n / n;
  return {n, fmaf(delta, wb, a.mean), a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ Moments shfl_down(const Moments& v, int o) {
  return {__shfl_down_sync(0xffffffffu, v.n, o), __shfl_down_sync(0xffffffffu, v.mean, o),
          __shfl_down_sync(0xffffffffu, v.m2, o)};
}

// The moments of the cluster's values, the same in every thread of every
// block: a block's moments go to its partials, and each thread merges the
// cluster's partials in rank order.
__device__ __forceinline__ Moments group_moments(Moments v, Moments* s_red, Moments* s_part, int cs) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = merge(v, shfl_down(v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? s_red[lane] : Moments{0.f, 0.f, 0.f};
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = merge(v, shfl_down(v, o));
    if (lane == 0) *s_part = v;
  }
  if (cs == 1) {
    __syncthreads();
    return *s_part;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  Moments part[kMaxCluster];  // all the reads in flight at once, then the merges
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < cs) part[q] = *cluster.map_shared_rank(s_part, q);
#pragma unroll
  for (int q = 1; q < kMaxCluster; ++q)
    if (q < cs) part[0] = merge(part[0], part[q]);
  return part[0];
}

// A thread's scale and shift, a and b of each channel of its vector, from
// the statistics rounded to the working type as the library keeps them.
template <class T, int kN>
struct Affine {
  float a[kN], b[kN];

  // gamma and beta of the thread's channels, read before the statistics are
  // known so that their latency hides behind the reduction
  __device__ __forceinline__ Affine(const Args<T>& args, const Place& s) {
    const int c0 = s.g * args.d + s.part * kN;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      a[j] = to_f(args.gamma[c0 + j]);
      b[j] = to_f(args.beta[c0 + j]);
    }
  }

  __device__ __forceinline__ void finish(const Moments& m, float eps) {
    const float mean_r = round_to<T>(m.mean);
    const float rstd_r = round_to<T>(rsqrtf(m.m2 / m.n + eps));
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      a[j] = rstd_r * a[j];
      b[j] = fmaf(-a[j], mean_r, b[j]);
    }
  }

  template <int VB>
  __device__ __forceinline__ Vec<T, VB> apply(const Vec<T, VB>& x, const Vec<T, VB>* r) const {
    Vec<T, VB> o;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float y = round_to<T>(fmaf(a[j], to_f(x.e[j]), b[j]));
      if (r != nullptr) y = round_to<T>(to_f(r->e[j]) + y);
      o.e[j] = from_f<T>(relu(y));
    }
    return o;
  }
};

template <class T, int VB>
__device__ __forceinline__ float sum_of(const Vec<T, VB>& x) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < Vec<T, VB>::kN; ++j) sum += to_f(x.e[j]);
  return sum;
}

template <class T, int VB>
__device__ __forceinline__ float squares_about(const Vec<T, VB>& x, float mean, float m2) {
#pragma unroll
  for (int j = 0; j < Vec<T, VB>::kN; ++j) {
    const float dev = to_f(x.e[j]) - mean;
    m2 = fmaf(dev, dev, m2);
  }
  return m2;
}

// An empty asm that may change v's words: the values converted to float for
// one pass over the registers are converted again, not kept, for the next.
template <class T, int VB>
__device__ __forceinline__ void keep_packed(Vec<T, VB>& v) {
  if constexpr (VB >= 4) {
    auto* w = reinterpret_cast<unsigned*>(v.e);
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) asm volatile("" : "+r"(w[i]));
  } else {
    asm volatile("" : "+h"(*reinterpret_cast<unsigned short*>(v.e)));
  }
}

template <class T, int VB>
__global__ void __launch_bounds__(kMaxThreads) resident_kernel(const Args<T> a) {
  using V = Vec<T, VB>;
  __shared__ Moments s_red[kMaxThreads / 32];
  __shared__ Moments s_part;
  const Place s = place_of(a);
  const size_t at0 = s.base + static_cast<size_t>(s.first) * a.c + s.part * V::kN;
  const size_t step = static_cast<size_t>(a.rows) * a.c;
  V xv[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (s.first + k * a.rows < s.hi) {
      xv[k] = *reinterpret_cast<const V*>(a.x + at0 + k * step);
      if (a.res != nullptr) asm volatile("prefetch.global.L2 [%0];" ::"l"(a.res + at0 + k * step));
    }
  }
  Affine<T, V::kN> f(a, s);
  // the thread's own moments, from two passes over its registers
  int count = 0;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (s.first + k * a.rows < s.hi) {
      sum += sum_of(xv[k]);
      ++count;
      keep_packed(xv[k]);
    }
  }
  Moments m{static_cast<float>(count * V::kN), 0.f, 0.f};
  if (count > 0) m.mean = sum / m.n;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (s.first + k * a.rows < s.hi) {
      m.m2 = squares_about(xv[k], m.mean, m.m2);
      keep_packed(xv[k]);
    }
  }
  f.finish(group_moments(m, s_red, &s_part, a.cs), a.eps);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (s.first + k * a.rows < s.hi) {
      const size_t at = at0 + k * step;
      if (a.res != nullptr) {
        const V rv = *reinterpret_cast<const V*>(a.res + at);
        *reinterpret_cast<V*>(a.out + at) = f.template apply<VB>(xv[k], &rv);
      } else {
        *reinterpret_cast<V*>(a.out + at) = f.template apply<VB>(xv[k], nullptr);
      }
    }
  }
  // no block leaves while another of its cluster may read its partials
  if (a.cs > 1) cg::this_cluster().sync();
}

template <class T, int VB>
__global__ void __launch_bounds__(kMaxThreads) streamed_kernel(const Args<T> a) {
  using V = Vec<T, VB>;
  __shared__ Moments s_red[kMaxThreads / 32];
  __shared__ Moments s_part;
  const Place s = place_of(a);
  const size_t step = static_cast<size_t>(a.rows) * a.c;
  Affine<T, V::kN> f(a, s);
  Moments m{0.f, 0.f, 0.f};
  size_t at = s.base + static_cast<size_t>(s.first) * a.c + s.part * V::kN;
#pragma unroll 4
  for (int cell = s.first; cell < s.hi; cell += a.rows, at += step) {
    const V xv = *reinterpret_cast<const V*>(a.x + at);
    const float mean = sum_of(xv) / V::kN;
    m = merge(m, Moments{static_cast<float>(V::kN), mean, squares_about(xv, mean, 0.f)});
  }
  f.finish(group_moments(m, s_red, &s_part, a.cs), a.eps);
  at = s.base + static_cast<size_t>(s.first) * a.c + s.part * V::kN;
#pragma unroll 4
  for (int cell = s.first; cell < s.hi; cell += a.rows, at += step) {
    const V xv = *reinterpret_cast<const V*>(a.x + at);
    if (a.res != nullptr) {
      const V rv = *reinterpret_cast<const V*>(a.res + at);
      *reinterpret_cast<V*>(a.out + at) = f.template apply<VB>(xv, &rv);
    } else {
      *reinterpret_cast<V*>(a.out + at) = f.template apply<VB>(xv, nullptr);
    }
  }
  if (a.cs > 1) cg::this_cluster().sync();
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <class T, int VB>
cudaError_t launch(Args<T> a, int batch, int sms, cudaStream_t stream) {
  a.p = a.d / Vec<T, VB>::kN;
  if (a.p > kMaxVectorsACell) return cudaErrorInvalidValue;
  const long groups = static_cast<long>(batch) * a.groups;
  // split a group over a cluster while the groups are too few for two blocks
  // an SM, and a block keeps a few warps' worth of vectors
  a.cs = 1;
  while (a.cs < kMaxCluster && groups * a.cs < 2L * sms &&
         static_cast<long>((a.hw + 2 * a.cs - 1) / (2 * a.cs)) * a.p >= kMinThreads)
    a.cs *= 2;
  const int cells = (a.hw + a.cs - 1) / a.cs;  // a block's share
  // rows a multiple of this make whole warps
  const int unit = 32 / gcd(32, a.p);
  int rows = (cells + kMaxK - 1) / kMaxK;
  rows = (rows + unit - 1) / unit * unit;
  while (rows * a.p < kMinThreads && rows < cells) rows += unit;
  const bool resident = rows * a.p <= kMaxThreads;
  if (!resident) {
    rows = kMaxThreads / a.p;
    if (rows >= unit) rows = rows / unit * unit;
  }
  a.rows = rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups * a.cs));
  cfg.blockDim = dim3((rows * a.p + 31) / 32 * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return resident ? cudaLaunchKernelEx(&cfg, resident_kernel<T, VB>, a)
                  : cudaLaunchKernelEx(&cfg, streamed_kernel<T, VB>, a);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <class T>
cudaError_t launch_typed(const void* x, const void* res, const void* gamma, const void* beta, void* out, int batch,
                         int hw, int channels, int groups, float eps, int sms, cudaStream_t stream) {
  Args<T> a = {};
  a.x = static_cast<const T*>(x);
  a.res = static_cast<const T*>(res);
  a.gamma = static_cast<const T*>(gamma);
  a.beta = static_cast<const T*>(beta);
  a.out = static_cast<T*>(out);
  a.hw = hw;
  a.c = channels;
  a.groups = groups;
  a.d = channels / groups;
  a.eps = eps;
  // 16-byte vectors where a group's channels of a cell and every pointer allow
  // them, else one element at a time
  const bool wide = (a.d * sizeof(T)) % 16 == 0 && aligned16(x) && aligned16(out) && (res == nullptr || aligned16(res));
  return wide ? launch<T, 16>(a, batch, sms, stream) : launch<T, sizeof(T)>(a, batch, sms, stream);
}

}  // namespace

// x, res (or null), out: (batch, hw, channels) channels-last, of one type:
// dtype 0 float32, 1 bfloat16; gamma, beta: (channels,) of the same type.
extern "C" int group_norm_act_launch(const void* x, const void* res, const void* gamma, const void* beta, void* out,
                                     int dtype, int batch, int hw, int channels, int groups, float eps, int sms,
                                     void* stream) {
  if (batch < 0 || hw < 1 || groups < 1 || channels < groups || channels % groups != 0 ||
      channels / groups > kMaxVectorsACell || sms < 1 || static_cast<long>(hw) * channels > (1L << 30) ||
      static_cast<long>(batch) * groups * kMaxCluster > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_typed<float>(x, res, gamma, beta, out, batch, hw, channels, groups, eps, sms, s));
    case 1: return static_cast<int>(launch_typed<__nv_bfloat16>(x, res, gamma, beta, out, batch, hw, channels, groups,
                                                                eps, sms, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
