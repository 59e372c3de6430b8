// Fused GroupNorm + SiLU over contiguous NCHW tensors, f32 statistics, one
// launch per call.
//
// Replaces both Pallas bodies of audio_diffusion_tpu/ops/pallas_groupnorm.py,
// _stats_kernel (:51) and _apply_kernel (:66), with one single-pass kernel:
// y = silu((x - mean) * rstd * scale[c] + bias[c]) per (batch, group).
//
// What bounds it on Hopper: bytes. It does a handful of flops per element, far
// below the card's flop-per-byte balance, so the least time is one read of x
// and one write of y at the card's memory rate.
//
// Design:
// * In NCHW one (batch, group) pair is ONE contiguous slab of cs*H*W values
//   (cs = C/G). The slab is read from device memory once, with 16-byte loads
//   where the pointer and the slab allow, kept on chip, reduced in f32, then
//   normalized, scaled, passed through SiLU and stored from the copy on chip.
//   No scratch tensor, no second launch.
// * Routes by slab size, chosen from the shape alone by
//   ops/fused_groupnorm.py::launch_plan:
//     warp     slab <= kWarpSlab: one warp per slab, 8 slabs per block, the
//              slab in registers (the smallest levels of the latent UNet);
//     block    one CTA per slab, the slab in shared memory;
//     cluster  a thread-block cluster of 2-16 CTAs per slab, each CTA keeps
//              its chunk in shared memory; the per-CTA (sum, sum of squares)
//              are added through distributed shared memory in rank order;
//     reread   as cluster, for chunks larger than kMaxSmem: the apply step
//              reads the chunk again (from L2) instead of caching it.
// * Deterministic: no atomics. Every sum is taken in an order fixed by the
//   launch plan, which depends on (C, H, W, G, dtype) only, so a row's output
//   does not depend on the batch around it. Aligned and unaligned pointers
//   take the same order; only the width of the load differs.
// * Variance is the fast form E[x^2] - mean^2, as pallas_groupnorm.py:72 and
//   flax's use_fast_variance compute it. Affine and SiLU run in f32 and round
//   once to x's dtype. Per channel the kernel folds rstd into the scale,
//   y = silu((x - mean) * (rstd * scale[c]) + bias[c]), with SiLU as
//   v / (1 + exp(-v)) through the fast intrinsics __expf and __fdividef (a
//   few f32 ulp; the tolerances are 1e-5 * max|y| in f32, 1 ulp in bf16).
//   That keeps the apply step near 8 instructions per value, so the
//   instruction issue stays under the memory time.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpSlab = 256;        // fused_groupnorm.WARP_MAX_SLAB
constexpr int kWarpThreads = 256;     // 8 slabs per block on the warp route
constexpr int kCtaMaxThreads = 512;   // fused_groupnorm.MAX_THREADS
constexpr int kMaxSmem = 200 * 1024;  // fused_groupnorm.MAX_CACHE_BYTES

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane adds the same pairs, so all lanes hold the same sum.
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// The V = 16 / sizeof(T) consecutive values one thread loads at a time.
template <typename T>
struct alignas(16) Pack {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  T e[V];
};

// p[i .. i+V), i % V == 0; values at or past n read as 0. One 16-byte load
// when `vec` (p is 16-byte aligned) and the pack is whole.
template <typename T>
__device__ __forceinline__ Pack<T> load_pack(const T* __restrict__ p, int i, int n, int vec) {
  Pack<T> pk;
  if (vec && i + Pack<T>::V <= n) {
    *reinterpret_cast<uint4*>(pk.e) = __ldg(reinterpret_cast<const uint4*>(p + i));
  } else {
#pragma unroll
    for (int j = 0; j < Pack<T>::V; ++j) pk.e[j] = i + j < n ? p[i + j] : from_f32<T>(0.f);
  }
  return pk;
}

template <typename T>
__device__ __forceinline__ void store_pack(T* __restrict__ p, int i, int n, int vec, const Pack<T>& pk) {
  if (vec && i + Pack<T>::V <= n) {
    *reinterpret_cast<uint4*>(p + i) = *reinterpret_cast<const uint4*>(pk.e);
  } else {
#pragma unroll
    for (int j = 0; j < Pack<T>::V; ++j)
      if (i + j < n) p[i + j] = pk.e[j];
  }
}

template <typename T>
__device__ __forceinline__ void accumulate(const Pack<T>& pk, int valid, float& s, float& s2) {
#pragma unroll
  for (int j = 0; j < Pack<T>::V; ++j) {
    if (j < valid) {
      const float v = to_f32(pk.e[j]);
      s += v;
      s2 += v * v;
    }
  }
}

__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// silu((x - mean) * (rstd * scale[c]) + bias[c]) for the first `valid` values
// of a pack whose first value sits at index gi of its slab (channel
// c0 + gi / hw). When hw is a whole number of packs, no pack straddles two
// channels and the scale and bias are read once per pack.
template <typename T>
__device__ __forceinline__ Pack<T> apply_pack(const Pack<T>& in, int gi, int valid, int hw, int c0,
                                              const float* __restrict__ scale, const float* __restrict__ bias,
                                              float mean, float rstd) {
  Pack<T> out;
  int q = gi / hw;
  if (hw % Pack<T>::V == 0) {
    const float a = rstd * __ldg(scale + c0 + q), b = __ldg(bias + c0 + q);
#pragma unroll
    for (int j = 0; j < Pack<T>::V; ++j) out.e[j] = from_f32<T>(silu((to_f32(in.e[j]) - mean) * a + b));
    return out;
  }
  int r = gi - q * hw;
#pragma unroll
  for (int j = 0; j < Pack<T>::V; ++j) {
    if (j < valid) {
      const int c = c0 + q;
      out.e[j] = from_f32<T>(silu((to_f32(in.e[j]) - mean) * (rstd * __ldg(scale + c)) + __ldg(bias + c)));
      if (++r == hw) {
        r = 0;
        ++q;
      }
    }
  }
  return out;
}

// Sum (s, s2) over the block; every thread gets the same result, added in warp order.
__device__ __forceinline__ void block_sum2(float& s, float& s2) {
  __shared__ float sh[2][kCtaMaxThreads / 32];
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh[0][warp] = s;
    sh[1][warp] = s2;
  }
  __syncthreads();
  s = 0.f;
  s2 = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    s += sh[0][w];
    s2 += sh[1][w];
  }
}

__device__ __forceinline__ void mean_rstd(float s, float s2, int count, float eps, float& mean, float& rstd) {
  const float n = static_cast<float>(count);
  mean = s / n;
  const float var = s2 / n - mean * mean;
  rstd = 1.f / sqrtf(var + eps);
}

// Warp route: grid ceil(B*G / 8), block kWarpThreads; warp w of block b owns slab b*8 + w.
template <typename T>
__global__ void __launch_bounds__(kWarpThreads) gn_silu_warp_kernel(const T* __restrict__ x,
                                                                    const float* __restrict__ scale,
                                                                    const float* __restrict__ bias,
                                                                    T* __restrict__ y, long long bg_count,
                                                                    int groups, int cs, int hw, float eps, int vec) {
  constexpr int V = Pack<T>::V;
  constexpr int kIters = kWarpSlab / (32 * V);
  const long long bg = static_cast<long long>(blockIdx.x) * (kWarpThreads / 32) + (threadIdx.x >> 5);
  if (bg >= bg_count) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int slab = cs * hw;
  const T* xp = x + bg * slab;
  T* yp = y + bg * slab;
  Pack<T> pk[kIters];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int i = (k * 32 + lane) * V;
    if (i < slab) {
      pk[k] = load_pack(xp, i, slab, vec);
      accumulate(pk[k], slab - i, s, s2);
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  float mean, rstd;
  mean_rstd(s, s2, slab, eps, mean, rstd);
  const int c0 = static_cast<int>(bg % groups) * cs;
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int i = (k * 32 + lane) * V;
    if (i < slab) store_pack(yp, i, slab, vec, apply_pack(pk[k], i, slab - i, hw, c0, scale, bias, mean, rstd));
  }
}

// Block, cluster and reread routes: grid B*G*ctas, cluster (ctas, 1, 1) when
// ctas > 1. CTA `rank` of a slab owns [rank*chunk, rank*chunk + chunk); with
// `cache` it keeps its chunk in dynamic shared memory, else it reads it twice.
template <typename T>
__global__ void __launch_bounds__(kCtaMaxThreads) gn_silu_cta_kernel(const T* __restrict__ x,
                                                                     const float* __restrict__ scale,
                                                                     const float* __restrict__ bias,
                                                                     T* __restrict__ y, int groups, int cs, int hw,
                                                                     int ctas, int chunk, int cache, float eps,
                                                                     int vec) {
  constexpr int V = Pack<T>::V;
  extern __shared__ uint4 smem[];
  Pack<T>* buf = reinterpret_cast<Pack<T>*>(smem);
  __shared__ float part[2];
  const long long bg = blockIdx.x / ctas;
  const int rank = static_cast<int>(blockIdx.x - bg * ctas);
  const int slab = cs * hw;
  const int begin = rank * chunk;
  const int n = min(chunk, slab - begin);
  const T* xp = x + bg * slab + begin;
  T* yp = y + bg * slab + begin;
  const int stride = static_cast<int>(blockDim.x) * V;

  float s = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x * V; i < n; i += stride) {
    const Pack<T> pk = load_pack(xp, i, n, vec);
    if (cache) buf[i / V] = pk;
    accumulate(pk, n - i, s, s2);
  }
  block_sum2(s, s2);
  if (ctas > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      part[0] = s;
      part[1] = s2;
    }
    cluster.sync();
    s = 0.f;
    s2 = 0.f;
    for (int r = 0; r < ctas; ++r) {  // rank order: every CTA of the slab gets the same sums
      const float* peer = cluster.map_shared_rank(part, r);
      s += peer[0];
      s2 += peer[1];
    }
    cluster.sync();  // no CTA leaves while a peer still reads its `part`
  }
  float mean, rstd;
  mean_rstd(s, s2, slab, eps, mean, rstd);
  const int c0 = static_cast<int>(bg % groups) * cs;
#pragma unroll 4
  for (int i = threadIdx.x * V; i < n; i += stride) {
    const Pack<T> pk = cache ? buf[i / V] : load_pack(xp, i, n, vec);
    store_pack(yp, i, n, vec, apply_pack(pk, begin + i, n - i, hw, c0, scale, bias, mean, rstd));
  }
}

}  // namespace

// One launch plan, field for field fused_groupnorm._CPlan: made once per
// (C, H, W, G, dtype) on the host and passed by pointer.
struct GnPlan {
  int is_bf16;  // 0: float32 x and y, 1: bfloat16; scale and bias are f32 (C,)
  int groups, cs, hw;
  int ctas;     // 0: warp route, else CTAs per slab (1: block route, > 1: cluster)
  int chunk;    // values per CTA
  int threads;  // threads per CTA
  int smem;     // dynamic shared memory bytes; 0: reread route
};

namespace {

template <typename T>
void launch(const void* x, const void* scale, const void* bias, void* y, long long bg_count, float eps, int vec,
            const GnPlan& p, cudaStream_t stream) {
  const int groups = p.groups, cs = p.cs, hw = p.hw, ctas = p.ctas, smem = p.smem;
  const T* xt = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  T* yt = static_cast<T*>(y);
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  if (ctas == 0) {
    cfg.gridDim = dim3(static_cast<unsigned>((bg_count + kWarpThreads / 32 - 1) / (kWarpThreads / 32)));
    cfg.blockDim = dim3(kWarpThreads);
    cudaLaunchKernelEx(&cfg, gn_silu_warp_kernel<T>, xt, sc, bi, yt, bg_count, groups, cs, hw, eps, vec);
    return;
  }
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(static_cast<unsigned>(bg_count * ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(p.threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  if (ctas > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaLaunchKernelEx(&cfg, gn_silu_cta_kernel<T>, xt, sc, bi, yt, groups, cs, hw, ctas, p.chunk, int(smem > 0), eps,
                     vec);
}

template <typename T>
cudaError_t allow_large_launches() {
  cudaError_t e = cudaFuncSetAttribute(gn_silu_cta_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(gn_silu_cta_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

// Once per process, before any launch: dynamic shared memory up to kMaxSmem
// and clusters of up to 16 CTAs for the CTA kernel. Returns a cudaError_t.
extern "C" int adt_group_norm_silu_init() {
  cudaError_t e = allow_large_launches<float>();
  if (e == cudaSuccess) e = allow_large_launches<__nv_bfloat16>();
  return static_cast<int>(e);
}

// bg_count = B * G slabs; vec: x is 16-byte aligned and every slab and chunk
// is a whole number of packs. Returns cudaGetLastError().
extern "C" int adt_group_norm_silu(const void* x, const void* scale, const void* bias, void* y, long long bg_count,
                                   float eps, int vec, const GnPlan* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan->is_bf16) {
    launch<__nv_bfloat16>(x, scale, bias, y, bg_count, eps, vec, *plan, s);
  } else {
    launch<float>(x, scale, bias, y, bg_count, eps, vec, *plan, s);
  }
  return static_cast<int>(cudaGetLastError());
}
