// Fused GroupNorm + SiLU over contiguous NCHW tensors, f32 statistics.
//
// Replaces the two Pallas bodies of audio_diffusion_tpu/ops/pallas_groupnorm.py:
//   _stats_kernel (:51-63)  -> gn_stats_kernel
//   _apply_kernel (:66-80)  -> gn_apply_kernel
//
// What bounds it on Hopper: bytes. Each element is read twice (stats, apply)
// and written once, with a handful of flops per element, far below the
// card's flop-per-byte balance.
//
// Design:
// * In NCHW one (batch, group) pair is ONE contiguous slab of cs*H*W values
//   (cs = C/G), so a group reduction is a plain strided loop with coalesced
//   loads; the TPU's one-hot (C, G) matmul is not needed.
// * The TPU version accumulates across a sequential grid. Hopper's blocks run
//   in no order, so the stats kernel instead cuts each slab into `splits`
//   chunks, one block per (slab, chunk), and writes its (sum, sum of squares)
//   to a (B*G, splits, 2) scratch. No atomics: the apply kernel adds the
//   partials in a fixed order, so results are deterministic and a row's
//   output does not depend on the batch around it (`splits` is a function
//   of (C, H, W, G) only, chosen by the Python wrapper).
// * Variance is the fast form E[x^2] - mean^2, as pallas_groupnorm.py:72 and
//   flax's use_fast_variance compute it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// grid (B*G, splits), block kThreads. partials[(bg * splits + split) * 2 + {0, 1}].
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                                                            int slab, int chunk) {
  const int64_t bg = blockIdx.x;
  const int split = blockIdx.y;
  const int begin = split * chunk;
  const int end = min(begin + chunk, slab);
  const T* p = x + bg * slab;
  float s = 0.f, s2 = 0.f;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const float v = to_f32(p[i]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  __shared__ float sh[2][kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh[0][warp] = s;
    sh[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? sh[0][lane] : 0.f;
    s2 = lane < kThreads / 32 ? sh[1][lane] : 0.f;
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      float* out = partials + (bg * gridDim.y + split) * 2;
      out[0] = s;
      out[1] = s2;
    }
  }
}

// grid (B*G, splits), block kThreads: y = silu((x - mean) * rstd * scale[c] + bias[c]).
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ partials,
                                                            const float* __restrict__ scale,
                                                            const float* __restrict__ bias, T* __restrict__ y,
                                                            int groups, int cs, int hw, int splits, int chunk,
                                                            float eps) {
  const int64_t bg = blockIdx.x;
  const int slab = cs * hw;
  __shared__ float stats[2];
  if (threadIdx.x == 0) {
    float s = 0.f, s2 = 0.f;
    const float* p = partials + bg * splits * 2;
    for (int k = 0; k < splits; ++k) {
      s += p[2 * k];
      s2 += p[2 * k + 1];
    }
    const float count = static_cast<float>(slab);
    const float mean = s / count;
    const float var = s2 / count - mean * mean;
    stats[0] = mean;
    stats[1] = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];
  const int c0 = static_cast<int>(bg % groups) * cs;
  const int begin = blockIdx.y * chunk;
  const int end = min(begin + chunk, slab);
  const T* xp = x + bg * slab;
  T* yp = y + bg * slab;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const int c = c0 + i / hw;
    float v = (to_f32(xp[i]) - mean) * rstd;
    v = v * scale[c] + bias[c];
    v = v * (1.f / (1.f + expf(-v)));
    yp[i] = from_f32<T>(v);
  }
}

}  // namespace

// is_bf16: 0 -> float32 tensors, 1 -> bfloat16 tensors. Returns cudaGetLastError().
extern "C" int adt_group_norm_stats(const void* x, void* partials, int is_bf16, long long bg_count, int slab,
                                    int splits, void* stream) {
  const int chunk = (slab + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>(bg_count), static_cast<unsigned>(splits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gn_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                             static_cast<float*>(partials), slab, chunk);
  } else {
    gn_stats_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(partials),
                                                     slab, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int adt_group_norm_silu_apply(const void* x, const void* partials, const void* scale, const void* bias,
                                         void* y, int is_bf16, long long bg_count, int groups, int cs, int hw,
                                         int splits, float eps, void* stream) {
  const int slab = cs * hw;
  const int chunk = (slab + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>(bg_count), static_cast<unsigned>(splits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(partials);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (is_bf16) {
    gn_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), p, sc, bi,
                                                             static_cast<__nv_bfloat16*>(y), groups, cs, hw,
                                                             splits, chunk, eps);
  } else {
    gn_apply_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), p, sc, bi,
                                                     static_cast<float*>(y), groups, cs, hw, splits, chunk, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
