// Many-small-heads multi-head attention forward, layout (B, heads, N, d).
//
// Replaces the Pallas body _attn_kernel of
// audio_diffusion_tpu/ops/pallas_attention.py:55-70 (reached through
// _flash_mha_fwd at :90): o = softmax(q k^T / sqrt(d)) v per head, in f32,
// cast back to q's dtype.
//
// What bounds it on Hopper: at the UNet's shapes (d = 8, 64 heads, N <= 1024)
// the arithmetic per head is tiny, so the kernel is bound by reading q, k, v
// and writing o, plus launch latency at the smallest N (1 and 4 on the
// latent-256 path). The (N, N) scores are never written to device memory.
//
// Design:
// * One block per (batch*head, tile of queries); one thread owns one query
//   row, holding q and its f32 accumulator in registers.
// * Keys and values are staged through shared memory in tiles of TK rows and
//   folded in with an online softmax in f32 (running max and sum, rescaled
//   once per tile), so there is no cap on N: the TPU version's MAX_TOKENS and
//   head tiling were limits of its VMEM and do not carry over.
// * d is a template parameter (8, 16, 32, 64, 128). Rows of a tile past N
//   are zero-filled so stale shared memory never reaches the sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <int D>
struct KeyTile {
  // Keys per shared-memory tile: the per-thread score array s[TK] and the
  // q/accumulator registers (2*D) share the register file.
  static constexpr int TK = D <= 32 ? 64 : (D == 64 ? 32 : 16);
};

// grid (B*heads, ceil(N / blockDim.x)), blockDim.x in {32, 64, 128}.
template <typename T, int D>
__global__ void mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                               T* __restrict__ o, int n, float scale) {
  constexpr int TK = KeyTile<D>::TK;
  __shared__ float ks[TK][D];
  __shared__ float vs[TK][D];

  const int64_t head_off = static_cast<int64_t>(blockIdx.x) * n * D;
  const int row = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = row < n;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f32(q[head_off + static_cast<int64_t>(row) * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < n; k0 += TK) {
    const int nk = min(TK, n - k0);
    const T* kp = k + head_off + static_cast<int64_t>(k0) * D;
    const T* vp = v + head_off + static_cast<int64_t>(k0) * D;
    for (int idx = threadIdx.x; idx < TK * D; idx += blockDim.x) {
      const bool valid = idx < nk * D;
      ks[idx / D][idx % D] = valid ? to_f32(kp[idx]) : 0.f;
      vs[idx / D][idx % D] = valid ? to_f32(vp[idx]) : 0.f;
    }
    __syncthreads();
    if (active) {
      float s[TK];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += qr[d] * ks[j][d];
        s[j] = j < nk ? dot * scale : -INFINITY;
        tile_max = fmaxf(tile_max, s[j]);
      }
      const float m_new = fmaxf(m, tile_max);
      const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = expf(s[j] - m_new);  // 0 for rows past N
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += p * vs[j][d];
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (active) {
    T* op = o + head_off + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] / l);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, long long bh, int n, float scale,
            cudaStream_t stream) {
  const int threads = n <= 32 ? 32 : (n <= 64 ? 64 : 128);
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((n + threads - 1) / threads));
  mha_fwd_kernel<T, D><<<grid, threads, 0, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                     static_cast<const T*>(v), static_cast<T*>(o), n, scale);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, long long bh, int n, int d, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 8: launch<T, 8>(q, k, v, o, bh, n, scale, stream); break;
    case 16: launch<T, 16>(q, k, v, o, bh, n, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, o, bh, n, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, o, bh, n, scale, stream); break;
    case 128: launch<T, 128>(q, k, v, o, bh, n, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: 0 -> float32 tensors, 1 -> bfloat16 tensors. Returns cudaGetLastError().
extern "C" int adt_mha_fwd(const void* q, const void* k, const void* v, void* o, int is_bf16, long long bh, int n,
                           int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(q, k, v, o, bh, n, d, scale, s);
  return dispatch<float>(q, k, v, o, bh, n, d, scale, s);
}
