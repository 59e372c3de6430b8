// Many-small-heads multi-head attention forward: o = softmax(q k^T / sqrt(d)) v
// per head, scores, max and sum in f32, o in q's dtype.
//
// Replaces the Pallas body _attn_kernel of
// audio_diffusion_tpu/ops/pallas_attention.py:55-70 (reached through
// _flash_mha_fwd at :90).
//
// Layouts: q, k and v are (B, heads, N, d) views whose last dimension has
// stride 1; all three share the batch, head and row strides (sb, sh, sn), so
// the (B, N, heads, d) projections of the UNet are read where they lie. o is
// written as a contiguous (B, N, heads, d) buffer, which the wrapper returns
// as a (B, heads, N, d) view.
//
// What bounds it on Hopper, at the UNet's d = 8 and 64 heads:
// * N <= 16 (the latent UNets): bytes, far below the launch floor, so the
//   only aim is a launch that does nothing else: the `small` route.
// * N >= 256 (the pixel UNets): the B*h*N^2 exponentials. The special-function
//   unit does 16 ex2 per clock per SM, 4.2e12/s on a 132-SM card at 1.98 GHz:
//   0.51 ms at (32, 64, 1024, 8), against 0.07 ms of bf16 tensor work. So the
//   `mma` route gives the tensor cores both products and the row sums, and
//   leaves per score an FFMA, a max, the ex2 and half a bf16 pack, so that
//   the special-function unit stays busy. wgmma is not used: its bf16 depth
//   of 16 would pad half of Q K^T with zeros, and the tensor cores are not
//   the limit here; mma.sync m16n8k8 takes d = 8 as it is.
//
// Routes, picked from (N, d, dtype) alone by ops/attention.py::attention_plan
// (never from B, so a row's result does not depend on the batch around it):
//   small  N <= kSmallMaxN, d <= 32: up to 4 lanes per query row (N rounded
//          up to a power of two), 256 lanes per CTA across many (b, h). Each
//          lane runs an online softmax over every 4th key, to N at runtime;
//          the row's lanes merge by shuffles. Rows read with 16-byte loads
//          straight from device memory; no shared memory, no barrier.
//   mma    bf16, d = 8, N > kSmallMaxN: one CTA of 4 or 8 warps per (b, h).
//          K and V are staged in shared memory with cp.async, one 16-byte
//          copy per key row: the whole head when it fits (N <= kResidentKeys),
//          else chunks of kChunkKeys through a double buffer. Each warp walks
//          16-row query tiles; S = Q K^T by mma m16n8k8, P V by mma m16n8k16,
//          whose bf16 A fragment is two S accumulator tiles (the m16n8 C
//          layout is the A layout), and the row sums by the same P times a
//          ones matrix. Online softmax in f32 registers over blocks of 64
//          keys: the row max goes across the row's 4 lanes by shuffles once
//          per block; the rescale factors run on the FMA pipe (ex2_fma). P is
//          rounded to bf16 before P V, as reference_attention rounds p to q's
//          dtype.
//   simt   f32 at N > kSmallMaxN, bf16 with d != 8, and d >= 64: one thread per
//          query row, keys and values staged through shared memory in tiles;
//          exact f32 (no TF32), the last tile runs only to its valid keys.
// The scores' exponentials are ex2.approx with scale*log2(e) folded into one
// FFMA per score (what exp2f becomes under fast math; relative error ~2^-22).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kSmallMaxN = 16;     // attention.SMALL_MAX_N
constexpr int kSmallThreads = 256;  // attention.SMALL_THREADS
constexpr int kKeyBlock = 64;      // keys per online-softmax step of the mma route
constexpr int kResidentKeys = 2048;  // attention.MMA_RESIDENT_KEYS
constexpr int kChunkKeys = 1024;     // attention.MMA_CHUNK_KEYS
constexpr int kMmaMaxThreads = 256;  // the mma kernel's launch bound: attention.MMA_WARPS <= 8
constexpr int kMmaSmem = 4 * kChunkKeys * 16;  // the most either staging uses: 64 KB
static_assert(2 * kResidentKeys * 16 <= kMmaSmem, "resident K and V must fit the shared-memory attribute");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x for x <= 0 on the FMA pipe, off the special-function unit: x = j + f
// with j = rint(x) and |f| <= 1/2; 2^f from a cubic that is exact at f = 0
// (relative error 1.0e-4), 2^j written into the exponent bits. x at or below
// -127 (and -inf) gives +0; x = 0 gives exactly 1.
__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -127.f);
  const float r = x + 12582912.f;  // 1.5 * 2^23: x rounded to an integer, held in r's low mantissa bits
  const float f = x - (r - 12582912.f);
  const float p = fmaf(f, fmaf(fmaf(0.055007938f, f, 0.24220875f), f, 0.69328278f), 1.f);
  return p * __int_as_float((__float_as_int(r) << 23) + (127 << 23));
}

// D values of one row into f32 registers: 16-byte loads when `vec` (row
// address 16-byte aligned and D * sizeof(T) a multiple of 16), else scalar.
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int vec, float (&r)[D]) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (vec && D % V == 0) {
#pragma unroll
    for (int i = 0; i < D; i += V) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + i));
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) r[i + j] = to_f32(e[j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) r[i] = to_f32(p[i]);
  }
}

// D values of one row from f32 registers, with 16-byte stores when they fit
// (o is a fresh, aligned allocation, rows D * sizeof(T) bytes apart).
template <typename T, int D>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&r)[D], float inv) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (D % V == 0) {
#pragma unroll
    for (int i = 0; i < D; i += V) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = from_f32<T>(r[i + j] * inv);
      *reinterpret_cast<uint4*>(p + i) = u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) p[i] = from_f32<T>(r[i] * inv);
  }
}

// ---------------------------------------------------------------- small route
// grid ceil(B*h*N << log_split / kSmallThreads), block kSmallThreads. Query
// row r (of all B*h*N) belongs to the split = 2^log_split lanes from
// r << log_split (N rounded up to a power of two, at most
// attention.SMALL_MAX_SPLIT): lane `part` folds in keys part, part + split,
// ... with an online softmax, then the lanes of a row merge by shuffles in a
// fixed order. c = scale * log2(e).
template <typename T, int D>
__global__ void __launch_bounds__(kSmallThreads) mha_small_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                                  const T* __restrict__ v, T* __restrict__ o,
                                                                  long long rows, int heads, long long sb,
                                                                  long long sh, long long sn, int n, int log_split,
                                                                  float c, int vec) {
  const int split = 1 << log_split;
  const long long r = (static_cast<long long>(blockIdx.x) * kSmallThreads + threadIdx.x) >> log_split;
  const int part = threadIdx.x & (split - 1);
  const bool live = r < rows;  // no early return: every lane takes part in the shuffles
  const long long bh = live ? r / n : 0;
  const int row = static_cast<int>(r - bh * n);
  const long long b = bh / heads;
  const int hh = static_cast<int>(bh - b * heads);
  const long long head = b * sb + hh * sh;
  float qr[D], kr[D], vr[D], acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  if (live) {
    load_row<T, D>(q + head + row * sn, vec, qr);
#pragma unroll
    for (int i = 0; i < D; ++i) qr[i] *= c;  // scores in log2 units: one FMUL per q value, not one per score
    for (int j = part; j < n; j += split) {
      load_row<T, D>(k + head + j * sn, vec, kr);
      load_row<T, D>(v + head + j * sn, vec, vr);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) s = fmaf(qr[i], kr[i], s);
      // One exponential per key; a new maximum gets weight exactly 1.
      if (s > m) {
        const float corr = ex2(m - s);  // 0 at the lane's first key (m = -inf)
        l = fmaf(l, corr, 1.f);
#pragma unroll
        for (int i = 0; i < D; ++i) acc[i] = fmaf(acc[i], corr, vr[i]);
        m = s;
      } else {
        const float p = ex2(s - m);
        l += p;
#pragma unroll
        for (int i = 0; i < D; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
      }
    }
  }
  // Merge the row's lanes. The lane holding the row max keeps weight exactly
  // 1 and a lane without keys gets 0, so one key (N = 1) gives o == v bit for bit.
  float mx = m;
  for (int off = 1; off < split; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float w = m == mx ? 1.f : ex2(m - mx);
  l *= w;
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] *= w;
  for (int off = 1; off < split; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (live && part == 0) store_row<T, D>(o + ((b * n + row) * heads + hh) * D, acc, 1.f / l);
}

// ----------------------------------------------------------------- simt route
template <int D>
struct KeyTile {
  // Keys per shared-memory tile: the per-thread score array s[TK] and the
  // q/accumulator registers (2*D) share the register file.
  static constexpr int TK = D <= 32 ? 32 : (D == 64 ? 16 : 8);
};

// grid (B*heads, ceil(N / blockDim.x)), blockDim.x in {32, 64, 128}.
template <typename T, int D>
__global__ void mha_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                T* __restrict__ o, int heads, long long sb, long long sh, long long sn, int n,
                                float c, int vec) {
  constexpr int TK = KeyTile<D>::TK;
  __shared__ float ks[TK][D];
  __shared__ float vs[TK][D];

  const long long bh = blockIdx.x;
  const long long b = bh / heads;
  const int hh = static_cast<int>(bh - b * heads);
  const long long head = b * sb + hh * sh;
  const int row = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = row < n;

  float qr[D], acc[D];
  if (active) load_row<T, D>(q + head + row * sn, vec, qr);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = active ? qr[i] * c : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < n; k0 += TK) {
    const int nk = min(TK, n - k0);
    for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
      const long long off = head + (k0 + idx / D) * sn + idx % D;
      ks[idx / D][idx % D] = to_f32(k[off]);
      vs[idx / D][idx % D] = to_f32(v[off]);
    }
    __syncthreads();
    if (active) {
      float s[TK];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        if (j < nk) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < D; ++i) dot = fmaf(qr[i], ks[j][i], dot);
          s[j] = dot;
          tile_max = fmaxf(tile_max, dot);
        }
      }
      const float m_new = fmaxf(m, tile_max);
      const float corr = ex2(m - m_new);  // 0 on the first tile (m = -inf)
      l *= corr;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        if (j < nk) {
          const float p = ex2(s[j] - m_new);
          l += p;
#pragma unroll
          for (int i = 0; i < D; ++i) acc[i] = fmaf(p, vs[j][i], acc[i]);
        }
      }
      m = m_new;
    }
    __syncthreads();
  }
  if (active) store_row<T, D>(o + ((b * n + row) * heads + hh) * D, acc, 1.f / l);
}

// ------------------------------------------------------------------ mma route
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// d = a b, a 16x8 (row), b 8x8 (col), bf16 in, f32 out.
__device__ __forceinline__ void mma_16x8x8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.f));
}

// acc += a b, a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulator.
__device__ __forceinline__ void mma_16x8x16(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

constexpr uint32_t kOnesBf16x2 = 0x3F803F80u;  // (1, 1) in bf16: the B operand that sums P's rows

// Rows [c0, c0 + chunk) of K and V into shared memory, 16 bytes (one d = 8
// row) per copy; rows at or past n are zero so that padding never meets a NaN.
__device__ __forceinline__ void stage_kv(uint4* __restrict__ ks, uint4* __restrict__ vs, const bf16* __restrict__ kh,
                                         const bf16* __restrict__ vh, long long sn, int c0, int chunk, int n,
                                         int vec) {
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const int key = c0 + i;
    if (key >= n) {
      ks[i] = make_uint4(0, 0, 0, 0);
      vs[i] = make_uint4(0, 0, 0, 0);
    } else if (vec) {
      cp_async16(ks + i, kh + key * sn);
      cp_async16(vs + i, vh + key * sn);
    } else {
      uint4 a, b;
      bf16* ea = reinterpret_cast<bf16*>(&a);
      bf16* eb = reinterpret_cast<bf16*>(&b);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ea[j] = kh[key * sn + j];
        eb[j] = vh[key * sn + j];
      }
      ks[i] = a;
      vs[i] = b;
    }
  }
}

// Per-warp state of one 16-row query tile; lane (g = lane / 4, t = lane % 4)
// holds rows g and g + 8, key/dim columns 2t and 2t + 1 of each fragment.
struct TileState {
  uint32_t qa0, qa1;  // Q fragment: rows g, g + 8; dims 2t, 2t + 1
  float acc[4];       // O: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  float l[4];         // P times ones: the row sums, rows g (0, 1) and g + 8 (2, 3)
  float m0, m1;       // running row max, raw score units
};

// One block of 64 keys starting at row kb of the staged K and V. MASK: keys
// at or past `valid` (relative to kb) are left out. P = 2^(s*c - m*c) in f32
// on the special-function unit, rounded to bf16 once; the tensor cores take
// both P V and the row sums (P times a ones matrix), so the sums are of the
// same bf16 P and cost no FP32 add per score.
template <bool MASK>
__device__ __forceinline__ void mma_block(TileState& st, const uint4* __restrict__ ks, const uint4* __restrict__ vs,
                                          int kb, int valid, float c, int lane) {
  const int t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; j += 4) {
    uint32_t kf[4];
    ldmatrix_x4(kf, ks + kb + j * 8 + lane);  // keys kb + 8j .. kb + 8j + 31
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) mma_16x8x8(s[j + jj], st.qa0, st.qa1, kf[jj]);
  }
  if (MASK) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = j * 8 + 2 * t;
      if (key >= valid) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= valid) s[j][1] = s[j][3] = -INFINITY;
    }
  }
  float mx0 = st.m0, mx1 = st.m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // The rescale factors on the FMA pipe: the special-function unit is kept
  // for the scores. 0 on the first block, exactly 1 while the max holds.
  const float corr0 = ex2_fma((st.m0 - mx0) * c), corr1 = ex2_fma((st.m1 - mx1) * c);
  st.m0 = mx0;
  st.m1 = mx1;
  const float mc0 = mx0 * c, mc1 = mx1 * c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.acc[i] *= i < 2 ? corr0 : corr1;
    st.l[i] *= i < 2 ? corr0 : corr1;
  }
  uint32_t pa[8][2];  // P as bf16 pairs: tile j, rows g (0) and g + 8 (1)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j][0] = pack_bf16(ex2(fmaf(s[j][0], c, -mc0)), ex2(fmaf(s[j][1], c, -mc0)));
    pa[j][1] = pack_bf16(ex2(fmaf(s[j][2], c, -mc1)), ex2(fmaf(s[j][3], c, -mc1)));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t vf[4];
    ldmatrix_x4_trans(vf, vs + kb + h * 32 + lane);  // keys kb + 32h .. kb + 32h + 31, transposed
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int j = 4 * h + 2 * kk;  // S tiles j, j + 1 are the 16 keys of this product
      const uint32_t a[4] = {pa[j][0], pa[j][1], pa[j + 1][0], pa[j + 1][1]};
      mma_16x8x16(st.acc, a, vf[2 * kk], vf[2 * kk + 1]);
      mma_16x8x16(st.l, a, kOnesBf16x2, kOnesBf16x2);
    }
  }
}

// Q fragment of query rows row0 .. row0 + 15 of one head (rows past n read as 0), empty state.
__device__ __forceinline__ void tile_begin(TileState& st, const bf16* __restrict__ qh, long long sn, int row0, int n,
                                           int vec, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
  const bf16* p0 = qh + r0 * sn + 2 * t;
  const bf16* p1 = qh + r1 * sn + 2 * t;
  if (vec) {
    st.qa0 = r0 < n ? __ldg(reinterpret_cast<const unsigned*>(p0)) : 0u;
    st.qa1 = r1 < n ? __ldg(reinterpret_cast<const unsigned*>(p1)) : 0u;
  } else {
    st.qa0 = r0 < n ? pack_bf16(__bfloat162float(p0[0]), __bfloat162float(p0[1])) : 0u;
    st.qa1 = r1 < n ? pack_bf16(__bfloat162float(p1[0]), __bfloat162float(p1[1])) : 0u;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) st.acc[i] = st.l[i] = 0.f;
  st.m0 = st.m1 = -INFINITY;
}

// Keys [0, nk) of the staged K and V, in blocks of kKeyBlock; the last one masked.
__device__ __forceinline__ void tile_keys(TileState& st, const uint4* __restrict__ ks, const uint4* __restrict__ vs,
                                          int nk, float c, int lane) {
  int kb = 0;
  for (; kb + kKeyBlock <= nk; kb += kKeyBlock) mma_block<false>(st, ks, vs, kb, kKeyBlock, c, lane);
  if (kb < nk) mma_block<true>(st, ks, vs, kb, nk - kb, c, lane);
}

// o rows row0 .. row0 + 15 (those below n) of head (b, hh) in the (B, N, heads, 8) output.
__device__ __forceinline__ void tile_end(const TileState& st, bf16* __restrict__ o, long long b, int n, int heads,
                                        int hh, int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float inv0 = 1.f / st.l[0], inv1 = 1.f / st.l[2];
  const int r0 = row0 + g, r1 = row0 + g + 8;
  if (r0 < n)
    *reinterpret_cast<__nv_bfloat162*>(o + ((b * n + r0) * heads + hh) * 8 + 2 * t) =
        __floats2bfloat162_rn(st.acc[0] * inv0, st.acc[1] * inv0);
  if (r1 < n)
    *reinterpret_cast<__nv_bfloat162*>(o + ((b * n + r1) * heads + hh) * 8 + 2 * t) =
        __floats2bfloat162_rn(st.acc[2] * inv1, st.acc[3] * inv1);
}

// grid B*heads: one CTA per (b, h), its warps walking the head's 16-row query
// tiles. `chunk` keys are staged per pass: the whole head rounded up to
// kKeyBlock (resident: K and V read from device memory once per head), or
// kChunkKeys streamed through two buffers, the next piece (of this pass or
// the next) in flight while this one is used. Dynamic shared memory: 2 *
// chunk rows resident, 4 * chunk streamed.
__global__ void __launch_bounds__(kMmaMaxThreads) mha_mma_kernel(const bf16* __restrict__ q,
                                                                 const bf16* __restrict__ k,
                                                                 const bf16* __restrict__ v, bf16* __restrict__ o,
                                                                 int heads, long long sb, long long sh, long long sn,
                                                                 int n, int chunk, float c, int vec) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / heads;
  const int hh = static_cast<int>(blockIdx.x - b * heads);
  const long long head = b * sb + hh * sh;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const int nchunks = (n + chunk - 1) / chunk;
  const int rows_per_pass = (blockDim.x >> 5) * 16;
  const int passes = (n + rows_per_pass - 1) / rows_per_pass;

  stage_kv(smem, smem + chunk, kh, vh, sn, 0, chunk, n, vec);
  cp_async_commit();
  if (nchunks == 1) {  // resident: K and V stay for every query tile
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int pass = 0; pass < passes; ++pass) {
    const int row0 = pass * rows_per_pass + warp * 16;
    TileState st;
    tile_begin(st, q + head, sn, row0, n, vec, lane);
    if (nchunks == 1) {
      if (row0 < n) tile_keys(st, smem, smem + chunk, n, c, lane);  // warp-uniform
    } else {
      for (int ci = 0; ci < nchunks; ++ci) {
        // Stage s = pass * nchunks + ci sits in buffer s % 2; prefetch stage
        // s + 1 (the next chunk, or chunk 0 of the next pass) into the other.
        const int s = pass * nchunks + ci;
        if (s + 1 < passes * nchunks) {
          uint4* nb = smem + ((s + 1) & 1) * 2 * chunk;
          stage_kv(nb, nb + chunk, kh, vh, sn, ((ci + 1) % nchunks) * chunk, chunk, n, vec);
        }
        cp_async_commit();
        cp_async_wait<1>();  // stage s has landed
        __syncthreads();
        const uint4* ks = smem + (s & 1) * 2 * chunk;
        if (row0 < n) tile_keys(st, ks, ks + chunk, min(chunk, n - ci * chunk), c, lane);
        __syncthreads();  // every warp is done with this buffer before it is refilled
      }
    }
    if (row0 < n) tile_end(st, o, b, n, heads, hh, row0, lane);
  }
}

}  // namespace

// One launch plan, field for field attention._CPlan: made once per
// (N, d, dtype) on the host and passed by pointer.
struct MhaPlan {
  int route;    // 0 small, 1 mma, 2 simt
  int is_bf16;  // 0: float32 q, k, v and o; 1: bfloat16
  int n, d;
  int threads;  // threads per CTA
  int log_split;  // small: log2 of the lanes per query row
  int chunk;    // mma: keys staged per pass
  int smem;     // mma: dynamic shared memory bytes
  float c;      // softmax scale * log2(e)
};

namespace {

template <typename T, int D>
void launch_small(const void* q, const void* k, const void* v, void* o, long long bhc, int heads, long long sb,
                  long long sh, long long sn, int vec, const MhaPlan& p, cudaStream_t stream) {
  const long long rows = bhc * p.n;
  const unsigned grid = static_cast<unsigned>(((rows << p.log_split) + kSmallThreads - 1) / kSmallThreads);
  mha_small_kernel<T, D><<<grid, kSmallThreads, 0, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                             static_cast<const T*>(v), static_cast<T*>(o), rows,
                                                             heads, sb, sh, sn, p.n, p.log_split, p.c, vec);
}

template <typename T, int D>
void launch_simt(const void* q, const void* k, const void* v, void* o, long long bhc, int heads, long long sb,
                 long long sh, long long sn, int vec, const MhaPlan& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(bhc), static_cast<unsigned>((p.n + p.threads - 1) / p.threads));
  mha_simt_kernel<T, D><<<grid, p.threads, 0, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                        static_cast<const T*>(v), static_cast<T*>(o), heads, sb, sh,
                                                        sn, p.n, p.c, vec);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o, long long bhc, int heads, long long sb,
                 long long sh, long long sn, int vec, const MhaPlan& p, cudaStream_t s) {
  if (p.route == 0) {
    switch (p.d) {
      case 8: launch_small<T, 8>(q, k, v, o, bhc, heads, sb, sh, sn, vec, p, s); return 0;
      case 16: launch_small<T, 16>(q, k, v, o, bhc, heads, sb, sh, sn, vec, p, s); return 0;
      case 32: launch_small<T, 32>(q, k, v, o, bhc, heads, sb, sh, sn, vec, p, s); return 0;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (p.d) {  // simt; bf16 at d = 8 above kSmallMaxN takes the mma route instead
    case 8:
      if (sizeof(T) != 4) return static_cast<int>(cudaErrorInvalidValue);
      launch_simt<float, 8>(q, k, v, o, bhc, heads, sb, sh, sn, vec, p, s);
      return 0;
    case 16: launch_simt<T, 16>(q, k, v, o, bhc, heads, sb, sh, sn, vec, p, s); return 0;
    case 32: launch_simt<T, 32>(q, k, v, o, bhc, heads, sb, sh, sn, vec, p, s); return 0;
    case 64: launch_simt<T, 64>(q, k, v, o, bhc, heads, sb, sh, sn, vec, p, s); return 0;
    case 128: launch_simt<T, 128>(q, k, v, o, bhc, heads, sb, sh, sn, vec, p, s); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Once per process, before any launch: the mma route's dynamic shared memory
// (up to 64 KB). Returns a cudaError_t.
extern "C" int adt_mha_init() {
  return static_cast<int>(
      cudaFuncSetAttribute(mha_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem));
}

// args: q, k, v, o (device pointers), B * heads, heads, then the element
// strides (sb, sh, sn) that q, k and v share, then vec (1: every row of q, k
// and v starts on a 16-byte boundary). o is a contiguous (B, N, heads, d)
// buffer. The wrapper fills `args` in place and calls with the GIL held, so
// no other thread refills them mid-call. One launch on `stream`; returns
// cudaGetLastError().
extern "C" int adt_mha_fwd(const long long* args, const MhaPlan* plan, void* stream) {
  const void* q = reinterpret_cast<const void*>(args[0]);
  const void* k = reinterpret_cast<const void*>(args[1]);
  const void* v = reinterpret_cast<const void*>(args[2]);
  void* o = reinterpret_cast<void*>(args[3]);
  const long long bhc = args[4], sb = args[6], sh = args[7], sn = args[8];
  const int heads = static_cast<int>(args[5]), vec = static_cast<int>(args[9]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MhaPlan& p = *plan;
  int code = 0;
  if (p.route == 1) {
    if (!p.is_bf16 || p.d != 8 || p.smem > kMmaSmem) return static_cast<int>(cudaErrorInvalidValue);
    mha_mma_kernel<<<static_cast<unsigned>(bhc), p.threads, p.smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), heads, sb, sh, sn, p.n, p.chunk, p.c, vec);
  } else if (p.is_bf16) {
    code = launch_typed<bf16>(q, k, v, o, bhc, heads, sb, sh, sn, vec, p, s);
  } else {
    code = launch_typed<float>(q, k, v, o, bhc, heads, sb, sh, sn, vec, p, s);
  }
  if (code) return code;
  return static_cast<int>(cudaGetLastError());
}
