// Batch-invariant bf16 convolution: an implicit GEMM over contiguous NCHW
// activations, f32 weights rounded to bf16 as they are loaded, f32
// accumulation, one rounding of the output to bf16.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA. It
// exists for the serving contract (utils/batch_invariant.py): inside the
// batcher's window a row's result must not depend on the batch around it.
// cuDNN picks other kernels for other batch sizes, and PyTorch's own
// convolution with cuDNN off loops over the rows (one im2col and one GEMM a
// row). This kernel takes every bf16 convolution of a served batch in one
// launch whose tiling never depends on the batch.
//
// The GEMM: M = B*Ho*Wo output pixels, N = Cout, K = Cin*kh*kw, for kernel
// sizes 1 and 3, strides 1 and 2, any padding.
//
// What bounds it on Hopper, by class (the tile choice is
// ops/batch_invariant_conv2d.py::conv_plan):
// * large levels (Ho*Wo >= 1024: the UNets' first levels, every VAE level):
//   tensor-core operations, 2*M*N*K at 989 TFLOP/s dense bf16; this kernel
//   runs on mma.sync, which reaches part of that rate.
// * middle and small levels (Ho*Wo 256 down to 1, M = 8-512 rows at the
//   served tiers, K up to 9,216): the f32 weights' bytes, Cout*Cin*kh*kw*4
//   read once per M tile at 3.35 TB/s. Narrow N tiles and a split of K over
//   a cluster of up to 8 CTAs put more than 100 SMs on the weights.
// Where it stands (PERF.md §6): the large tiles reach about a tenth of their
// bound, their phases between barriers not overlapping with one CTA an SM;
// the small levels sit on a latency floor of ~14 us a call (launch,
// prologue, the cluster's reduction), several times their bytes' time.
//
// Design:
// * Tiles: 256 x 64 with 16 warps at the large levels (128 x 64 with 8 where
//   the patch is too wide for the former's loads, as at stride 2), 64 x 64
//   and 32 x 32 with 4 warps below.
// * A CTA computes a BM x BN tile of the output. Its BM pixels are `rows`
//   whole output rows of `seg` = Wo columns (Wo < BM) or one segment of `seg`
//   = BM columns of one row (Wo >= BM); a tile may hold rows of several
//   images, since an element's sum never reads its neighbours in M.
// * K runs in chunks of 16 input channels and all nine taps (3x3 kernels)
//   or of 64 channels (1x1 kernels). Per chunk the CTA stages:
//   - the input patch its pixels read, kh input rows of `patch_w` pixels for
//     each output row, transposed from NCHW to pixel-major (16 channels, 32
//     bytes a pixel and k-step) through registers, with zeros for the
//     padding. The loads for chunk i+2 are predicated loads started before
//     the product of chunk i, so nothing waits for them until they are
//     stored;
//   - the weights of the chunk as stored, [n][c][tap] f32, copied with
//     cp.async two chunks ahead (three staging slots), then rounded to bf16
//     (round to nearest even, bitwise torch's .to(torch.bfloat16)) into
//     [k-step][tap][n][16 channels].
//   Every tap of the chunk then reads its A fragments from the one patch by
//   ldmatrix with a row address per lane (the pixel shifted by the tap), and
//   its B fragments from that tap's weights: mma.sync m16n8k16, bf16 in, f32
//   accumulators. Both tiles swizzle their two 16-byte halves so that eight
//   consecutive rows hit distinct banks. One barrier per chunk.
// * Batch invariance by construction: the tile shape, the split of K and
//   everything else of the launch but its grid's extent come from (Cin, Cout,
//   Ho, Wo, kh, kw, stride) alone. Each output element sums its K in one
//   fixed order: the chunks in order; within a chunk its k-steps of 16
//   channels in order and, within each, the taps in order; 16 channels per
//   mma. With a split (`splits` CTAs of a cluster, each a
//   contiguous range of the chunks) the partial tiles meet in distributed
//   shared memory and are added in rank order. No atomics.
// * Epilogue: the partial sums go through shared memory so that threads
//   write consecutive pixels of one channel (a thread keeps one pixel and
//   walks the channels); the bias, rounded to bf16 as
//   the module casts it, is added in f32 before the single rounding.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// One launch plan, field for field ops/batch_invariant_conv2d.py::_CPlan:
// made once per (Cin, Cout, Ho, Wo, kh, kw, stride) and passed by pointer.
struct ConvPlan {
  int config;  // tile: 0 = 256 x 64 (16 warps), 1 = 64 x 64 (4 warps), 2 = 32 x 32 (4 warps), 3 = 128 x 64 (8 warps)
  int cin, cout, ho, wo, kh, kw, stride;
  int splits;        // CTAs of a cluster, each summing a contiguous range of the K chunks
  int rows;          // output rows of an M tile
  int seg;           // output columns of each of them
  int segs;          // M tiles across one output row: ceil(wo / seg)
  int patch_w;       // input pixels per patch row: (seg - 1) * stride + kw
  int patch_pixels;  // rows * kh * patch_w
  int chunks;        // K chunks: ceil(cin / 16) for 3x3 kernels, ceil(cin / 64) for 1x1
  int smem;          // dynamic shared memory bytes
};

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSub = 16;              // input channels per mma k-step
constexpr int kStages = 3;            // weight chunks in flight: staged with cp.async two chunks ahead
constexpr int kMaxSmem = 227 * 1024;  // the card's limit for one CTA

// k-steps of 16 channels per K chunk: one for 3x3 kernels (nine taps a
// chunk), four for 1x1 kernels, so that every chunk carries enough products
// to pay for its barrier.
template <int T>
struct Chunk {
  static constexpr int kSteps = T == 1 ? 4 : 1;
  static constexpr int kChannels = kSub * kSteps;
};

struct Args {
  const bf16* x;
  const float* w;
  const float* bias;  // null: no bias
  bf16* y;
  int out_rows;  // B * Ho
  int h, w_in, pad;
  int wvec;  // the weights take 16-byte copies: cin % 4 == 0 and w 16-byte aligned
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, of which the first `bytes` are read from src and the rest zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// *p, or 0 where !ok: a predicated load into a zeroed register, so nothing
// waits for the value until it is used (a select after the load would).
__device__ __forceinline__ unsigned short ldg_u16(const unsigned short* p, bool ok) {
  unsigned short v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b16 %0, 0;\n @q ld.global.nc.b16 %0, [%1];\n}\n"
      : "=h"(v)
      : "l"(p), "r"(static_cast<int>(ok)));
  return v;
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
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

// The 16-byte slot of half `half` (channels 8*half .. 8*half + 7) of row
// `row` in a tile of 32-byte rows: the halves swap every four rows, so the
// rows of one ldmatrix matrix fall in distinct banks.
__device__ __forceinline__ int half_slot(int row, int half) { return row * 2 + (half ^ ((row >> 2) & 1)); }

// ops/batch_invariant_conv2d.py::_smem computes the same sizes.
template <int BM, int BN, int T>
struct Layout {
  static constexpr int kStageFloats = BN * Chunk<T>::kChannels * T;  // one chunk's weights, f32 as stored
  static constexpr int kLdc = BM + 4;                                // the partial tile's row stride (floats)
  static constexpr int kRegion0 =                                    // weight staging, later the partial tile
      kStages * kStageFloats * 4 > BN * kLdc * 4 ? kStages * kStageFloats * 4 : BN * kLdc * 4;
  static constexpr int kBsBytes = 2 * Chunk<T>::kSteps * T * BN * 32;  // two buffers of [step][tap][n][16] bf16
  static int smem(int patch_pixels) { return kRegion0 + kBsBytes + 2 * Chunk<T>::kSteps * patch_pixels * 32; }
};

// Grid (M tiles * splits, ceil(cout / BN)); clusters of `splits` CTAs along x. UNITS: the patch loads (8
// channels of one pixel) a thread makes per chunk at most.
template <int BM, int BN, int WARPS_M, int WARPS_N, int T, int UNITS>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32) bi_conv2d_kernel(const Args a, const ConvPlan p) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MF = WTM / 16, NF = WTN / 8;
  constexpr int KW = T == 9 ? 3 : 1;
  constexpr int KS = Chunk<T>::kSteps, CC = Chunk<T>::kChannels;
  using L = Layout<BM, BN, T>;
  static_assert(MF >= 1 && NF >= 2 && NF % 2 == 0 && kThreads % BM == 0, "tile");

  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  uint4* bs = reinterpret_cast<uint4*>(smem + L::kRegion0);
  uint4* as = reinterpret_cast<uint4*>(smem + L::kRegion0 + L::kBsBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int splits = p.splits;
  const int rank = static_cast<int>(blockIdx.x % splits);
  const int mtile = static_cast<int>(blockIdx.x) / splits;
  const int row0 = mtile / p.segs * p.rows;  // first output row (b * Ho + oh) of the tile
  const int col0 = static_cast<int>(mtile % p.segs) * p.seg;
  const int n0 = blockIdx.y * BN;
  const int kbeg = rank * p.chunks / splits, nk = (rank + 1) * p.chunks / splits - kbeg;
  const long long hw = static_cast<long long>(a.h) * a.w_in;
  const int npix = p.patch_pixels;

  // ---- the patch: unit u of a chunk is 8 channels (group u / npix) of patch pixel u % npix
  long long uoff[UNITS];  // element offset of the unit's first channel at chunk 0; -1: padding (zeros)
  int ulim[UNITS];        // channels of the unit before cin, counted from its first at chunk 0
  int udst[UNITS];        // its 16-byte slot in a patch buffer; -1: no unit
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int u = tid + k * kThreads;
    uoff[k] = -1;
    ulim[k] = 0;
    udst[k] = -1;
    if (u < 2 * KS * npix) {
      const int g8 = u / npix, px = u - g8 * npix;
      const int jr = px / p.patch_w, c = px - jr * p.patch_w;
      const int j = jr / p.kh, r = jr - j * p.kh;
      const int orow = row0 + j;
      udst[k] = half_slot((g8 >> 1) * npix + px, g8 & 1);
      ulim[k] = p.cin - 8 * g8;
      if (j < p.rows && orow < a.out_rows) {
        const int b = orow / p.ho, oh = orow - b * p.ho;
        const int ih = oh * p.stride - a.pad + r, iw = col0 * p.stride - a.pad + c;
        if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.w_in)
          uoff[k] = (static_cast<long long>(b) * p.cin + 8 * g8) * hw + static_cast<long long>(ih) * a.w_in +
                    iw;
      }
    }
  }
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(a.x);
  unsigned short raw[UNITS][8];  // the next chunk's patch, as loaded (packed when stored)

  auto load_patch = [&](int chunk) {
    const int c0 = chunk * CC;
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const unsigned short* up = xs + (uoff[k] + c0 * hw);
      const bool ok = uoff[k] >= 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) raw[k][i] = ldg_u16(up + i * hw, ok && c0 + i < ulim[k]);
    }
  };
  auto store_patch = [&](int buf) {
    uint4* dst = as + buf * KS * npix * 2;
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      if (udst[k] >= 0) {
        uint4 v;
        v.x = raw[k][0] | (static_cast<uint32_t>(raw[k][1]) << 16);
        v.y = raw[k][2] | (static_cast<uint32_t>(raw[k][3]) << 16);
        v.z = raw[k][4] | (static_cast<uint32_t>(raw[k][5]) << 16);
        v.w = raw[k][6] | (static_cast<uint32_t>(raw[k][7]) << 16);
        dst[udst[k]] = v;
      }
    }
  };

  // ---- the weights: chunk `chunk` of rows n0 .. n0 + BN into staging slot `slot`, zeros past cin and cout
  auto fetch_weights = [&](int chunk, int slot) {
    const int c0 = chunk * CC;
    const int valid = min(CC, p.cin - c0) * T;  // floats of a row in this chunk
    float* dst = stage + slot * L::kStageFloats;
    if (a.wvec) {
      for (int e = tid; e < BN * CC * T / 4; e += kThreads) {
        const int nl = e / (CC * T / 4), j = e - nl * (CC * T / 4), n = n0 + nl;
        const int bytes = n < p.cout ? 4 * max(0, min(4, valid - 4 * j)) : 0;
        const float* src = bytes ? a.w + (static_cast<long long>(n) * p.cin + c0) * T + 4 * j : a.w;
        cp_async16(dst + nl * CC * T + 4 * j, src, bytes);
      }
    } else {
      for (int e = tid; e < BN * CC * T; e += kThreads) {
        const int nl = e / (CC * T), j = e - nl * CC * T, n = n0 + nl;
        const int bytes = n < p.cout && j < valid ? 4 : 0;
        const float* src = bytes ? a.w + (static_cast<long long>(n) * p.cin + c0) * T + j : a.w;
        cp_async4(dst + e, src, bytes);
      }
    }
  };
  // Staged [n][c][tap] f32 to [step][tap][n][16 channels] bf16, rounded to nearest even.
  auto convert_weights = [&](int slot, int buf) {
    const float* src = stage + slot * L::kStageFloats;
    uint4* dst = bs + buf * KS * T * BN * 2;
    for (int q = tid; q < BN * KS * T; q += kThreads) {
      const int nl = q / (KS * T), st = q - nl * KS * T;  // st = step * T + tap
      const int step = st / T, t = st - step * T;
      const float* s = src + nl * CC * T + step * kSub * T + t;
      uint32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = pack_bf16(s[2 * i * T], s[(2 * i + 1) * T]);
      const int row = st * BN + nl;
      dst[half_slot(row, 0)] = make_uint4(v[0], v[1], v[2], v[3]);
      dst[half_slot(row, 1)] = make_uint4(v[4], v[5], v[6], v[7]);
    }
  };

  // ---- this lane's rows: A (pixels) and B (output channels) of its ldmatrix addresses
  int apix[MF];
#pragma unroll
  for (int im = 0; im < MF; ++im) {
    const int m = wm * WTM + im * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int j = m / p.seg, q = m - j * p.seg;
    apix[im] = j < p.rows ? (j * p.kh * p.patch_w + q * p.stride) : 0;
  }
  const int a_half = lane >> 4;
  const int b_row = wn * WTN + (lane & 7) + ((lane >> 4) << 3), b_half = (lane >> 3) & 1;

  float acc[MF][NF][4];
#pragma unroll
  for (int im = 0; im < MF; ++im)
#pragma unroll
    for (int jn = 0; jn < NF; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[im][jn][e] = 0.f;

  auto compute = [&](int buf) {
    const uint4* A = as + buf * KS * npix * 2;
    const uint4* B = bs + buf * KS * T * BN * 2;
#pragma unroll
    for (int step = 0; step < KS; ++step) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int toff = step * npix + (t / KW) * p.patch_w + (t % KW);
        uint32_t bf[NF][2];
#pragma unroll
        for (int jn = 0; jn < NF; jn += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, B + half_slot((step * T + t) * BN + b_row + jn * 8, b_half));
          bf[jn][0] = r[0];
          bf[jn][1] = r[1];
          bf[jn + 1][0] = r[2];
          bf[jn + 1][1] = r[3];
        }
#pragma unroll
        for (int im = 0; im < MF; ++im) {
          uint32_t af[4];
          ldmatrix_x4(af, A + half_slot(apix[im] + toff, a_half));
#pragma unroll
          for (int jn = 0; jn < NF; ++jn) mma_16x8x16(acc[im][jn], af, bf[jn][0], bf[jn][1]);
        }
      }
    }
  };

  // ---- the K loop. Chunk i's weights are staged in slot i % kStages, its operands sit in buffer i & 1.
  for (int s = 0; s < kStages; ++s) {
    if (s < nk) fetch_weights(kbeg + s, s);
    cp_async_commit();
  }
  load_patch(kbeg);
  cp_async_wait<kStages - 1>();
  __syncthreads();
  convert_weights(0, 0);
  store_patch(0);
  if (nk > 1) load_patch(kbeg + 1);
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();  // chunk i + 1's weights have landed (this thread's copies)
    __syncthreads();               // ... everyone's; buffer (i + 1) & 1 and slot i % kStages are free
    if (i + 1 < nk) {
      convert_weights((i + 1) % kStages, (i + 1) & 1);
      store_patch((i + 1) & 1);
    }
    if (i + kStages < nk) fetch_weights(kbeg + i + kStages, i % kStages);
    cp_async_commit();
    if (i + 2 < nk) load_patch(kbeg + i + 2);
    compute(i & 1);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the buffers; staging becomes the partial tile

  // ---- epilogue: the partial tile, [n][m] f32, then (after the cluster's) the sum, bias and rounding
  float* ct = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int im = 0; im < MF; ++im)
#pragma unroll
      for (int jn = 0; jn < NF; ++jn) {
        const int m = wm * WTM + im * 16 + g, n = wn * WTN + jn * 8 + 2 * tq;
        ct[n * L::kLdc + m] = acc[im][jn][0];
        ct[(n + 1) * L::kLdc + m] = acc[im][jn][1];
        ct[n * L::kLdc + m + 8] = acc[im][jn][2];
        ct[(n + 1) * L::kLdc + m + 8] = acc[im][jn][3];
      }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  // This thread's pixel is fixed (kThreads is a multiple of BM); it walks the channels of its rank's share.
  const int ml = tid % BM;
  const int j = ml / p.seg, q = ml - j * p.seg;
  const int orow = row0 + j;
  const int ow = col0 + q;
  const long long hwo = static_cast<long long>(p.ho) * p.wo;
  if (j < p.rows && orow < a.out_rows && ow < p.wo) {
    const int b = orow / p.ho;
    bf16* yp = a.y + static_cast<long long>(b) * p.cout * hwo + (orow - b * p.ho) * p.wo + ow;
    const float* peer[8];  // every rank's partial tile, mapped once
#pragma unroll
    for (int r = 0; r < 8; ++r) peer[r] = splits > 1 && r < splits ? cluster.map_shared_rank(ct, r) : ct;
    const int nper = BN / splits;
    for (int nl = rank * nper + tid / BM; nl < (rank + 1) * nper; nl += kThreads / BM) {
      const int n = n0 + nl;
      if (n >= p.cout) break;
      const int at = nl * L::kLdc + ml;
      float part[8];  // all loads first, then the sum in rank order
#pragma unroll
      for (int r = 0; r < 8; ++r) part[r] = r < splits ? peer[r][at] : 0.f;
      float v = part[0];
#pragma unroll
      for (int r = 1; r < 8; ++r)
        if (r < splits) v += part[r];
      if (a.bias) v += __bfloat162float(__float2bfloat16_rn(a.bias[n]));
      yp[n * hwo] = __float2bfloat16_rn(v);
    }
  }
  if (splits > 1) cluster.sync();  // no CTA leaves while a peer still reads its partial tile
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int T, int UNITS>
cudaError_t launch(const Args& a, const ConvPlan& p, cudaStream_t stream) {
  if (p.smem < Layout<BM, BN, T>::smem(p.patch_pixels) || p.smem > kMaxSmem ||
      2 * Chunk<T>::kSteps * p.patch_pixels > UNITS * WARPS_M * WARPS_N * 32 || p.splits < 1 || p.splits > 8 ||
      BN % p.splits || p.splits > p.chunks)
    return cudaErrorInvalidValue;
  const long long mtiles = (static_cast<long long>(a.out_rows) + p.rows - 1) / p.rows * p.segs;
  if (mtiles * p.splits >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(mtiles * p.splits), static_cast<unsigned>((p.cout + BN - 1) / BN));
  cfg.blockDim = dim3(WARPS_M * WARPS_N * 32);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (p.splits > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(p.splits);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, bi_conv2d_kernel<BM, BN, WARPS_M, WARPS_N, T, UNITS>, a, p);
}

template <int T>
cudaError_t launch_taps(const Args& a, const ConvPlan& p, cudaStream_t stream) {
  switch (p.config) {
    case 0:
      return launch<256, 64, 8, 2, T, 4>(a, p, stream);
    case 1:
      return launch<64, 64, 2, 2, T, 8>(a, p, stream);
    case 2:
      return launch<32, 32, 2, 2, T, 8>(a, p, stream);
    case 3:
      return launch<128, 64, 4, 2, T, 8>(a, p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int T>
cudaError_t allow_large_smem() {
  const void* kernels[] = {reinterpret_cast<const void*>(bi_conv2d_kernel<256, 64, 8, 2, T, 4>),
                           reinterpret_cast<const void*>(bi_conv2d_kernel<64, 64, 2, 2, T, 8>),
                           reinterpret_cast<const void*>(bi_conv2d_kernel<32, 32, 2, 2, T, 8>),
                           reinterpret_cast<const void*>(bi_conv2d_kernel<128, 64, 4, 2, T, 8>)};
  for (const void* k : kernels) {
    const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Once per process and card, before any launch: dynamic shared memory up to
// the card's limit for every tile. Returns a cudaError_t.
extern "C" int adt_bi_conv2d_init() {
  cudaError_t e = allow_large_smem<1>();
  if (e == cudaSuccess) e = allow_large_smem<9>();
  return static_cast<int>(e);
}

// x: contiguous (batch, cin, h, w_in) bf16; w: contiguous (cout, cin, kh, kw)
// f32; bias: (cout,) f32 or null; y: contiguous (batch, cout, ho, wo) bf16.
// One launch on `stream`; returns cudaGetLastError() (or cudaErrorInvalidValue
// for a plan the kernels do not take, without launching).
extern "C" int adt_bi_conv2d(const void* x, const void* w, const void* bias, void* y, long long batch, int h,
                             int w_in, int pad, const ConvPlan* plan, void* stream) {
  const ConvPlan& p = *plan;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<bf16*>(y);
  if (batch * p.ho >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  a.out_rows = static_cast<int>(batch * p.ho);
  a.h = h;
  a.w_in = w_in;
  a.pad = pad;
  a.wvec = p.cin % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (p.kh == 3 && p.kw == 3) {
    e = launch_taps<9>(a, p, s);
  } else if (p.kh == 1 && p.kw == 1) {
    e = launch_taps<1>(a, p, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
