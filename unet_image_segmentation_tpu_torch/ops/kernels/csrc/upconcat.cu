// K6: the decoder feed, a 2x2/stride-2 transpose conv + bias and the
// [up | skip] concat, forward and backward.
//
// Replaces the TPU kernels unet_image_segmentation_tpu/ops/pallas/
// fused_upconcat.py:_fwd_kernel and _bwd_kernel (launched by
// _upconcat_fwd_impl and _upconcat_bwd). With kernel == stride every output
// pixel takes one tap, so the op is one GEMM with a scattered epilogue:
//
//   forward:  up[b, 2i+di, 2j+dj, f] = Σ_c x[b,i,j,c] W[c, (di,dj,f)] + bias[f]
//             (fp32 sums, the bias added in fp32, rounded once to T)
//             cat[..., :F] = up, cat[..., F:] = skip
//   backward: dup[p, (di,dj,f)] = g[b, 2i+di, 2j+dj, f]   (read in T)
//             dx = dup . W^T -> T,  d_skip = g[..., F:]
//             d_kernel = x^T . dup,  d_bias = Σ_p dup     (fp32)
//
// What bounds it on the H100: at the U-Net's widths (batch 32, 256 px) the
// four decoder stages move ~1.8 GB forward and ~2 GB backward in bf16, which
// is ~0.5 and ~0.6 ms at 3.35 TB/s, while the GEMMs take 34.4 GFLOP per
// stage and product (~137 GFLOP forward over the four stages, twice that
// backward): ~0.14 and ~0.28 ms on the bf16 tensor cores, so bytes bound
// bf16. fp32 stays on FMAs (TF32 would break the fp32 bars), where the
// operations bound it: ~2 ms forward and ~4 ms backward at 67 TFLOP/s.
//
// Design, 256 threads a block:
//  - bf16 (C a multiple of 64, F of 16: every decoder feed of the U-Net):
//    mma.sync m16n8k16 with fp32 accumulation on 128x64 block tiles, both
//    operands staged K-major in shared memory (see the *_tc_kernel below).
//  - otherwise shared-memory tiled fp32-FMA GEMMs: the forward takes 128
//    pixels x 64 columns of (di,dj,f) a block, K = C in chunks of 32, 8x4
//    outputs a thread; dx the same shape over (pixels, C) with K = 4F.
//  - forward epilogue: add the bias, round once, write each value to its
//    pixel of the 2x upsampled output; the same thread copies the skip
//    channels that land beside it, so every element of cat is written once
//    and no concat pass follows.
//  - dx: the A tile is gathered straight from g (the pixel shuffle is an
//    index map; the tile's pixel offsets are computed once, in shared
//    memory, not per element).
//  - d_kernel: a split-K GEMM over pixels of (C, 4F) tiles, one partial per
//    split; the blocks of the first C tile also sum the dup columns
//    (d_bias) and copy g[..., F:] to d_skip. reduce_rows() sums the
//    partials in a fixed order: no atomics, bit-reproducible runs.
#include <algorithm>
#include <type_traits>

#include "mma_common.cuh"
#include "train_common.cuh"

namespace unet {
namespace {

constexpr int kBM = 128;          // pixels per forward / dx tile
constexpr int kBN = 64;           // columns per forward / dx tile
constexpr int kLdM = kBM + 4;     // row stride of an A tile [k][kBM]
constexpr int kLdN = kBN + 4;     // row stride of a B tile [k][kBN]

// Index of output pixel (2i, 2j) of input pixel p = (b, i, j) in the
// (B, 2H, 2W) upsampled image; tap q = (di, dj) adds up_step(q, W).
__device__ __forceinline__ int up_pixel(int p, int H, int W) {
  const int hw = H * W;
  const int b = p / hw, rem = p % hw;
  const int i = rem / W, j = rem % W;
  return (b * 2 * H + 2 * i) * 2 * W + 2 * j;
}

__device__ __forceinline__ int up_step(int q, int W) { return (q >> 1) * 2 * W + (q & 1); }

// acc[8][4] += A^T B over k < k_len; A [k][kLdM] (8 rows a thread), B [k][kLdN].
__device__ __forceinline__ void gemm_8x4(float (&acc)[8][4], const float* As, const float* Bs,
                                         int k_len, int tm, int tn) {
#pragma unroll 4
  for (int k = 0; k < k_len; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * kLdM + tm * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(As + k * kLdM + tm * 8 + 4);
    const float4 b = *reinterpret_cast<const float4*>(Bs + k * kLdN + tn * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Stage columns [k0, k0 + k_len) of rows [n0, n0 + kBN) of the (rows, ld)
// matrix m, transposed, into Bs [k][n - n0] (zero outside m): the lanes of a
// warp read 32 consecutive k of one row (coalesced), and the row stride kLdN
// spreads their stores over 8 banks. This is how the FMA kernels read the
// weights in the layout the tensor-core kernels take.
template <typename T>
__device__ __forceinline__ void stage_b_transposed(float* Bs, const T* __restrict__ m, int ld,
                                                   int rows, int n0, int k0, int k_len) {
  for (int idx = threadIdx.x; idx < kKC * kBN; idx += kThreads) {
    const int kk = idx % kKC, n = n0 + idx / kKC;
    Bs[kk * kLdN + idx / kKC] = (kk < k_len && n < rows) ? to_f(m[(size_t)n * ld + k0 + kk]) : 0.f;
  }
}

// grid (pixel tiles, column tiles). wt (4F, C) in T, rows (di, dj, f).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upconcat_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                        const float* __restrict__ bias, const T* __restrict__ skip,
                        T* __restrict__ cat, int P, int H, int W, int C, int F) {
  __shared__ __align__(16) float As[kKC * kLdM];  // x tile, [c][px]
  __shared__ __align__(16) float Bs[kKC * kLdN];  // W tile, [c][col]
  __shared__ int upix[kBM];                        // up_pixel of the tile's pixels
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int N = 4 * F;
  const int tn = tid % (kBN / 4), tm = tid / (kBN / 4);
  if (tid < kBM) upix[tid] = p0 + tid < P ? up_pixel(p0 + tid, H, W) : 0;
  float acc[8][4] = {};
  for (int c0 = 0; c0 < C; c0 += kKC) {
    const int kc = min(kKC, C - c0);
    for (int idx = tid; idx < kKC * kBM; idx += kThreads) {
      const int kk = idx % kKC, m = idx / kKC, p = p0 + m;
      As[kk * kLdM + m] = (p < P && kk < kc) ? to_f(x[(size_t)p * C + c0 + kk]) : 0.f;
    }
    stage_b_transposed(Bs, wt, C, N, n0, c0, kc);
    __syncthreads();
    gemm_8x4(acc, As, Bs, kc, tm, tn);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tn * 4 + j;
    if (col >= N) continue;
    const int f = col % F, step = up_step(col / F, W);
    const float bf = bias[f];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (p0 + tm * 8 + i >= P) continue;
      const size_t px = (size_t)upix[tm * 8 + i] + step;
      cat[px * 2 * F + f] = from_f<T>(acc[i][j] + bf);
      cat[px * 2 * F + F + f] = skip[px * F + f];
    }
  }
}

// dx[p][c] = Σ_n dup[p][n] wmat[c][n]. grid (pixel tiles, C tiles). wmat (C, 4F) in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upconcat_dx_kernel(const T* __restrict__ g, const T* __restrict__ wmat, T* __restrict__ dx,
                       int P, int H, int W, int C, int F) {
  __shared__ __align__(16) float As[kKC * kLdM];  // dup tile, [n][px]
  __shared__ __align__(16) float Bs[kKC * kLdN];  // W^T tile, [n][c]
  __shared__ int upix[kBM];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kBM, c0 = blockIdx.y * kBN;
  const int N = 4 * F;
  const int tn = tid % (kBN / 4), tm = tid / (kBN / 4);
  if (tid < kBM) upix[tid] = p0 + tid < P ? up_pixel(p0 + tid, H, W) : 0;
  __syncthreads();
  float acc[8][4] = {};
  const int kk = tid % kKC;  // the A row this thread stages, in every chunk
  for (int k0 = 0; k0 < N; k0 += kKC) {
    const int kc = min(kKC, N - k0);
    const int n = k0 + kk, f = n % F, step = up_step(n / F, W);
    for (int m = tid / kKC; m < kBM; m += kThreads / kKC) {
      float v = 0.f;
      if (p0 + m < P && kk < kc) v = to_f(g[((size_t)upix[m] + step) * 2 * F + f]);
      As[kk * kLdM + m] = v;
    }
    stage_b_transposed(Bs, wmat, N, C, c0, k0, kc);
    __syncthreads();
    gemm_8x4(acc, As, Bs, kc, tm, tn);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = p0 + tm * 8 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tn * 4 + j;
      if (c < C) dx[(size_t)p * C + c] = from_f<T>(acc[i][j]);
    }
  }
}

// part[split] is a (C+1, 4F) matrix: rows c < C hold Σ x[p][c] dup[p][n] over
// the split's pixels, row C (written by the first C tile) Σ dup[p][n]. The
// first C tile's blocks also copy g[..., F:] to d_skip.
// grid (column tiles, C tiles, splits).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upconcat_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ d_skip,
                       float* __restrict__ part, int P, int H, int W, int C, int F,
                       int px_per_split) {
  __shared__ __align__(16) float xs[kKC * kLdA64];  // [p][c]
  __shared__ __align__(16) float gs[kKC * kTileF];  // [p][col]
  __shared__ int upix[kKC];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTileF, c0 = blockIdx.y * kTileF;
  const bool first_c = blockIdx.y == 0;
  const int N = 4 * F;
  const int p_begin = blockIdx.z * px_per_split;
  const int p_end = min(P, p_begin + px_per_split);
  const int tm = tid / (kTileF / 4), tn = tid % (kTileF / 4);
  // the column (and the c of xs) this thread stages, in every chunk
  const int nl = tid % kTileF, col = n0 + nl, f = col % F, step = up_step(col / F, W);
  float acc[4][4] = {};
  float bsum = 0.f;  // d_bias partial of column n0 + tid (tid < kTileF)
  for (int p0 = p_begin; p0 < p_end; p0 += kKC) {
    const int kp = min(kKC, p_end - p0);
    if (tid < kKC) upix[tid] = tid < kp ? up_pixel(p0 + tid, H, W) : 0;
    __syncthreads();
    for (int kk = tid / kTileF; kk < kKC; kk += kThreads / kTileF) {
      const int c = c0 + nl;
      xs[kk * kLdA64 + nl] = (kk < kp && c < C) ? to_f(x[(size_t)(p0 + kk) * C + c]) : 0.f;
      float v = 0.f;
      if (kk < kp && col < N) {
        const size_t px = (size_t)upix[kk] + step;
        v = to_f(g[px * 2 * F + f]);
        if (first_c) d_skip[px * F + f] = g[px * 2 * F + F + f];
      }
      gs[kk * kTileF + nl] = v;
    }
    __syncthreads();
    smem_gemm<kLdA64, kTileF>(acc, xs, gs, kp, tm, tn);
    if (first_c && tid < kTileF)
      for (int kk = 0; kk < kp; ++kk) bsum += gs[kk * kTileF + tid];
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * (C + 1) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + tm * 4 + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < N) out[(size_t)c * N + n] = acc[i][j];
    }
  }
  if (first_c && tid < kTileF && n0 + tid < N) out[(size_t)C * N + n0 + tid] = bsum;
}


// ---- bf16 on the tensor cores: mma.sync m16n8k16, fp32 accumulation ----
// A block tile is 128 rows x 64 columns, K in chunks of 32; the 8 warps
// form a 4x2 grid of 32x32 warp tiles. Both operands are staged K-major in
// shared memory ([row][k], 8 bf16 of padding a row, so the fragment loads
// hit 32 distinct banks). Products of bf16 values are exact in fp32, so the
// only difference from the FMA path is the order of the fp32 sums.

constexpr int kTcBM = 128, kTcBN = 64, kTcBK = 32;
constexpr int kTcLd = kTcBK + 8;  // bf16 row stride of a staged tile
using bf16 = __nv_bfloat16;

// The shapes the tensor-core path takes (every decoder feed of the U-Net).
__host__ __device__ inline bool tc_shape(int C, int F) { return C % 64 == 0 && F % 16 == 0; }

// acc += As[warp rows][0, kTcBK) . Bs[warp cols][0, kTcBK)^T for one chunk.
__device__ __forceinline__ void warp_mma_chunk(float (&acc)[2][4][4], const bf16* As,
                                               const bf16* Bs, int wm, int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kTcBK; ks += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const bf16* p = As + (wm * 32 + mi * 16 + g) * kTcLd + ks + 2 * t;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kTcLd);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kTcLd + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const bf16* p = Bs + (wn * 32 + ni * 8 + g) * kTcLd + ks + 2 * t;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// Forward: rows = pixels, columns = (di, dj, f), K = C. wt (4F, C).
__global__ void __launch_bounds__(kThreads)
    upconcat_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                           const float* __restrict__ bias, const bf16* __restrict__ skip,
                           bf16* __restrict__ cat, int P, int H, int W, int C, int F) {
  __shared__ __align__(16) bf16 As[kTcBM * kTcLd];
  __shared__ __align__(16) bf16 Bs[kTcBN * kTcLd];
  __shared__ int upix[kTcBM];
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) & 3, wn = tid >> 7;
  const int p0 = blockIdx.x * kTcBM, n0 = blockIdx.y * kTcBN;
  if (tid < kTcBM) upix[tid] = p0 + tid < P ? up_pixel(p0 + tid, H, W) : 0;
  float acc[2][4][4] = {};
  for (int c0 = 0; c0 < C; c0 += kTcBK) {
    for (int v = tid; v < kTcBM * kTcBK / 8; v += kThreads) {
      const int m = v >> 2, j = (v & 3) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (p0 + m < P) val = *reinterpret_cast<const uint4*>(x + (size_t)(p0 + m) * C + c0 + j);
      *reinterpret_cast<uint4*>(As + m * kTcLd + j) = val;
    }
    {
      const int n = tid >> 2, j = (tid & 3) * 8;
      *reinterpret_cast<uint4*>(Bs + n * kTcLd + j) =
          *reinterpret_cast<const uint4*>(wt + (size_t)(n0 + n) * C + c0 + j);
    }
    __syncthreads();
    warp_mma_chunk(acc, As, Bs, wm, wn, lane);
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + 2 * t;  // f and f + 1 share the tap
    const int f = n % F, step = up_step(n / F, W);
    const float b0 = bias[f], b1 = bias[f + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * 32 + mi * 16 + g + 8 * h;
        if (p0 + m >= P) continue;
        const size_t px = (size_t)upix[m] + step;
        *reinterpret_cast<__nv_bfloat162*>(cat + px * 2 * F + f) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h] + b0, acc[mi][ni][2 * h + 1] + b1);
        *reinterpret_cast<uint32_t*>(cat + px * 2 * F + F + f) =
            *reinterpret_cast<const uint32_t*>(skip + px * F + f);
      }
  }
}

// dx: rows = pixels, columns = C, K = (di, dj, f) gathered from g. wmat (C, 4F).
__global__ void __launch_bounds__(kThreads)
    upconcat_dx_tc_kernel(const bf16* __restrict__ g, const bf16* __restrict__ wmat,
                          bf16* __restrict__ dx, int P, int H, int W, int C, int F) {
  __shared__ __align__(16) bf16 As[kTcBM * kTcLd];
  __shared__ __align__(16) bf16 Bs[kTcBN * kTcLd];
  __shared__ int upix[kTcBM];
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) & 3, wn = tid >> 7;
  const int p0 = blockIdx.x * kTcBM, c0 = blockIdx.y * kTcBN, N = 4 * F;
  if (tid < kTcBM) upix[tid] = p0 + tid < P ? up_pixel(p0 + tid, H, W) : 0;
  __syncthreads();
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < N; k0 += kTcBK) {
    for (int v = tid; v < kTcBM * kTcBK / 8; v += kThreads) {
      const int m = v >> 2, j = (v & 3) * 8, k = k0 + j;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (p0 + m < P)
        val = *reinterpret_cast<const uint4*>(
            g + ((size_t)upix[m] + up_step(k / F, W)) * 2 * F + k % F);
      *reinterpret_cast<uint4*>(As + m * kTcLd + j) = val;
    }
    {
      const int n = tid >> 2, j = (tid & 3) * 8;
      *reinterpret_cast<uint4*>(Bs + n * kTcLd + j) =
          *reinterpret_cast<const uint4*>(wmat + (size_t)(c0 + n) * N + k0 + j);
    }
    __syncthreads();
    warp_mma_chunk(acc, As, Bs, wm, wn, lane);
    __syncthreads();
  }
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * 32 + mi * 16 + gr + 8 * h;
      if (p0 + m >= P) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = c0 + wn * 32 + ni * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)(p0 + m) * C + c) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// d_kernel partials as upconcat_dw_kernel's: rows = C, columns = (di, dj, f),
// K = the split's pixels; both operands are staged transposed (pixel-major
// in device memory, K-major in shared memory).
__global__ void __launch_bounds__(kThreads)
    upconcat_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                          bf16* __restrict__ d_skip, float* __restrict__ part, int P, int H,
                          int W, int C, int F, int px_per_split) {
  __shared__ __align__(16) bf16 As[kTcBM * kTcLd];
  __shared__ __align__(16) bf16 Bs[kTcBN * kTcLd];
  __shared__ int upix[kTcBK];
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) & 3, wn = tid >> 7;
  const int n0 = blockIdx.x * kTcBN, c0 = blockIdx.y * kTcBM, N = 4 * F;
  const bool first_c = blockIdx.y == 0;
  const int p_begin = blockIdx.z * px_per_split;
  const int p_end = min(P, p_begin + px_per_split);
  // The transposed stores put a warp's 32 lanes on 32 pixels, so they hit
  // distinct banks. The B vector this thread stages in every chunk: pixel kb,
  // columns jb..jb+7.
  const int kb = lane, jb = (tid >> 5) * 8;
  const int fb = (n0 + jb) % F, stepb = up_step((n0 + jb) / F, W);
  float acc[2][4][4] = {};
  float bsum = 0.f;  // d_bias partial of column n0 + tid (tid < kTcBN)
  for (int p0 = p_begin; p0 < p_end; p0 += kTcBK) {
    const int kp = min(kTcBK, p_end - p0);
    if (tid < kTcBK) upix[tid] = tid < kp ? up_pixel(p0 + tid, H, W) : 0;
    __syncthreads();
    for (int v = tid; v < kTcBK * kTcBM / 8; v += kThreads) {
      const int k = v & 31, j = (v >> 5) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k < kp && c0 + j < C)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(p0 + k) * C + c0 + j);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) As[(j + i) * kTcLd + k] = e[i];
    }
    {
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kb < kp) {
        const size_t px = (size_t)upix[kb] + stepb;
        val = *reinterpret_cast<const uint4*>(g + px * 2 * F + fb);
        if (first_c)
          *reinterpret_cast<uint4*>(d_skip + px * F + fb) =
              *reinterpret_cast<const uint4*>(g + px * 2 * F + F + fb);
      }
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Bs[(jb + i) * kTcLd + kb] = e[i];
    }
    __syncthreads();
    warp_mma_chunk(acc, As, Bs, wm, wn, lane);
    if (first_c && tid < kTcBN)
      for (int k = 0; k < kp; ++k) bsum += __bfloat162float(Bs[tid * kTcLd + k]);
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * (C + 1) * N;
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wm * 32 + mi * 16 + gr + 8 * h;
      if (c >= C) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (size_t)c * N + n) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  if (first_c && tid < kTcBN) out[(size_t)C * N + n0 + tid] = bsum;
}

struct DwPlan {
  int splits, px_per_split;
  long long cols;  // (C+1)*4F
};

DwPlan dw_plan(int B, int H, int W, int C, int F) {
  const long long P = (long long)B * H * W;
  const int tiles = ((4 * F + kTileF - 1) / kTileF) * ((C + kTileF - 1) / kTileF);
  // about 8 blocks per SM of a 132-SM card, at least 256 pixels a split
  long long splits = (1056 + tiles - 1) / tiles;
  splits = std::max(1LL, std::min(splits, (P + 255) / 256));
  long long per = (P + splits - 1) / splits;
  per = (per + kKC - 1) / kKC * kKC;
  splits = (P + per - 1) / per;
  return {(int)splits, (int)per, (long long)(C + 1) * 4 * F};
}

template <typename T>
int launch_fwd(const void* x, const void* wt, const void* bias, const void* skip, void* cat,
               int B, int H, int W, int C, int F, cudaStream_t stream) {
  const int P = B * H * W;
  if (std::is_same<T, bf16>::value && tc_shape(C, F)) {
    const dim3 grid((P + kTcBM - 1) / kTcBM, 4 * F / kTcBN);
    upconcat_fwd_tc_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
        static_cast<const float*>(bias), static_cast<const bf16*>(skip), static_cast<bf16*>(cat),
        P, H, W, C, F);
    return (int)cudaGetLastError();
  }
  const dim3 grid((P + kBM - 1) / kBM, (4 * F + kBN - 1) / kBN);
  upconcat_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<const float*>(bias),
      static_cast<const T*>(skip), static_cast<T*>(cat), P, H, W, C, F);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* wmat, const void* g, void* dx, void* d_skip,
               float* work, float* dwb, int B, int H, int W, int C, int F, cudaStream_t stream) {
  const int P = B * H * W;
  const DwPlan plan = dw_plan(B, H, W, C, F);
  if (std::is_same<T, bf16>::value && tc_shape(C, F)) {
    const dim3 grid_dx((P + kTcBM - 1) / kTcBM, C / kTcBN);
    upconcat_dx_tc_kernel<<<grid_dx, kThreads, 0, stream>>>(
        static_cast<const bf16*>(g), static_cast<const bf16*>(wmat), static_cast<bf16*>(dx), P,
        H, W, C, F);
    const dim3 grid_dw(4 * F / kTcBN, (C + kTcBM - 1) / kTcBM, plan.splits);
    upconcat_dw_tc_kernel<<<grid_dw, kThreads, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<bf16*>(d_skip),
        work, P, H, W, C, F, plan.px_per_split);
  } else {
    const dim3 grid_dx((P + kBM - 1) / kBM, (C + kBN - 1) / kBN);
    upconcat_dx_kernel<T><<<grid_dx, kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(wmat), static_cast<T*>(dx), P, H, W, C,
        F);
    const dim3 grid_dw((4 * F + kTileF - 1) / kTileF, (C + kTileF - 1) / kTileF, plan.splits);
    upconcat_dw_kernel<T><<<grid_dw, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(d_skip), work, P, H,
        W, C, F, plan.px_per_split);
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  float* scratch = work + (long long)plan.splits * plan.cols;
  return reduce_rows(work, plan.splits, (int)plan.cols, scratch, dwb, stream);
}

}  // namespace
}  // namespace unet

// x (B,H,W,C), skip (B,2H,2W,F), cat (B,2H,2W,2F) in T; the weights wt
// (4F,C) in T, rows (di, dj, f): the transpose kernel (2,2,F,C) as it lies;
// bias (F,) fp32. Returns cudaGetLastError().
extern "C" int unet_upconcat(const void* x, const void* wt, const void* bias, const void* skip,
                             void* cat, int B, int H, int W, int C, int F, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return unet::launch_fwd<float>(x, wt, bias, skip, cat, B, H, W, C, F, s);
  if (dtype == 1)
    return unet::launch_fwd<__nv_bfloat16>(x, wt, bias, skip, cat, B, H, W, C, F, s);
  return (int)cudaErrorInvalidValue;
}

// Floats of workspace unet_upconcat_bwd needs.
extern "C" long long unet_upconcat_bwd_workspace(int B, int H, int W, int C, int F) {
  const unet::DwPlan p = unet::dw_plan(B, H, W, C, F);
  return (long long)p.splits * p.cols + unet::reduce_scratch_floats(p.splits, p.cols);
}

// x, dx (B,H,W,C), g (B,2H,2W,2F), d_skip (B,2H,2W,F) in T; the weights
// wmat (C,4F) in T, columns (di, dj, f); dwb (C+1, 4F) fp32: rows c < C
// d_kernel in (C, (di,dj,f)) order, row C the column sums of dup. Returns
// cudaGetLastError().
extern "C" int unet_upconcat_bwd(const void* x, const void* wmat, const void* g, void* dx,
                                 void* d_skip, void* work, void* dwb, int B, int H, int W, int C,
                                 int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(dwb);
  if (dtype == 0)
    return unet::launch_bwd<float>(x, wmat, g, dx, d_skip, w, o, B, H, W, C, F, s);
  if (dtype == 1)
    return unet::launch_bwd<__nv_bfloat16>(x, wmat, g, dx, d_skip, w, o, B, H, W, C, F, s);
  return (int)cudaErrorInvalidValue;
}
