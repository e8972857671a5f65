// K7: a fused inference ConvBlock pair, two sepconv + folded-BN + ReLU blocks
// in one kernel, with block 1's output y1 kept on chip.
//
// Replaces the TPU kernel unet_image_segmentation_tpu/ops/pallas/fused_sepconv.py
// :_sepconv_pair_kernel_db (launched by fused_sepconv_pair), in its float
// modes: plain, pool=True (the encoder's 2x2 max pool of the dtype-cast y2
// written beside y2) and two-stream (block 1's input is the channel concat
// [x | x2], read from two pointers, so the decoder's concat is never stored).
// Semantics kept: y1 = relu(dw1/pw1 affine) rounded to the compute dtype T;
// y1 is ZERO outside the image, so block 2's 'same' padding sees zeros and not
// block 1 evaluated past the edge; every sum in fp32.
//
// What bounds it on the H100: the products. Per output pixel a stage does
// 9C + C*F1 + 9F1 + F1*F2 multiply-adds while it reads C and writes F2
// elements, far above the fp32 CUDA-core balance point (~20 FLOP per byte).
// This kernel runs them as fp32 FMAs from shared memory, so FMA issue,
// shared-memory bandwidth and the recompute below bound it.
//
// Design: the TPU kernel holds whole row slabs of y1 in VMEM (megabytes); a
// block here has at most 227 KB of shared memory, which cannot hold y1 at
// F1 = 1024 nor even one row at F1 = 64. So one block owns an 8x8 output tile
// and 64 channels of F2, with 256 threads and a 4x4 register tile each for y2.
// It walks F1 in chunks of 32. For each chunk it
//   1. builds y1 over the 10x10 tile-plus-halo (padded to 128 rows of the
//      GEMM): block 1's depthwise of x over C in chunks of 32, then the
//      register GEMM with pw1's slice;
//   2. applies block 1's affine and ReLU, zeroes halo pixels outside the
//      image, rounds to T and keeps the chunk in shared memory;
//   3. runs block 2's depthwise on the chunk for the 64 output pixels;
//   4. accumulates the chunk's pointwise product into the y2 registers.
// Recompute: y1 is rebuilt for every 64-wide F2 tile and over a ring of
// 100/64 = 1.56x the tile's pixels, so block 1's pointwise runs
// 1.56 * ceil(F2/64) times (1.56x at F2 = 64, 25x at the 1024-wide
// bottleneck); block 1's depthwise runs 1.56 * ceil(F1/32) * ceil(F2/64)
// times. Tensor cores, TMA, pipelining and cutting that recompute are later
// work.
#include "sepconv_common.cuh"

namespace unet {
namespace {

constexpr int kHalo = kTile + 2;         // side of the y1 tile: output tile + 1-pixel ring
constexpr int kHaloPx = kHalo * kHalo;   // 100 y1 pixels
constexpr int kHaloM = 128;              // y1 pixels padded to the GEMM's M
constexpr int kLdA128 = kHaloM + 4;      // row stride of the [k][p] depthwise operand
constexpr int kKC1 = 32;                 // y1 channels per chunk
constexpr int kLdY1 = kKC1 + 1;          // row stride of the y1 chunk [p][k1]
static_assert(kKC1 == kKC, "stage_weights stages kKC rows of pw2");
static_assert(kHaloM * kLdY1 <= kKC * kLdA128, "the y1 chunk reuses the depthwise buffer");

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sepconv_pair_kernel(const T* __restrict__ x, const T* __restrict__ x2,
                        const T* __restrict__ dw1, const T* __restrict__ pw1,
                        const float* __restrict__ scale1, const float* __restrict__ shift1,
                        const T* __restrict__ dw2, const T* __restrict__ pw2,
                        const float* __restrict__ scale2, const float* __restrict__ shift2,
                        T* __restrict__ out, T* __restrict__ pooled, int H, int W, int Cx,
                        int Cx2, int F1, int F2, int tiles_x) {
  __shared__ __align__(16) float bufA[kKC * kLdA128];  // dw1(x) chunk [k][p], then y1 [p][k1]
  __shared__ __align__(16) float pw1s[kKC * kKC1];     // pw1 slice [k][f1]
  __shared__ __align__(16) float d2s[kKC1 * kLdA64];   // dw2(y1) chunk [k1][m]
  __shared__ __align__(16) float pw2s[kKC1 * kTileF];  // pw2 slice [k1][f2]
  float* y1s = bufA;
  const int C = Cx + Cx2;
  const int tid = threadIdx.x;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int f0 = blockIdx.y * kTileF;
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * Cx;
  const T* x2b = Cx2 > 0 ? x2 + (size_t)b * H * W * Cx2 : nullptr;
  const int tm1 = tid / (kKC1 / 4), tn1 = tid % (kKC1 / 4);    // y1 GEMM: 128 px x 32 ch
  const int tm2 = tid / (kTileF / 4), tn2 = tid % (kTileF / 4);  // y2 GEMM: 64 px x 64 ch
  const int k = tid % kKC;
  float acc2[4][4] = {};

  for (int f1c = 0; f1c < F1; f1c += kKC1) {
    // 1. y1 chunk (pre-affine) over the halo tile
    float acc1[4][4] = {};
    for (int c0 = 0; c0 < C; c0 += kKC) {
      const int kc = min(kKC, C - c0);
      const int c = c0 + k;
      const T* src = nullptr;  // channel c of [x | x2]
      int cs = 0, ld = 0;
      if (k < kc) {
        if (c < Cx) {
          src = xb, cs = c, ld = Cx;
        } else {
          src = x2b, cs = c - Cx, ld = Cx2;
        }
      }
      float taps[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) taps[t] = src ? to_f(dw1[t * C + c]) : 0.f;
#pragma unroll 4
      for (int i = 0; i < kHaloM / (kThreads / kKC); ++i) {
        const int p = tid / kKC + (kThreads / kKC) * i;
        float s = 0.f;
        if (src && p < kHaloPx) {
          const int Y = ty0 - 1 + p / kHalo, X = tx0 - 1 + p % kHalo;
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            const int yy = Y + di - 1;
            if (yy < 0 || yy >= H) continue;
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
              const int xx = X + dj - 1;
              if (xx < 0 || xx >= W) continue;
              s += to_f(src[((size_t)yy * W + xx) * ld + cs]) * taps[di * 3 + dj];
            }
          }
        }
        bufA[k * kLdA128 + p] = round_to<T>(s);
      }
      stage_weights<T, kKC1>(pw1s, pw1, C, F1, c0, f1c);
      __syncthreads();
      smem_gemm<kLdA128, kKC1>(acc1, bufA, pw1s, kc, tm1, tn1);
      __syncthreads();
    }

    // 2. y1 = relu(affine), zero outside the image, rounded to T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = tm1 * 4 + i;
      const int Y = ty0 - 1 + p / kHalo, X = tx0 - 1 + p % kHalo;
      const bool inside = p < kHaloPx && Y >= 0 && Y < H && X >= 0 && X < W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k1 = tn1 * 4 + j, f1 = f1c + k1;
        float v = 0.f;
        if (inside && f1 < F1)
          v = round_to<T>(fmaxf(acc1[i][j] * scale1[f1] + shift1[f1], 0.f));
        y1s[p * kLdY1 + k1] = v;
      }
    }
    __syncthreads();

    // 3. block 2's depthwise on the chunk, for the 64 output pixels
    {
      const int m = tid % kTilePx;
      int r, cc;
      tile_px(m, r, cc);
#pragma unroll
      for (int i = 0; i < kKC1 / (kThreads / kTilePx); ++i) {
        const int k1 = tid / kTilePx + (kThreads / kTilePx) * i;
        const int f1 = f1c + k1;
        float s = 0.f;
        if (f1 < F1) {
#pragma unroll
          for (int di = 0; di < 3; ++di)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj)
              s += y1s[((r + di) * kHalo + cc + dj) * kLdY1 + k1] *
                   to_f(dw2[(di * 3 + dj) * F1 + f1]);
        }
        d2s[k1 * kLdA64 + m] = round_to<T>(s);
      }
    }
    stage_weights<T, kTileF>(pw2s, pw2, F1, F2, f1c, f0);
    __syncthreads();

    // 4. y2 += dw2(y1 chunk) . pw2 slice
    smem_gemm<kLdA64, kTileF>(acc2, d2s, pw2s, min(kKC1, F1 - f1c), tm2, tn2);
    __syncthreads();
  }

  // y2 = relu(affine) in T; the pool is the max of the thread's 2x2 quad
  const int qy = ty0 + 2 * (tm2 >> 2), qx = tx0 + 2 * (tm2 & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = f0 + tn2 * 4 + j;
    if (f >= F2) continue;
    const float sc = scale2[f], sh = shift2[f];
    float mx = 0.f;  // every v is >= 0 after the ReLU
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int Y = qy + (i >> 1), X = qx + (i & 1);
      const float v = round_to<T>(fmaxf(acc2[i][j] * sc + sh, 0.f));
      if (Y < H && X < W) out[(((size_t)b * H + Y) * W + X) * F2 + f] = from_f<T>(v);
      mx = fmaxf(mx, v);
    }
    if (pooled != nullptr && qy < H && qx < W)
      pooled[(((size_t)b * (H / 2) + qy / 2) * (W / 2) + qx / 2) * F2 + f] = from_f<T>(mx);
  }
}

template <typename T>
int launch(const void* x, const void* x2, const void* dw1, const void* pw1, const void* scale1,
           const void* shift1, const void* dw2, const void* pw2, const void* scale2,
           const void* shift2, void* out, void* pooled, int B, int H, int W, int Cx, int Cx2,
           int F1, int F2, cudaStream_t stream) {
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, (F2 + kTileF - 1) / kTileF, B);
  sepconv_pair_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(x2), static_cast<const T*>(dw1),
      static_cast<const T*>(pw1), static_cast<const float*>(scale1),
      static_cast<const float*>(shift1), static_cast<const T*>(dw2), static_cast<const T*>(pw2),
      static_cast<const float*>(scale2), static_cast<const float*>(shift2), static_cast<T*>(out),
      static_cast<T*>(pooled), H, W, Cx, Cx2, F1, F2, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace unet

// x2 may be null when Cx2 == 0; pooled may be null (no pool output; H and W
// must be even when it is given). dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch.
extern "C" int unet_sepconv_pair(const void* x, const void* x2, const void* dw1, const void* pw1,
                                 const void* scale1, const void* shift1, const void* dw2,
                                 const void* pw2, const void* scale2, const void* shift2,
                                 void* out, void* pooled, int B, int H, int W, int Cx, int Cx2,
                                 int F1, int F2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return unet::launch<float>(x, x2, dw1, pw1, scale1, shift1, dw2, pw2, scale2, shift2, out,
                               pooled, B, H, W, Cx, Cx2, F1, F2, s);
  if (dtype == 1)
    return unet::launch<__nv_bfloat16>(x, x2, dw1, pw1, scale1, shift1, dw2, pw2, scale2, shift2,
                                       out, pooled, B, H, W, Cx, Cx2, F1, F2, s);
  return (int)cudaErrorInvalidValue;
}
