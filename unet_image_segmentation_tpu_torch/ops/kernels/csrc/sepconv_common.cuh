// Shared pieces of the kernels: the block size, the 8x8 output tile and the
// conversions between T and fp32 (every kernel), and the register-tiled
// fp32-FMA GEMM of the kernels that still run one (K9's body in
// chain_fwd.cu, K6's FMA variants in upconcat.cu).
//
// Tensors are NHWC and contiguous. T is float or __nv_bfloat16 (the compute
// dtype). Every sum is taken in fp32: values are widened to float when they
// are staged in shared memory, and rounded back to T exactly where the JAX
// reference rounds (the depthwise result before the pointwise, y1 before
// block 2, the block output).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace unet {

constexpr int kThreads = 256;             // threads per block
constexpr int kTile = 8;                  // output tile: kTile x kTile pixels
constexpr int kTilePx = kTile * kTile;    // 64 output pixels per block
constexpr int kTileF = 64;                // output channels per block
constexpr int kKC = 32;                   // GEMM depth per shared-memory step
constexpr int kLdA64 = kTilePx + 4;       // row stride of a [k][64 px] operand

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value to T and widen it again.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Order of the 64 output pixels of a tile along the GEMM's M axis: m = 4q + i,
// quad q at rows/cols (2*(q/4), 2*(q%4)), i = (i/2, i%2) inside the quad. A
// thread's 4 consecutive m form one 2x2 window, so the fused pool is local.
__device__ __forceinline__ void tile_px(int m, int& r, int& c) {
  const int q = m >> 2, i = m & 3;
  r = 2 * (q >> 2) + (i >> 1);
  c = 2 * (q & 3) + (i & 1);
}

// acc += A^T B over k < k_len. A is [k][LDA] (M used), B is [k][N], both fp32
// in shared memory and 16-byte aligned. The thread owns rows tm*4..tm*4+3 of
// M and columns tn*4..tn*4+3 of N.
template <int LDA, int N>
__device__ __forceinline__ void smem_gemm(float (&acc)[4][4], const float* As, const float* Bs,
                                          int k_len, int tm, int tn) {
#pragma unroll 4
  for (int k = 0; k < k_len; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(As + k * LDA + tm * 4);
    const float4 b = *reinterpret_cast<const float4*>(Bs + k * N + tn * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Stage rows [r0, r0+kKC) x cols [c0, c0+N) of a row-major (rows, cols) weight
// matrix into Bs [kKC][N] as fp32, zero outside the matrix.
template <typename T, int N>
__device__ __forceinline__ void stage_weights(float* Bs, const T* __restrict__ w, int rows,
                                              int cols, int r0, int c0) {
  for (int idx = threadIdx.x; idx < kKC * N; idx += kThreads) {
    const int r = r0 + idx / N, c = c0 + idx % N;
    Bs[idx] = (r < rows && c < cols) ? to_f(w[(size_t)r * cols + c]) : 0.f;
  }
}

}  // namespace unet
