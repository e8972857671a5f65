// Shared pieces of the training-chain kernels (chain_fwd.cu, chain_bwd.cu,
// tail_pool.cu): the position-hash dropout bits and a deterministic
// cross-block column sum.
//
// Reductions across blocks never use atomics: each block writes its partial
// sums to a row of a [rows][cols] fp32 matrix, and reduce_rows() sums the
// rows in a fixed order (each thread of colsum_kernel walks a fixed subset
// of rows, then a fixed-order sum over the 8 subsets), so a run is
// bit-reproducible.
#pragma once

#include "sepconv_common.cuh"

namespace unet {

constexpr int kHalo = kTile + 2;          // a tile plus its 1-pixel ring
constexpr int kHaloPx = kHalo * kHalo;    // 100 pixels
constexpr int kRedRows = 512;             // rows one colsum block sums

// murmur3 fmix32 of idx ^ seed, keep iff the low 31 bits fall under thresh
// (ops/hash_dropout.py of both packages).
__device__ __forceinline__ bool hash_keep(uint32_t idx, uint32_t seed, uint32_t thresh) {
  uint32_t h = idx ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (h & 0x7FFFFFFFu) < thresh;
}

// a*x + b with the product and the sum each rounded, as the plain PyTorch
// versions compute it (no FMA contraction), so ReLU masks and pool ties
// decided on it agree with them bit for bit.
__device__ __forceinline__ float affine_rn(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// Flat logical NHWC index of (b, y, x, c), mod 2^32 like the int32 original.
__device__ __forceinline__ uint32_t logical_idx(int b, int y, int x, int c, int H, int W, int C) {
  return (uint32_t)(((((uint64_t)b * H + y) * W + x) * C) + c);
}

namespace {

// out[blockIdx.y][col] = sum of in[r][col] over the block's kRedRows rows.
// Block (32, 8), grid (ceil(cols/32), ceil(rows/kRedRows)).
__global__ void colsum_kernel(const float* __restrict__ in, int rows, int cols,
                              float* __restrict__ out) {
  __shared__ float red[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * kRedRows;
  const int r1 = min(rows, r0 + kRedRows);
  float s = 0.f;
  if (col < cols)
    for (int r = r0 + threadIdx.y; r < r1; r += 8) s += in[(size_t)r * cols + col];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][threadIdx.x];
    out[(size_t)blockIdx.y * cols + col] = t;
  }
}

// Floats of scratch reduce_rows() needs for a [rows][cols] input.
inline long long reduce_scratch_floats(long long rows, long long cols) {
  long long total = 0;
  while (rows > kRedRows) {
    rows = (rows + kRedRows - 1) / kRedRows;
    total += rows * cols;
  }
  return total;
}

// out[col] = sum over rows of in[rows][cols], in a fixed order. Returns
// cudaGetLastError() after the launches.
inline int reduce_rows(const float* in, int rows, int cols, float* scratch, float* out,
                       cudaStream_t stream) {
  const dim3 block(32, 8);
  const int gx = (cols + 31) / 32;
  while (rows > kRedRows) {
    const int g = (rows + kRedRows - 1) / kRedRows;
    colsum_kernel<<<dim3(gx, g), block, 0, stream>>>(in, rows, cols, scratch);
    in = scratch;
    scratch += (size_t)g * cols;
    rows = g;
  }
  colsum_kernel<<<dim3(gx, 1), block, 0, stream>>>(in, rows, cols, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace unet
