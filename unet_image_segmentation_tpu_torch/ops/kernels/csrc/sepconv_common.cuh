// Shared pieces of the kernels: the block size, the 8x8 output tile and the
// conversions between T and fp32.
//
// Tensors are NHWC and contiguous. T is float or __nv_bfloat16 (the compute
// dtype). Every sum is taken in fp32, and values are rounded back to T
// exactly where the JAX reference rounds (the depthwise result before the
// pointwise, y1 before block 2, the block output).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace unet {

constexpr int kThreads = 256;             // threads per block
constexpr int kTile = 8;                  // output tile: kTile x kTile pixels
constexpr int kTilePx = kTile * kTile;    // 64 output pixels per block

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

}  // namespace unet
