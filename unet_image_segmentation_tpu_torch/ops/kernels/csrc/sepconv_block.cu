// K8: one inference sepconv block, y = relu?((dw3x3(x) -> T) . pw * scale + shift).
//
// Replaces the TPU kernel unet_image_segmentation_tpu/ops/pallas/fused_sepconv.py
// :_sepconv_kernel_db (launched by _fused_sepconv_fwd_impl, entered through
// fused_sepconv_bn_relu). Semantics kept: 'same' zero padding; the depthwise
// sum in fp32, rounded to the compute dtype T before the pointwise; the
// pointwise accumulated in fp32; scale/shift in fp32 (BatchNorm folded by the
// wrapper); the output in T.
//
// What bounds it on the H100: per pixel it does 9C + C*F multiply-adds and
// moves (C + F) elements. At the U-Net's widths (C, F >= 64) that is well
// above the fp32 CUDA-core balance point (~20 FLOP per byte), so this kernel,
// which runs its products as fp32 FMAs and not on the tensor cores, is bound
// by FMA issue and shared-memory bandwidth, not by device memory.
//
// Design: one block owns an 8x8 pixel tile and 64 output channels, 256
// threads, each holding a 4x4 register tile (4 pixels x 4 channels). It walks
// C in chunks of 32: the depthwise of the chunk (read straight from global
// memory, L1-cached) goes to shared memory as fp32 already rounded to T, the
// pointwise slice is staged beside it, and the register GEMM accumulates.
// The depthwise is recomputed once per 64-channel output tile, ceil(F/64)
// times in all, about 9/64 of the pointwise work per extra pass. Tensor
// cores (mma.sync / wgmma), TMA and pipelining are left for later work.
#include "sepconv_common.cuh"

namespace unet {
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sepconv_block_kernel(const T* __restrict__ x, const T* __restrict__ dw,
                         const T* __restrict__ pw, const float* __restrict__ scale,
                         const float* __restrict__ shift, T* __restrict__ out, int H, int W,
                         int C, int F, int tiles_x, int relu) {
  __shared__ __align__(16) float dws[kKC * kLdA64];  // depthwise chunk [k][m]
  __shared__ __align__(16) float pws[kKC * kTileF];  // pointwise chunk [k][f]
  const int tid = threadIdx.x;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int f0 = blockIdx.y * kTileF;
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * C;
  const int tm = tid / (kTileF / 4), tn = tid % (kTileF / 4);
  float acc[4][4] = {};

  // Depthwise work split: lanes of a warp take 32 neighbouring channels of
  // one pixel (coalesced reads); the 8 warps take interleaved pixels.
  const int k = tid % kKC;
  for (int c0 = 0; c0 < C; c0 += kKC) {
    const int kc = min(kKC, C - c0);
    const int c = c0 + k;
    float taps[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) taps[t] = k < kc ? to_f(dw[t * C + c]) : 0.f;
#pragma unroll 2
    for (int i = 0; i < kTilePx / (kThreads / kKC); ++i) {
      const int m = tid / kKC + (kThreads / kKC) * i;
      float s = 0.f;
      if (k < kc) {
        int r, cc;
        tile_px(m, r, cc);
        const int Y = ty0 + r, X = tx0 + cc;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const int yy = Y + di - 1;
          if (yy < 0 || yy >= H) continue;
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const int xx = X + dj - 1;
            if (xx < 0 || xx >= W) continue;
            s += to_f(xb[((size_t)yy * W + xx) * C + c]) * taps[di * 3 + dj];
          }
        }
      }
      dws[k * kLdA64 + m] = round_to<T>(s);
    }
    stage_weights<T, kTileF>(pws, pw, C, F, c0, f0);
    __syncthreads();
    smem_gemm<kLdA64, kTileF>(acc, dws, pws, kc, tm, tn);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, cc;
    tile_px(tm * 4 + i, r, cc);
    const int Y = ty0 + r, X = tx0 + cc;
    if (Y >= H || X >= W) continue;
    T* o = out + (((size_t)b * H + Y) * W + X) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tn * 4 + j;
      if (f >= F) continue;
      float v = acc[i][j] * scale[f] + shift[f];
      if (relu) v = fmaxf(v, 0.f);
      o[f] = from_f<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* dw, const void* pw, const void* scale, const void* shift,
           void* out, int B, int H, int W, int C, int F, int relu, cudaStream_t stream) {
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, (F + kTileF - 1) / kTileF, B);
  sepconv_block_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw), static_cast<const T*>(pw),
      static_cast<const float*>(scale), static_cast<const float*>(shift), static_cast<T*>(out),
      H, W, C, F, tiles_x, relu);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace unet

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int unet_sepconv_block(const void* x, const void* dw, const void* pw,
                                  const void* scale, const void* shift, void* out, int B, int H,
                                  int W, int C, int F, int relu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return unet::launch<float>(x, dw, pw, scale, shift, out, B, H, W, C, F, relu, s);
  if (dtype == 1)
    return unet::launch<__nv_bfloat16>(x, dw, pw, scale, shift, out, B, H, W, C, F, relu, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* unet_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
