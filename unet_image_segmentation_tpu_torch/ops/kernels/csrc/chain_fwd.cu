// K1: one forward link of a training chain,
//   z = dropout(x) | relu(a*x + b) | x,   y = (dw3x3(z) -> T) . pw,
// plus the link's BatchNorm sums Σy and Σy² (F,) over the rounded y.
//
// Replaces the TPU kernel unet_image_segmentation_tpu/ops/pallas/
// fused_train.py:_fwd_train_kernel (launched by _fwd_train_packed /
// _fwd_train_pallas from _chain_fwd_impl). Semantics kept: the optional hash
// dropout of the chain input from logical (b, h, w, c) and the seed, applied
// in fp32 and rounded to T; the optional input transform relu(a*x+b), the
// previous link's BatchNorm with batch moments folded into (a, b), rounded
// to T; 'same' zero padding in z space (pixels outside the image are 0
// AFTER the transform, since relu(b) != 0); the depthwise sum in fp32,
// rounded to T before the pointwise; the pointwise in fp32; y rounded to T;
// Σy and Σy² in fp32 over the rounded y. The halo mode (row-sharded
// training) is not ported.
//
// What bounds it on the H100: per pixel 9C + C*F multiply-adds for C + F
// elements moved, so at the U-Net's widths it is bound by fp32 FMA issue
// and shared-memory bandwidth, not by device memory (like K8).
//
// Design: K8's tiling (sepconv_block.cu): one block owns an 8x8 pixel tile
// and 64 output channels, 256 threads with a 4x4 register tile, and walks C
// in chunks of 32. Per chunk it stages the transformed input z over the
// 10x10 tile-plus-ring in shared memory once (the dropout hash and the
// affine run once per staged element, not once per tap), takes the depthwise
// from there, and feeds the register GEMM. The staging is redone for every
// 64-wide F tile (ceil(F/64) times) and covers 100/64 = 1.56x the tile's
// pixels. The per-block Σy/Σy² partials (a fixed-order sum over the 16
// threads of a channel column) go to a [tiles][2F] matrix that
// reduce_rows() sums in a fixed order: no atomics, bit-reproducible.
//
// K9, the per-block training forward (unet_sepconv_stats below), is this
// kernel with no input transform and no dropout: it replaces the TPU kernel
// unet_image_segmentation_tpu/ops/pallas/fused_sepconv.py:
// _sepconv_kernel_db_stats (launched by _fused_sepconv_stats_impl from
// sepconv_apply_stats): y = (dw3x3(x) -> T) . pw rounded to T, and Σy, Σy²
// over the rounded y. Its __global__ entry sepconv_stats_kernel inlines K1's
// tile body with the transform and dropout compiled out.
#include "train_common.cuh"

namespace unet {
namespace {

// One block's work: the tile blockIdx.x, the F tile blockIdx.y, sample
// blockIdx.z. in_aff null: no input transform; thresh 0: no dropout.
template <typename T>
__device__ __forceinline__ void chain_fwd_tile(const T* __restrict__ x, const T* __restrict__ dw,
                                               const T* __restrict__ pw,
                                               const float* __restrict__ in_aff,
                                               T* __restrict__ y, float* __restrict__ partials,
                                               int H, int W, int C, int F, int tiles_x,
                                               uint32_t seed, uint32_t thresh, float drop_scale) {
  __shared__ __align__(16) float zs[kHaloPx * kKC];   // z chunk over the tile + ring [px][k]
  __shared__ __align__(16) float dws[kKC * kLdA64];   // depthwise chunk [k][m]
  __shared__ __align__(16) float pws[kKC * kTileF];   // pointwise chunk [k][f]
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * kTile;
  const int tx0 = (tile % tiles_x) * kTile;
  const int f0 = blockIdx.y * kTileF;
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * C;
  const int tm = tid / (kTileF / 4), tn = tid % (kTileF / 4);
  float acc[4][4] = {};

  // lanes of a warp take 32 neighbouring channels of one pixel (coalesced)
  const int k = tid % kKC;
  const int prow = tid / kKC;                  // 0..7
  constexpr int kRowStep = kThreads / kKC;     // 8
  for (int c0 = 0; c0 < C; c0 += kKC) {
    const int kc = min(kKC, C - c0);
    const int c = c0 + k;
    for (int p = prow; p < kHaloPx; p += kRowStep) {
      const int Y = ty0 - 1 + p / kHalo, X = tx0 - 1 + p % kHalo;
      float v = 0.f;
      if (k < kc && Y >= 0 && Y < H && X >= 0 && X < W) {
        v = to_f(xb[((size_t)Y * W + X) * C + c]);
        if (thresh)
          v = hash_keep(logical_idx(b, Y, X, c, H, W, C), seed, thresh)
                  ? round_to<T>(__fmul_rn(v, drop_scale)) : 0.f;
        if (in_aff) v = round_to<T>(fmaxf(affine_rn(v, in_aff[c], in_aff[C + c]), 0.f));
      }
      zs[p * kKC + k] = v;
    }
    float taps[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) taps[t] = k < kc ? to_f(dw[t * C + c]) : 0.f;
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kTilePx / kRowStep; ++i) {
      const int m = prow + kRowStep * i;
      int r, cc;
      tile_px(m, r, cc);
      float s = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          s += zs[((r + di) * kHalo + cc + dj) * kKC + k] * taps[di * 3 + dj];
      dws[k * kLdA64 + m] = round_to<T>(s);
    }
    stage_weights<T, kTileF>(pws, pw, C, F, c0, f0);
    __syncthreads();
    smem_gemm<kLdA64, kTileF>(acc, dws, pws, kc, tm, tn);
    __syncthreads();
  }

  // y rounded to T; the sums are taken over the rounded values
  float s_loc[4] = {}, q_loc[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, cc;
    tile_px(tm * 4 + i, r, cc);
    const int Y = ty0 + r, X = tx0 + cc;
    if (Y >= H || X >= W) continue;
    T* o = y + (((size_t)b * H + Y) * W + X) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tn * 4 + j;
      if (f >= F) continue;
      const T t = from_f<T>(acc[i][j]);
      o[f] = t;
      const float v = to_f(t);
      s_loc[j] += v;
      q_loc[j] += v * v;
    }
  }
  // fixed-order sum over the 16 thread rows of each channel column
  float* red = dws;  // 2 x 16 x 64 floats, free after the last GEMM step
  constexpr int kRowsM = kThreads / (kTileF / 4);  // 16
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[tm * kTileF + tn * 4 + j] = s_loc[j];
    red[(kRowsM + tm) * kTileF + tn * 4 + j] = q_loc[j];
  }
  __syncthreads();
  if (tid < 2 * kTileF) {
    const int which = tid / kTileF, fl = tid % kTileF, f = f0 + fl;
    float t = 0.f;
    for (int i = 0; i < kRowsM; ++i) t += red[(which * kRowsM + i) * kTileF + fl];
    if (f < F) partials[((size_t)b * gridDim.x + tile) * 2 * F + which * F + f] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chain_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dw,
                     const T* __restrict__ pw, const float* __restrict__ in_aff,
                     T* __restrict__ y, float* __restrict__ partials, int H, int W, int C, int F,
                     int tiles_x, uint32_t seed, uint32_t thresh, float drop_scale) {
  chain_fwd_tile<T>(x, dw, pw, in_aff, y, partials, H, W, C, F, tiles_x, seed, thresh,
                    drop_scale);
}

// K9: the plain sepconv and its sums (no transform, no dropout)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sepconv_stats_kernel(const T* __restrict__ x, const T* __restrict__ dw,
                         const T* __restrict__ pw, T* __restrict__ y,
                         float* __restrict__ partials, int H, int W, int C, int F, int tiles_x) {
  chain_fwd_tile<T>(x, dw, pw, nullptr, y, partials, H, W, C, F, tiles_x, 0u, 0u, 1.f);
}

struct FwdPlan {
  int tiles_x, tiles;
  long long rows, cols;
};

FwdPlan fwd_plan(int B, int H, int W, int F) {
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  return {tiles_x, tiles_x * tiles_y, (long long)B * tiles_x * tiles_y, 2LL * F};
}

template <typename T>
int launch(const void* x, const void* dw, const void* pw, const void* in_aff, void* y,
           float* work, float* sums, int B, int H, int W, int C, int F, int seed, int thresh,
           float drop_scale, cudaStream_t stream, bool plain = false) {
  const FwdPlan plan = fwd_plan(B, H, W, F);
  float* partials = work;
  float* scratch = work + plan.rows * plan.cols;
  const dim3 grid(plan.tiles, (F + kTileF - 1) / kTileF, B);
  if (plain)
    sepconv_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dw), static_cast<const T*>(pw),
        static_cast<T*>(y), partials, H, W, C, F, plan.tiles_x);
  else
    chain_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dw), static_cast<const T*>(pw),
        static_cast<const float*>(in_aff), static_cast<T*>(y), partials, H, W, C, F,
        plan.tiles_x, (uint32_t)seed, (uint32_t)thresh, drop_scale);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_rows(partials, (int)plan.rows, (int)plan.cols, scratch, sums, stream);
}

}  // namespace
}  // namespace unet

// Floats of workspace unet_chain_fwd needs.
extern "C" long long unet_chain_fwd_workspace(int B, int H, int W, int C, int F) {
  (void)C;
  const unet::FwdPlan p = unet::fwd_plan(B, H, W, F);
  return p.rows * p.cols + unet::reduce_scratch_floats(p.rows, p.cols);
}

// x (B,H,W,C), dw (3,3,C), pw (C,F) in T; in_aff (2,C) fp32 or null; y
// (B,H,W,F) in T; sums (2,F) fp32 = Σy, Σy². thresh 0 = no dropout.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int unet_chain_fwd(const void* x, const void* dw, const void* pw, const void* in_aff,
                              void* y, void* work, void* sums, int B, int H, int W, int C, int F,
                              int seed, int thresh, float drop_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(sums);
  if (dtype == 0)
    return unet::launch<float>(x, dw, pw, in_aff, y, w, o, B, H, W, C, F, seed, thresh,
                               drop_scale, s);
  if (dtype == 1)
    return unet::launch<__nv_bfloat16>(x, dw, pw, in_aff, y, w, o, B, H, W, C, F, seed, thresh,
                                       drop_scale, s);
  return (int)cudaErrorInvalidValue;
}

// K9: x (B,H,W,C), dw (3,3,C), pw (C,F) in T; y (B,H,W,F) in T; sums (2,F)
// fp32 = Σy, Σy². Workspace as unet_chain_fwd_workspace. Returns
// cudaGetLastError().
extern "C" int unet_sepconv_stats(const void* x, const void* dw, const void* pw, void* y,
                                  void* work, void* sums, int B, int H, int W, int C, int F,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(sums);
  if (dtype == 0)
    return unet::launch<float>(x, dw, pw, nullptr, y, w, o, B, H, W, C, F, 0, 0, 1.f, s, true);
  if (dtype == 1)
    return unet::launch<__nv_bfloat16>(x, dw, pw, nullptr, y, w, o, B, H, W, C, F, 0, 0, 1.f, s,
                                       true);
  return (int)cudaErrorInvalidValue;
}
