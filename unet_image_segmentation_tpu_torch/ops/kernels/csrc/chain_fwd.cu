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
// Σy and Σy² in fp32 over the rounded y. The masks are the ones K2 rebuilds
// from the same x (hash_keep, __fmul_rn, affine_rn). The halo mode
// (row-sharded training, the TPU kernel's has_halo): with a halo (B, 2, W, C)
// of z rows, the 'same' padding rows above and below the shard are the
// neighbours' rows (row 0 above, row 1 below; zeros at the image's edge),
// staged by the body and left alone by the prologue, since they are z
// already; Σy and Σy² cover the shard's own rows. Dropout and the halo are
// exclusive (the caller checks it): row-sharded chains drop out before
// the chain.
//
// What bounds it on the H100: per pixel 9C + C*F multiply-adds for C + F
// elements moved; with the products on the tensor cores the bytes bound it
// in bf16 (sepconv_fwd.cuh, as K8).
//
// Design: the forward body of sepconv_fwd.cuh (a thread-block cluster per
// 8x8 tile over slices of F, the depthwise once per tile through
// distributed shared memory, the products on mma.sync: bf16 m16n8k16, fp32
// 3xTF32) with
//   * the prologue: the dropout or the affine + ReLU applied in place to
//     the staged share of each chunk's 10x10 halo, once per element (a
//     thread keeps one 16-byte channel group, its affine in registers),
//     leaving pixels outside the image and channels >= C zero;
//   * the epilogue: y rounded to T and stored (the body's store_tile); each
//     thread's column sums of y and y² over its four fragment rows, a
//     fixed-order shuffle sum over the 8 row groups of a warp, the two warps
//     of a column added through shared memory in a fixed order, into the
//     per-tile partials [B * tiles][2F] that reduce_rows() sums in a fixed
//     order: no atomics, bit-reproducible.
//
// K9, the per-block training forward (unet_sepconv_stats below), replaces
// the TPU kernel unet_image_segmentation_tpu/ops/pallas/fused_sepconv.py:
// _sepconv_kernel_db_stats (launched by _fused_sepconv_stats_impl from
// sepconv_apply_stats): y = (dw3x3(x) -> T) . pw rounded to T, and Σy, Σy²
// over the rounded y. That is K1's function without a prologue, so its
// entry sepconv_stats_kernel runs the same body (no prologue) and the same
// epilogue, and takes the same plan; it keeps an entry of its own so a
// profile tells it from K1. Bound as K1 (the bytes in bf16: 1.27 ms over
// the U-Net's 18 blocks at batch 32).
#include "sepconv_fwd.cuh"
#include "train_common.cuh"

namespace unet {
namespace {

// The epilogue of K1 and K9: y rounded to T and stored; each thread's column
// sums of y and y² over its rows in the image, a fixed-order shuffle sum
// over the warp's 8 row groups (lanes g), then the two warps of a column
// (wm) through shared memory (red [2 wm][2][W]), into the tile's row of the
// per-tile partials [B * tiles][2F].
template <typename T, int W>
__device__ __forceinline__ void stats_epilogue(const FwdArgs<T>& a, float (&acc)[2][W / 32][4],
                                               const FwdTile& t, T* y, float* partials,
                                               float* red) {
  constexpr int NT = W / 32;
  const int H = a.H, Wd = a.W, F = a.F;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp & 3, wm = warp >> 2, g = lane >> 2, tq = lane & 3;
  float sum[NT][2] = {}, sq[NT][2] = {};
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int col = wn * 8 * NT + ni * 8 + 2 * tq;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool inside = t.ty0 + 2 * (wm * 2 + mi) + h < H && t.tx0 + g < Wd;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float v = round_to<T>(acc[mi][ni][2 * h + jj]);
          acc[mi][ni][2 * h + jj] = v;
          if (inside && col + jj < t.len) {
            sum[ni][jj] += v;
            sq[ni][jj] += v * v;
          }
        }
      }
  }
  store_tile<T, W>(a, acc, t, y);
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sum[ni][jj] += __shfl_xor_sync(0xffffffffu, sum[ni][jj], o);
        sq[ni][jj] += __shfl_xor_sync(0xffffffffu, sq[ni][jj], o);
      }
      if (g == 0) {
        const int col = wn * 8 * NT + ni * 8 + 2 * tq + jj;
        red[(wm * 2 + 0) * W + col] = sum[ni][jj];
        red[(wm * 2 + 1) * W + col] = sq[ni][jj];
      }
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * W; i += kThreads) {
    const int which = i / W, col = i % W;
    if (col < t.len)
      partials[((size_t)t.b * a.tiles + t.tile) * 2 * F + which * F + t.f0 + col] =
          red[which * W + col] + red[(2 + which) * W + col];
  }
}

// K1: the links of the tiles of cluster blockIdx.x / a.n. kPrologue: the
// dropout (thresh != 0) or the affine (in_aff) runs on the staged x.
template <typename T, int W, bool kPrologue>
__global__ void __launch_bounds__(kThreads, 2)
    chain_fwd_kernel(const FwdArgs<T> a, const float* __restrict__ in_aff, T* __restrict__ y,
                     float* __restrict__ partials, uint32_t seed, uint32_t thresh,
                     float drop_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KC = ChunkCfg<T>::KC, V = ChunkCfg<T>::V, G = KC / V;
  const int H = a.H, Wd = a.W, C = a.C;
  // z of the staged share in place, once per element: a thread keeps one
  // channel group (its affine in registers) and walks the halo's pixels;
  // bf16 rounds z as it packs it
  auto prologue = [&](T* xs, int cs, int len, const FwdTile& t) {
    const int v = threadIdx.x % G, c = cs + v * V;
    if (v * V >= len) return;
    float ca[V], cb[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool ok = in_aff != nullptr && c + j < C;
      ca[j] = ok ? in_aff[c + j] : 0.f;
      cb[j] = ok ? in_aff[C + c + j] : 0.f;
    }
    for (int p = threadIdx.x / G; p < kFwdHaloPx; p += kThreads / G) {
      const int Y = t.ty0 - 1 + p / kFwdHalo, X = t.tx0 - 1 + p % kFwdHalo;
      // outside the image: 0, or in the halo mode rows -1 and H, already z
      if (Y < 0 || Y >= H || X < 0 || X >= Wd) continue;
      uint4* q = reinterpret_cast<uint4*>(xs + p * KC + v * V);
      float z[V];
      unpack(*q, z);
      if (thresh) {  // channels >= C hold 0, which the dropout keeps 0
        const uint32_t base = logical_idx(t.b, Y, X, c, H, Wd, C);
#pragma unroll
        for (int j = 0; j < V; ++j)
          z[j] = hash_keep(base + j, seed, thresh) ? __fmul_rn(z[j], drop_scale) : 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          z[j] = c + j < C ? fmaxf(affine_rn(z[j], ca[j], cb[j]), 0.f) : 0.f;
      }
      *q = pack(z);
    }
  };
  float* red = reinterpret_cast<float*>(smem + FwdSmem<T, W>::red);
  sepconv_fwd_tiles<T, W, kPrologue>(a, smem, prologue,
                                     [&](float (&acc)[2][W / 32][4], const FwdTile& t) {
                                       stats_epilogue<T, W>(a, acc, t, y, partials, red);
                                     });
}

// K9: the blocks of the tiles of cluster blockIdx.x / a.n; K1's body and
// epilogue without a prologue.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2)
    sepconv_stats_kernel(const FwdArgs<T> a, T* __restrict__ y, float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + FwdSmem<T, W>::red);
  sepconv_fwd_tiles<T, W, false>(a, smem, [](T*, int, int, const FwdTile&) {},
                                 [&](float (&acc)[2][W / 32][4], const FwdTile& t) {
                                   stats_epilogue<T, W>(a, acc, t, y, partials, red);
                                 });
}

// Per-tile partial rows of Σy and Σy² (K1 and K9): [B * tiles][2F].
struct SumRows {
  int tiles_x, tiles;
  long long rows, cols;
};

SumRows sum_rows(int B, int H, int W, int F) {
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  return {tiles_x, tiles_x * tiles_y, (long long)B * tiles_x * tiles_y, 2LL * F};
}

template <typename T, int W>
int launch_link(const FwdArgs<T>& a, const float* in_aff, T* y, float* partials, int smem,
                uint32_t seed, uint32_t thresh, float drop_scale, cudaStream_t stream) {
  auto kernel = in_aff != nullptr || thresh != 0 ? chain_fwd_kernel<T, W, true>
                                                 : chain_fwd_kernel<T, W, false>;
  return launch_fwd(kernel, a, smem, stream, in_aff, y, partials, seed, thresh, drop_scale);
}

template <typename T>
int launch_chain(const void* x, const void* dw, const void* pw, const void* in_aff,
                 const void* halo, void* y, float* work, float* sums, int B, int H, int W, int C,
                 int F, int seed, int thresh, float drop_scale, int n, int s, int width, int per,
                 int smem, cudaStream_t stream) {
  if (!fwd_plan_ok<T>(B, H, W, C, F, n, s, width, per, smem) || (halo != nullptr && thresh))
    return (int)cudaErrorInvalidValue;
  const SumRows rows = sum_rows(B, H, W, F);
  float* partials = work;
  float* scratch = work + rows.rows * rows.cols;
  const FwdArgs<T> a = fwd_args<T>(x, dw, pw, B, H, W, C, F, n, s, per, halo);
  const float* aff = static_cast<const float*>(in_aff);
  T* out = static_cast<T*>(y);
  const int err = width == 64 ? launch_link<T, 64>(a, aff, out, partials, smem, (uint32_t)seed,
                                                   (uint32_t)thresh, drop_scale, stream)
                              : launch_link<T, 128>(a, aff, out, partials, smem, (uint32_t)seed,
                                                    (uint32_t)thresh, drop_scale, stream);
  if (err) return err;
  return reduce_rows(partials, (int)rows.rows, (int)rows.cols, scratch, sums, stream);
}

template <typename T>
int launch_stats(const void* x, const void* dw, const void* pw, void* y, float* work,
                 float* sums, int B, int H, int W, int C, int F, int n, int s, int width, int per,
                 int smem, cudaStream_t stream) {
  if (!fwd_plan_ok<T>(B, H, W, C, F, n, s, width, per, smem)) return (int)cudaErrorInvalidValue;
  const SumRows rows = sum_rows(B, H, W, F);
  float* partials = work;
  float* scratch = work + rows.rows * rows.cols;
  const FwdArgs<T> a = fwd_args<T>(x, dw, pw, B, H, W, C, F, n, s, per);
  T* out = static_cast<T*>(y);
  const int err = width == 64
                      ? launch_fwd(sepconv_stats_kernel<T, 64>, a, smem, stream, out, partials)
                      : launch_fwd(sepconv_stats_kernel<T, 128>, a, smem, stream, out, partials);
  if (err) return err;
  return reduce_rows(partials, (int)rows.rows, (int)rows.cols, scratch, sums, stream);
}

}  // namespace
}  // namespace unet

// Floats of workspace unet_chain_fwd and unet_sepconv_stats need.
extern "C" long long unet_chain_fwd_workspace(int B, int H, int W, int C, int F) {
  (void)C;
  const unet::SumRows p = unet::sum_rows(B, H, W, F);
  return p.rows * p.cols + unet::reduce_scratch_floats(p.rows, p.cols);
}

// x (B,H,W,C), dw (3,3,C), pw (C,F) in T; in_aff (2,C) fp32 or null; halo
// (B,2,W,C) in T or null (the halo mode; not with dropout); y (B,H,W,F) in
// T; sums (2,F) fp32 = Σy, Σy². thresh 0 = no dropout.
// (n, s, width, per, smem) is the launch plan of fwd_plan
// (ops/fused_train.py), checked against sepconv_fwd.cuh's layout. dtype: 0
// = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int unet_chain_fwd(const void* x, const void* dw, const void* pw, const void* in_aff,
                              const void* halo, void* y, void* work, void* sums, int B, int H,
                              int W, int C, int F, int seed, int thresh, float drop_scale, int n,
                              int s, int width, int per, int smem, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(sums);
  if (dtype == 0)
    return unet::launch_chain<float>(x, dw, pw, in_aff, halo, y, w, o, B, H, W, C, F, seed,
                                     thresh, drop_scale, n, s, width, per, smem, st);
  if (dtype == 1)
    return unet::launch_chain<__nv_bfloat16>(x, dw, pw, in_aff, halo, y, w, o, B, H, W, C, F,
                                             seed, thresh, drop_scale, n, s, width, per, smem,
                                             st);
  return (int)cudaErrorInvalidValue;
}

// K9: x (B,H,W,C), dw (3,3,C), pw (C,F) in T; y (B,H,W,F) in T; sums (2,F)
// fp32 = Σy, Σy². Workspace as unet_chain_fwd_workspace; (n, s, width, per,
// smem) the plan of fwd_plan, as unet_chain_fwd takes it. Returns
// cudaGetLastError().
extern "C" int unet_sepconv_stats(const void* x, const void* dw, const void* pw, void* y,
                                  void* work, void* sums, int B, int H, int W, int C, int F,
                                  int n, int s, int width, int per, int smem, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(sums);
  if (dtype == 0)
    return unet::launch_stats<float>(x, dw, pw, y, w, o, B, H, W, C, F, n, s, width, per, smem,
                                     st);
  if (dtype == 1)
    return unet::launch_stats<__nv_bfloat16>(x, dw, pw, y, w, o, B, H, W, C, F, n, s, width,
                                             per, smem, st);
  return (int)cudaErrorInvalidValue;
}
