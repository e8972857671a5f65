// K2: one backward link of a training chain.
//
// Replaces the TPU kernel unet_image_segmentation_tpu/ops/pallas/
// fused_train.py:_bwd_train_kernel (launched by _bwd_train_packed /
// _bwd_train_pallas from _chain_bwd_links). Per link, from the three streams
// x (the link's input, pre-affine), g (raw cotangent of the link's output)
// and y (the link's raw output), and per-channel constants:
//
//   gy  = A*(g [* (a_out*y + b_out > 0)]) + B + (y - mean_out)*C  -> T
//         (the link's own BatchNorm backward; zero outside the image)
//   z   = relu(in_a*x + in_b) (links after the first) | dropout(x) | x,
//         recomputed in fp32, zero outside the image
//   dm  = gy . pw^T                       (fp32)
//   dz  = 3x3 correlation of dm with the flipped taps
//   dx  = dz * (in_a*x + in_b > 0) -> T, with S = Σdx~ and
//         T = Σdx~*(x - in_mean)*in_rstd from the fp32 dx~ (links k > 0);
//         dropout(dz) -> T on a chain's first link with dropout; dz -> T
//   ddw = Σ shifted z * dm               (fp32)
//   m   = depthwise(z) -> T,  dpw = m^T . gy   (fp32)
//
// Rounding points are the Pallas kernel's: gy and m to T, dz/dm/z in fp32,
// dx written in T.
//
// What bounds it on the H100: two products of C*F multiply-adds per pixel
// (dm and dpw) on fp32 FMAs, plus the recomputed depthwise; it reads x, g,
// y and writes dx once per pixel, so like K1 it is FMA-bound at the
// U-Net's widths.
//
// Design, two passes:
//  (a) chain_bwd_tile_kernel: one block per 8x8 output tile and 64-wide C
//      chunk, 256 threads. It builds gy over the 10x10 tile-plus-ring in
//      32-wide F chunks in shared memory and multiplies it by pw^T into dm
//      (a register GEMM, 8 pixels x 4 channels a thread). With dm and the
//      recomputed z of the ring in shared memory it forms dz, dx, m, and the
//      per-block partials of ddw, S and T. It stores m (T) and, from the
//      first C chunk's blocks, gy (T) for pass (b). Recompute: dm and z over
//      100 pixels for 64 outputs (1.56x), gy once per C chunk (ceil(C/64) x
//      1.56x the elementwise work).
//  (b) chain_bwd_dpw_kernel: dpw = m^T . gy as a split-K GEMM over pixels,
//      64x64 output tiles, one partial per split.
// Every cross-block sum (ddw, S, T over tiles; dpw over splits) goes
// through reduce_rows(): fixed order, bit-reproducible. The sums run over
// B*H*W pixels (2M at the 256 px stage of batch 32) in fp32.
//
// K10, the per-block training backward (unet_sepconv_bwd below), is these
// two passes in their plain mode: no BatchNorm backward (comb null, so
// gy = g and pass (b) reads g itself), no input transform, no dropout, and
// pass (b) also sums dbias = Σg over its split's pixels; its __global__
// entries sepconv_bwd_tile_kernel and sepconv_bwd_dpw_kernel inline the
// passes' bodies with that mode compiled in. It replaces the TPU
// kernel unet_image_segmentation_tpu/ops/pallas/fused_sepconv_bwd.py:
// _bwd_kernel (launched by sepconv_bwd_pallas): dm = g . pw^T in fp32,
// dx = the correlation of dm with the flipped taps (written in T),
// ddw = Σ shifted x * dm, m = depthwise(x) -> T, dpw = m^T . g, dbias = Σg.
#include <algorithm>

#include "train_common.cuh"

namespace unet {
namespace {

constexpr int kTileC = 64;                 // C channels per pass-(a) block
constexpr int kM = 128;                    // GEMM rows: the 100 ring pixels, padded
constexpr int kLdM = kM + 4;               // row stride of the gy chunk [k][kM]
constexpr int kGyFloats = kKC * kLdM;      // gy chunk, [f][px]
constexpr int kPwFloats = kKC * kTileC;    // pw^T chunk, [f][c]
constexpr int kDmFloats = kHaloPx * kTileC;  // dm over the ring, [px][c]
constexpr int kZFloats = kHaloPx * kTileC;   // z over the ring, [px][c]
constexpr int kTileSmem = (kGyFloats + kPwFloats + kDmFloats + kZFloats) * 4;
constexpr int kNSums = 11;                 // ddw (9), S, T

// Pass (a) of one block: the tile blockIdx.x, the C chunk blockIdx.y, sample
// blockIdx.z. comb null: the plain mode (gy = g; yv and gy_out unused).
template <typename T>
__device__ __forceinline__ void chain_bwd_tile(const T* __restrict__ x, const T* __restrict__ g,
                                               const T* __restrict__ yv,
                                               const float* __restrict__ in_aff,
                                               const float* __restrict__ comb,
                                               const T* __restrict__ dw,
                                               const T* __restrict__ pwt_g, T* __restrict__ dx,
                                               T* __restrict__ m_out, T* __restrict__ gy_out,
                                               float* __restrict__ partials, int H, int W, int C,
                                               int F, int tiles_x, int mask_combine,
                                               uint32_t seed, uint32_t thresh, float drop_scale) {
  extern __shared__ __align__(16) float smem[];
  float* gys = smem;                    // [kKC][kLdM]
  float* pwt = gys + kGyFloats;         // [kKC][kTileC]
  float* dms = pwt + kPwFloats;         // [kHaloPx][kTileC]
  float* zs = dms + kDmFloats;          // [kHaloPx][kTileC]
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * kTile;
  const int tx0 = (tile % tiles_x) * kTile;
  const int c0 = blockIdx.y * kTileC;
  const int b = blockIdx.z;
  const size_t img = (size_t)b * H * W;

  // ---- dm = gy . pw^T over the 100 ring pixels, K = F in chunks of 32 ----
  const int tn = tid % (kTileC / 4);   // 4 channels each
  const int tm = tid / (kTileC / 4);   // 8 pixels each (16 x 8 = kM)
  float acc[8][4] = {};
  const int k = tid % kKC;
  const int prow = tid / kKC;
  constexpr int kRowStep = kThreads / kKC;  // 8
  for (int f0 = 0; f0 < F; f0 += kKC) {
    const int kf = min(kKC, F - f0);
    const int f = f0 + k;
    float cA = 0.f, cB = 0.f, cC = 0.f, cMean = 0.f, cA_out = 0.f, cB_out = 0.f;
    if (comb && k < kf) {
      cA = comb[f];
      cB = comb[F + f];
      cC = comb[2 * F + f];
      cMean = comb[3 * F + f];
      cA_out = comb[4 * F + f];
      cB_out = comb[5 * F + f];
    }
    for (int p = prow; p < kM; p += kRowStep) {
      const int Y = ty0 - 1 + p / kHalo, X = tx0 - 1 + p % kHalo;
      float v = 0.f;
      if (p < kHaloPx && k < kf && Y >= 0 && Y < H && X >= 0 && X < W) {
        const size_t o = (img + (size_t)Y * W + X) * F + f;
        if (comb) {
          float gf = to_f(g[o]);
          const float yf = to_f(yv[o]);
          if (mask_combine && !(affine_rn(yf, cA_out, cB_out) > 0.f)) gf = 0.f;
          const T t = from_f<T>(gf * cA + cB + (yf - cMean) * cC);
          v = to_f(t);
          const int r = p / kHalo, cc = p % kHalo;
          if (blockIdx.y == 0 && r >= 1 && r <= kTile && cc >= 1 && cc <= kTile) gy_out[o] = t;
        } else {
          v = to_f(g[o]);  // plain mode (K10): gy = g
        }
      }
      gys[k * kLdM + p] = v;
    }
    // pw^T chunk from the transposed pointwise (F, C)
    for (int idx = tid; idx < kKC * kTileC; idx += kThreads) {
      const int kk = idx / kTileC, n = idx % kTileC;
      const int c = c0 + n, ff = f0 + kk;
      pwt[kk * kTileC + n] = (c < C && ff < F) ? to_f(pwt_g[(size_t)ff * C + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kf; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(gys + kk * kLdM + tm * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(gys + kk * kLdM + tm * 8 + 4);
      const float4 bb = *reinterpret_cast<const float4*>(pwt + kk * kTileC + tn * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = tm * 8 + i;
    if (p >= kHaloPx) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) dms[p * kTileC + tn * 4 + j] = acc[i][j];
  }

  // ---- z over the ring, fp32, zero outside the image and past C ----
  {
    const int cl = tid % kTileC, c = c0 + cl;
    for (int p = tid / kTileC; p < kHaloPx; p += kThreads / kTileC) {
      const int Y = ty0 - 1 + p / kHalo, X = tx0 - 1 + p % kHalo;
      float v = 0.f;
      if (c < C && Y >= 0 && Y < H && X >= 0 && X < W) {
        v = to_f(x[(img + (size_t)Y * W + X) * C + c]);
        if (in_aff)
          v = fmaxf(affine_rn(v, in_aff[c], in_aff[C + c]), 0.f);
        else if (thresh)
          v = hash_keep(logical_idx(b, Y, X, c, H, W, C), seed, thresh) ? v * drop_scale : 0.f;
      }
      zs[p * kTileC + cl] = v;
    }
  }
  __syncthreads();

  // ---- per channel, 16 center pixels a thread: dz, dx, m, ddw, S, T ----
  const int cl = tid % kTileC, c = c0 + cl;
  const int pg = tid / kTileC;  // rows 2*pg, 2*pg+1 of the tile
  float taps[9], ddw[9] = {}, s_sum = 0.f, t_sum = 0.f;
  float ia = 0.f, ib = 0.f, imean = 0.f, irstd = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) taps[t] = c < C ? to_f(dw[t * C + c]) : 0.f;
  if (in_aff && c < C) {
    ia = in_aff[c];
    ib = in_aff[C + c];
    imean = in_aff[2 * C + c];
    irstd = in_aff[3 * C + c];
  }
  for (int rr = 0; rr < 2; ++rr) {
    const int r = pg * 2 + rr;
#pragma unroll 2
    for (int cc = 0; cc < kTile; ++cc) {
      const int hp = (r + 1) * kHalo + cc + 1;  // ring index of the pixel
      float dz = 0.f, mv = 0.f;
      const float dmc = dms[hp * kTileC + cl];
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const float tap = taps[di * 3 + dj];
          dz += dms[(hp + (1 - di) * kHalo + (1 - dj)) * kTileC + cl] * tap;
          const float zv = zs[(hp + (di - 1) * kHalo + (dj - 1)) * kTileC + cl];
          mv += zv * tap;
          ddw[di * 3 + dj] += zv * dmc;
        }
      const int Y = ty0 + r, X = tx0 + cc;
      if (c >= C || Y >= H || X >= W) continue;
      const size_t o = (img + (size_t)Y * W + X) * C + c;
      float d = dz;
      if (in_aff) {
        const float xv = to_f(x[o]);
        d = affine_rn(xv, ia, ib) > 0.f ? dz : 0.f;
        s_sum += d;
        t_sum += d * ((xv - imean) * irstd);
      } else if (thresh) {
        d = hash_keep(logical_idx(b, Y, X, c, H, W, C), seed, thresh) ? dz * drop_scale : 0.f;
      }
      dx[o] = from_f<T>(d);
      m_out[o] = from_f<T>(mv);
    }
  }

  // fixed-order sum of the 4 pixel groups' partials, one row per tile
  float* red = smem;  // [4][kNSums][kTileC], the gy/pw chunks are free now
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 9; ++q) red[(pg * kNSums + q) * kTileC + cl] = ddw[q];
  red[(pg * kNSums + 9) * kTileC + cl] = s_sum;
  red[(pg * kNSums + 10) * kTileC + cl] = t_sum;
  __syncthreads();
  if (pg == 0 && c < C) {
    float* row = partials + ((size_t)b * gridDim.x + tile) * kNSums * C;
    for (int q = 0; q < kNSums; ++q) {
      float t = 0.f;
      for (int i = 0; i < kThreads / kTileC; ++i) t += red[(i * kNSums + q) * kTileC + cl];
      row[q * C + c] = t;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chain_bwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const T* __restrict__ yv, const float* __restrict__ in_aff,
                          const float* __restrict__ comb, const T* __restrict__ dw,
                          const T* __restrict__ pwt_g, T* __restrict__ dx, T* __restrict__ m_out,
                          T* __restrict__ gy_out, float* __restrict__ partials, int H, int W,
                          int C, int F, int tiles_x, int mask_combine, uint32_t seed,
                          uint32_t thresh, float drop_scale) {
  chain_bwd_tile<T>(x, g, yv, in_aff, comb, dw, pwt_g, dx, m_out, gy_out, partials, H, W, C, F,
                    tiles_x, mask_combine, seed, thresh, drop_scale);
}

// K10's pass (a): the plain mode
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sepconv_bwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            const T* __restrict__ dw, const T* __restrict__ pwt_g,
                            T* __restrict__ dx, T* __restrict__ m_out,
                            float* __restrict__ partials, int H, int W, int C, int F,
                            int tiles_x) {
  chain_bwd_tile<T>(x, g, nullptr, nullptr, nullptr, dw, pwt_g, dx, m_out, nullptr, partials, H,
                    W, C, F, tiles_x, 0, 0u, 0u, 1.f);
}

// part[split][c * F + f] = Σ over the split's pixels of m[p][c] * gy[p][f];
// with kBias, also part[split][C * F + f] = Σ gy[p][f] (from the blocks of
// the first C tile). Rows of part are cols floats apart.
template <typename T, bool kBias>
__device__ __forceinline__ void chain_bwd_dpw(const T* __restrict__ m, const T* __restrict__ gy,
                                              float* __restrict__ part, int P, int C, int F,
                                              int px_per_split, long long cols) {
  __shared__ __align__(16) float ms[kKC * kLdA64];   // [p][c]
  __shared__ __align__(16) float gs[kKC * kTileF];   // [p][f]
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kTileF, c0 = blockIdx.y * kTileC;
  const int p_begin = blockIdx.z * px_per_split;
  const int p_end = min(P, p_begin + px_per_split);
  const int tm = tid / (kTileF / 4), tn = tid % (kTileF / 4);
  const bool sums_bias = kBias && blockIdx.y == 0 && tm == 0;
  float acc[4][4] = {}, bsum[4] = {};
  for (int p0 = p_begin; p0 < p_end; p0 += kKC) {
    const int kp = min(kKC, p_end - p0);
    for (int idx = tid; idx < kKC * kTileC; idx += kThreads) {
      const int kk = idx / kTileC, n = idx % kTileC;
      const int c = c0 + n;
      ms[kk * kLdA64 + n] = (kk < kp && c < C) ? to_f(m[(size_t)(p0 + kk) * C + c]) : 0.f;
    }
    for (int idx = tid; idx < kKC * kTileF; idx += kThreads) {
      const int kk = idx / kTileF, n = idx % kTileF;
      const int f = f0 + n;
      gs[kk * kTileF + n] = (kk < kp && f < F) ? to_f(gy[(size_t)(p0 + kk) * F + f]) : 0.f;
    }
    __syncthreads();
    smem_gemm<kLdA64, kTileF>(acc, ms, gs, kp, tm, tn);
    if (sums_bias)
      for (int kk = 0; kk < kp; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) bsum[j] += gs[kk * kTileF + tn * 4 + j];
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * cols;
  if (sums_bias)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tn * 4 + j;
      if (f < F) out[(size_t)C * F + f] = bsum[j];
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + tm * 4 + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tn * 4 + j;
      if (f < F) out[(size_t)c * F + f] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chain_bwd_dpw_kernel(const T* __restrict__ m, const T* __restrict__ gy,
                         float* __restrict__ part, int P, int C, int F, int px_per_split,
                         long long cols) {
  chain_bwd_dpw<T, false>(m, gy, part, P, C, F, px_per_split, cols);
}

// K10's pass (b): dpw and dbias
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sepconv_bwd_dpw_kernel(const T* __restrict__ m, const T* __restrict__ g,
                           float* __restrict__ part, int P, int C, int F, int px_per_split,
                           long long cols) {
  chain_bwd_dpw<T, true>(m, g, part, P, C, F, px_per_split, cols);
}

struct BwdPlan {
  int tiles_x, tiles;
  long long rows_a, cols_a;   // tile partials [B*tiles][11*C]
  int splits, px_per_split;   // pass (b)
  long long cols_b;           // C*F, plus F for the bias row
};

BwdPlan bwd_plan(int B, int H, int W, int C, int F, bool bias_row) {
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const long long P = (long long)B * H * W;
  const int out_tiles = ((C + kTileC - 1) / kTileC) * ((F + kTileF - 1) / kTileF);
  // about 8 blocks per SM of a 132-SM card, at least 256 pixels a split
  long long splits = (1056 + out_tiles - 1) / out_tiles;
  splits = std::max(1LL, std::min(splits, (P + 255) / 256));
  long long per = (P + splits - 1) / splits;
  per = (per + kKC - 1) / kKC * kKC;
  splits = (P + per - 1) / per;
  return {tiles_x, tiles_x * tiles_y, (long long)B * tiles_x * tiles_y, (long long)kNSums * C,
          (int)splits, (int)per, (long long)C * F + (bias_row ? F : 0)};
}

long long bwd_workspace(const BwdPlan& p) {
  return p.rows_a * p.cols_a + reduce_scratch_floats(p.rows_a, p.cols_a) +
         (long long)p.splits * p.cols_b + reduce_scratch_floats(p.splits, p.cols_b);
}

template <typename T>
int launch(const void* x, const void* g, const void* y, const void* in_aff, const void* comb,
           const void* dw, const void* pwt, void* dx, void* m, void* gy, float* work,
           float* sums, float* dpw, int B, int H, int W, int C, int F, int mask_combine,
           int seed, int thresh, float drop_scale, cudaStream_t stream, bool plain = false) {
  const BwdPlan plan = bwd_plan(B, H, W, C, F, plain);
  float* part_a = work;
  float* scratch_a = part_a + plan.rows_a * plan.cols_a;
  float* part_b = scratch_a + reduce_scratch_floats(plan.rows_a, plan.cols_a);
  float* scratch_b = part_b + (long long)plan.splits * plan.cols_b;
  int err = (int)cudaFuncSetAttribute(
      plain ? (const void*)sepconv_bwd_tile_kernel<T> : (const void*)chain_bwd_tile_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (err) return err;
  const dim3 grid_a(plan.tiles, (C + kTileC - 1) / kTileC, B);
  if (plain)
    sepconv_bwd_tile_kernel<T><<<grid_a, kThreads, kTileSmem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(dw),
        static_cast<const T*>(pwt), static_cast<T*>(dx), static_cast<T*>(m), part_a, H, W, C, F,
        plan.tiles_x);
  else
    chain_bwd_tile_kernel<T><<<grid_a, kThreads, kTileSmem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(y),
        static_cast<const float*>(in_aff), static_cast<const float*>(comb),
        static_cast<const T*>(dw), static_cast<const T*>(pwt), static_cast<T*>(dx),
        static_cast<T*>(m), static_cast<T*>(gy), part_a, H, W, C, F, plan.tiles_x, mask_combine,
        (uint32_t)seed, (uint32_t)thresh, drop_scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = reduce_rows(part_a, (int)plan.rows_a, (int)plan.cols_a, scratch_a, sums, stream)))
    return err;
  const dim3 grid_b((F + kTileF - 1) / kTileF, (C + kTileC - 1) / kTileC, plan.splits);
  if (plain)  // K10: pass (b) reads the cotangent itself and sums dbias
    sepconv_bwd_dpw_kernel<T><<<grid_b, kThreads, 0, stream>>>(
        static_cast<const T*>(m), static_cast<const T*>(g), part_b, B * H * W, C, F,
        plan.px_per_split, plan.cols_b);
  else
    chain_bwd_dpw_kernel<T><<<grid_b, kThreads, 0, stream>>>(
        static_cast<const T*>(m), static_cast<const T*>(gy), part_b, B * H * W, C, F,
        plan.px_per_split, plan.cols_b);
  if ((err = (int)cudaGetLastError())) return err;
  return reduce_rows(part_b, plan.splits, (int)plan.cols_b, scratch_b, dpw, stream);
}

}  // namespace
}  // namespace unet

// Floats of workspace unet_chain_bwd needs.
extern "C" long long unet_chain_bwd_workspace(int B, int H, int W, int C, int F) {
  return unet::bwd_workspace(unet::bwd_plan(B, H, W, C, F, false));
}

// Floats of workspace unet_sepconv_bwd needs.
extern "C" long long unet_sepconv_bwd_workspace(int B, int H, int W, int C, int F) {
  return unet::bwd_workspace(unet::bwd_plan(B, H, W, C, F, true));
}

// x, dx, m (B,H,W,C) and g, y, gy (B,H,W,F) in T; dw (3,3,C) and the
// transposed pointwise pwt (F,C) in T;
// in_aff (4,C) fp32 or null; comb (6,F) fp32; sums (11,C) fp32 = ddw (9
// rows, tap-major), S, T; dpw (C,F) fp32. m and gy are pass-(a) outputs read
// by pass (b). thresh 0 = no dropout. Returns cudaGetLastError().
extern "C" int unet_chain_bwd(const void* x, const void* g, const void* y, const void* in_aff,
                              const void* comb, const void* dw, const void* pwt, void* dx,
                              void* m, void* gy, void* work, void* sums, void* dpw, int B, int H,
                              int W, int C, int F, int mask_combine, int seed, int thresh,
                              float drop_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(sums);
  float* d = static_cast<float*>(dpw);
  if (dtype == 0)
    return unet::launch<float>(x, g, y, in_aff, comb, dw, pwt, dx, m, gy, w, o, d, B, H, W, C,
                               F, mask_combine, seed, thresh, drop_scale, s);
  if (dtype == 1)
    return unet::launch<__nv_bfloat16>(x, g, y, in_aff, comb, dw, pwt, dx, m, gy, w, o, d, B, H,
                                       W, C, F, mask_combine, seed, thresh, drop_scale, s);
  return (int)cudaErrorInvalidValue;
}

// K10: x, dx, m (B,H,W,C) and g (B,H,W,F) in T; dw (3,3,C) and the
// transposed pointwise pwt (F,C) in T; sums (11,C) fp32 = ddw (9 rows,
// tap-major) and two zero rows; dpwb (C+1,F) fp32 = dpw, then dbias. m is a
// pass-(a) output read by pass (b). Returns cudaGetLastError().
extern "C" int unet_sepconv_bwd(const void* x, const void* g, const void* dw, const void* pwt,
                                void* dx, void* m, void* work, void* sums, void* dpwb, int B,
                                int H, int W, int C, int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(sums);
  float* d = static_cast<float*>(dpwb);
  if (dtype == 0)
    return unet::launch<float>(x, g, nullptr, nullptr, nullptr, dw, pwt, dx, m, nullptr, w, o, d,
                               B, H, W, C, F, 0, 0, 0, 1.f, s, true);
  if (dtype == 1)
    return unet::launch<__nv_bfloat16>(x, g, nullptr, nullptr, nullptr, dw, pwt, dx, m, nullptr,
                                       w, o, d, B, H, W, C, F, 0, 0, 0, 1.f, s, true);
  return (int)cudaErrorInvalidValue;
}
