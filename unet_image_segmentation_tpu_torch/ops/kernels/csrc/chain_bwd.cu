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
// (dm and dpw) and 27*C of elementwise multiply-adds (dz, ddw, m), while it
// reads x, g, y and writes dx once per pixel. The products run on the
// tensor cores (bf16 on mma.sync m16n8k16; fp32 as 3xTF32 on m16n8k8, three
// TF32 products each, since TF32 alone breaks the 1e-4 bar); the
// elementwise part stays on the CUDA cores in fp32. In bf16 the bytes bound
// the 256 px links and the operations the deep ones.
//
// Design, two passes (the plan is chain_bwd_plan in ops/fused_train.py; the
// entries refuse a plan whose shared-memory bytes differ from TileSmem /
// DpwSmem below):
//  (a) chain_bwd_tile_kernel: one CTA of 256 threads per 8x8 output tile and
//      WC-wide slice of C (WC = 64 for C <= 64, else 128). dm = gy . pw^T
//      over the 10x10 tile-plus-ring as a 112 x WC x F GEMM (the 100 ring
//      pixels in 7 m16 tiles) on the tensor cores, K = F in chunks of KC:
//      the 8 warps stand 2 along M by 4 along N; gy comes from ldmatrix
//      ([pixel][f]), pw is read as it is (C, F) -- the mma's column-major B,
//      [c][f] in shared memory, so no transposed copy exists. The chunks
//      flow through kStages shared-memory stages filled by cp.async (g and
//      y of the ring, the slice's pw rows and the chunk's BatchNorm-backward
//      constants), kStages - 1 chunks in flight, so a chunk's loads never
//      wait on the one before; gy is computed in place of g in its stage,
//      rounded to T, one chunk ahead of the products (one barrier a chunk,
//      the warps building and multiplying in the same interval). gy is built
//      once per tile and C slice: once per tile where C <= 128, C/128 times
//      at the deeper links (it was once per 64 channels). Then dm (from the
//      accumulators, fp32) and the ring's x (T, by cp.async) take the
//      stages' place, and the CUDA cores form z (recomputed in fp32), dz,
//      dx, m and the per-tile partials of ddw, S and T: one channel and
//      kRows tile rows a thread, in bands of two rows whose 4 x 3 window of
//      dm and z slides along the tile, so each ring value is loaded and
//      each z computed once a band. The CTAs of the first C slice also
//      store gy (T) for pass (b).
//  (b) chain_bwd_dpw_kernel: dpw = m^T . gy as a split-K GEMM over pixels
//      with TM x TN output tiles (128 wide, or 64 where C or F is <= 64) on
//      the tensor cores: m and gy chunks of KC pixels flow through kStages
//      stages by cp.async and are read through ldmatrix.trans (3xTF32 from
//      scalar fragments in fp32; in fp32 each mma depth into a fresh
//      fragment, added into the split's accumulator by a rounding fp32
//      add); one partial per split.
// Every cross-block sum (ddw, S, T over tiles; dpw over splits) goes
// through reduce_rows(): fixed order, bit-reproducible. The sums run over
// B*H*W pixels (2M at the 256 px stage of batch 32) in fp32.
//
// K10, the per-block training backward (unet_sepconv_bwd below), is these
// two passes in their plain mode: no BatchNorm backward (gy = g, and pass
// (b) reads g itself), no input transform, no dropout, and pass (b) also
// sums dbias = Σg over its split's pixels (the blocks of the first C tile);
// its __global__ entries sepconv_bwd_tile_kernel and sepconv_bwd_dpw_kernel
// inline the passes' bodies with that mode compiled in. It replaces the TPU
// kernel unet_image_segmentation_tpu/ops/pallas/fused_sepconv_bwd.py:
// _bwd_kernel (launched by sepconv_bwd_pallas): dm = g . pw^T in fp32,
// dx = the correlation of dm with the flipped taps (written in T),
// ddw = Σ shifted x * dm, m = depthwise(x) -> T, dpw = m^T . g, dbias = Σg.
#include <algorithm>
#include <type_traits>

#include "mma_common.cuh"
#include "train_common.cuh"

namespace unet {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kM = 112;     // pass-(a) GEMM rows: the 100 ring pixels in 7 m16 tiles
constexpr int kNSums = 11;  // ddw (9), S, T

// KC: the GEMM depth staged at once (F channels in pass (a), pixels in pass
// (b)); KS: the mma's depth; V: elements of T in 16 bytes.
template <typename T> struct BwdCfg;
template <> struct BwdCfg<bf16> { static constexpr int KC = 32, KS = 16, V = 8; };
template <> struct BwdCfg<float> { static constexpr int KC = 16, KS = 8, V = 4; };

// Pass (a)'s shared memory, in bytes; chain_bwd_plan (fused_train.py)
// mirrors it. kStages stages of a chunk, each g (then gy, in place)
// [kM][LDK], y [100][LDK] and pw [WC][LDK] in T (80-byte rows) and comb
// [6][KC] in fp32; after the GEMM, in their place, dm [100][LDD] in fp32 and
// the ring's x [100][LDD] in T; the per-tile sums [kThreads/WC][11][WC] take
// dm's place at the end.
constexpr int kStages = 4;
template <typename T, int WC>
struct TileSmem {
  static constexpr int KC = BwdCfg<T>::KC, LDK = KC + BwdCfg<T>::V, LDD = WC + 8;
  static constexpr int e = sizeof(T);
  static constexpr int g = 0, y = g + e * kM * LDK, w = y + e * kHaloPx * LDK;
  static constexpr int comb = w + e * WC * LDK, stage = comb + 4 * 6 * KC, S = kStages;
  static constexpr int dm = 0, x = dm + 4 * kHaloPx * LDD, epi_end = x + e * kHaloPx * LDD;
  static constexpr int bytes = S * stage > epi_end ? S * stage : epi_end;
};

// Pass (b)'s: kStages stages of m [KC][TM + 8] and gy [KC][TN + 8] in T.
template <typename T, int TM, int TN>
struct DpwSmem {
  static constexpr int KC = BwdCfg<T>::KC, LDA = TM + 8, LDB = TN + 8;
  static constexpr int ms = 0, gs = sizeof(T) * KC * LDA, stage = gs + sizeof(T) * KC * LDB;
  static constexpr int bytes = kStages * stage;
};

template <typename T>
struct TileArgs {
  const T* x;
  const T* g;
  const T* y;
  const float* in_aff;  // (4, C) or null
  const float* comb;    // (6, F); unused in the plain mode
  const T* dw;          // (3, 3, C)
  const T* pw;          // (C, F)
  T* dx;
  T* m;                 // (B, H, W, CM): C padded to a 16-byte row
  T* gy;                // pass (b)'s gy (chain mode)
  float* part;          // [B * tiles][11 * C]
  int H, W, C, CM, F, tiles_x, mask_combine;
  uint32_t seed, thresh;
  float drop_scale;
  int vec_f;  // F % V == 0 and g, y, gy, pw 16-byte aligned: vector loads along F
  int vec_x;  // C % V == 0 and x 16-byte aligned: cp.async staging of x
};

template <typename T>
struct DpwArgs {
  const T* m;   // (P, CM)
  const T* gy;  // (P, F)
  float* part;  // [splits][cols]
  int P, C, CM, F, per;
  long long cols;
  int vec_m, vec_g;  // the pointer aligned (and F % V == 0 for gy): cp.async staging
};

// ---- the two products ----

// acc[mi][ni] += A[m-tile mt0 + mi] . B[n0 + 8ni ..]^T over ksteps mma
// depths, m-tiles from 7 on skipped. A is [row][LDK], B is [col][LDK], both
// k-contiguous (ldmatrix without .trans).
template <int NT, int LDK>
__device__ __forceinline__ void gemm_rows(float (&acc)[4][NT][4], const bf16* A, const bf16* B,
                                          int mt0, int n0, int ksteps, int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t b[NT / 2][4];  // n-tiles 2np and 2np+1: {b0, b1} each
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
      ldsm_x4(b[np], B + (n0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDK + ks * 16 +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (mt0 + mi >= 7) break;
      uint32_t a[4];
      ldsm_x4(a, A + ((mt0 + mi) * 16 + (lane & 15)) * LDK + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        mma_bf16(acc[mi][ni], a, b[ni / 2][2 * (ni & 1)], b[ni / 2][2 * (ni & 1) + 1]);
    }
  }
}

template <int NT, int LDK>
__device__ __forceinline__ void gemm_rows(float (&acc)[4][NT][4], const float* A, const float* B,
                                          int mt0, int n0, int ksteps, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_tf32(B[(n0 + ni * 8 + g) * LDK + ks * 8 + t + 4 * h], bh[ni][h], bl[ni][h]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (mt0 + mi >= 7) break;
      const float* p = A + ((mt0 + mi) * 16 + g) * LDK + ks * 8 + t;
      uint32_t ah[4], al[4];
      split_tf32(p[0], ah[0], al[0]);
      split_tf32(p[8 * LDK], ah[1], al[1]);
      split_tf32(p[4], ah[2], al[2]);
      split_tf32(p[8 * LDK + 4], ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_3xtf32(acc[mi][ni], ah, al, bh[ni], bl[ni]);
    }
  }
}

// Stage rows [0, KC) x columns [0, cols) of a tile into dst (row stride ld,
// elements of T): element (r, j) is *src(r, j), or 0 where src gives
// nullptr. With vec, src(r, j) for j a multiple of V is 16-byte aligned and
// the copy is cp.async (completed by the caller's cp_async_wait_all), every
// column group of the tile's N columns written; without vec, plain loads of
// the first `cols` columns. No runtime division.
template <typename T, int N, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int ld, bool vec, int cols, const T* any,
                                           Src src) {
  constexpr int KC = BwdCfg<T>::KC, V = BwdCfg<T>::V, G = N / V;
  if (vec) {
    for (int i = threadIdx.x; i < KC * G; i += kThreads) {
      const int r = i / G, j = (i % G) * V;
      const T* p = src(r, j);
      cp_async16(dst + r * ld + j, p ? p : any, p != nullptr);
    }
    return;
  }
  for (int r = threadIdx.x >> 5; r < KC; r += kThreads >> 5)
    for (int j = threadIdx.x & 31; j < cols; j += 32) {
      const T* p = src(r, j);
      dst[r * ld + j] = p ? *p : from_f<T>(0.f);
    }
}

// Pass (a) of one CTA: the tile blockIdx.x, the C slice blockIdx.y, sample
// blockIdx.z. kChain false: the plain mode (gy = g; y, comb, gy unused).
template <typename T, int WC, bool kChain>
__device__ __forceinline__ void chain_bwd_tile(const TileArgs<T>& a) {
  using L = TileSmem<T, WC>;
  constexpr int KC = L::KC, LDK = L::LDK, LDD = L::LDD, S = L::S;
  constexpr int KS = BwdCfg<T>::KS, V = BwdCfg<T>::V;
  constexpr int G = KC / V;                                        // vectors of a row's chunk
  constexpr int kItems = (kHaloPx * G + kThreads - 1) / kThreads;  // g/y vectors a thread
  constexpr int NT = WC / 32;                                      // n8 tiles of a warp
  static_assert(kThreads % G == 0, "a thread's vectors share their channels");
  extern __shared__ __align__(16) unsigned char smem[];
  auto gs = [&](int st) { return reinterpret_cast<T*>(smem + L::stage * st + L::g); };
  auto ys = [&](int st) { return reinterpret_cast<T*>(smem + L::stage * st + L::y); };
  auto ws = [&](int st) { return reinterpret_cast<T*>(smem + L::stage * st + L::w); };
  auto cs = [&](int st) { return reinterpret_cast<float*>(smem + L::stage * st + L::comb); };
  float* dms = reinterpret_cast<float*>(smem + L::dm);  // [100][LDD]
  T* xs = reinterpret_cast<T*>(smem + L::x);            // [100][LDD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp & 3, wm = warp >> 2, g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x;
  const int ty0 = (tile / a.tiles_x) * kTile, tx0 = (tile % a.tiles_x) * kTile;
  const int c0 = blockIdx.y * WC, b = blockIdx.z;
  const int H = a.H, W = a.W, C = a.C, F = a.F;
  const size_t img = (size_t)b * H * W;
  const int nc = min(WC, C - c0);  // channels of this CTA's slice

  // The g/y vectors this thread stages and turns into gy every chunk: item
  // j is ring pixel p = i / G, channels v*V.. of the chunk (i = tid +
  // j*kThreads; v = i % G is the same for every j). off: the pixel's
  // element offset in g, y, gy, or -1 outside the image; p = -1 past the
  // ring.
  const int v = tid % G;
  long long off[kItems];
  int prow[kItems];
  bool center[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = tid + j * kThreads, p = i / G;
    const int r = p / kHalo, cc = p % kHalo, Y = ty0 - 1 + r, X = tx0 - 1 + cc;
    const bool ring = i < kHaloPx * G;
    prow[j] = ring ? p : -1;
    off[j] = ring && Y >= 0 && Y < H && X >= 0 && X < W ? (long long)(img + (size_t)Y * W + X) * F
                                                        : -1;
    center[j] = r >= 1 && r <= kTile && cc >= 1 && cc <= kTile;
  }
  // chunk f0 of g and y (chain mode) on the ring, of pw's rows c0.. and of
  // comb's rows into stage st: cp.async where 16-byte vectors along F
  // exist, zero outside the image, past F and past the slice's channels
  auto stage = [&](int f0, int st) {
    const int f = f0 + v * V;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (prow[j] < 0) continue;
      const int o = prow[j] * LDK + v * V;
      if (a.vec_f) {
        const bool ok = off[j] >= 0 && f < F;
        cp_async16(gs(st) + o, ok ? a.g + off[j] + f : a.g, ok);
        if (kChain) cp_async16(ys(st) + o, ok ? a.y + off[j] + f : a.y, ok);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const bool ok = off[j] >= 0 && f + u < F;
          gs(st)[o + u] = ok ? a.g[off[j] + f + u] : from_f<T>(0.f);
          if (kChain) ys(st)[o + u] = ok ? a.y[off[j] + f + u] : from_f<T>(0.f);
        }
      }
    }
    T* dst = ws(st);
    if (a.vec_f) {
      for (int i = tid; i < WC * G; i += kThreads) {
        const int n = i / G, k = (i % G) * V;
        const bool ok = n < nc && f0 + k < F;
        cp_async16(dst + n * LDK + k, ok ? a.pw + (size_t)(c0 + n) * F + f0 + k : a.pw, ok);
      }
    } else {
      for (int n = tid >> 5; n < WC; n += kThreads >> 5)
        for (int k = lane; k < KC; k += 32) {
          const bool ok = n < nc && f0 + k < F;
          dst[n * LDK + k] = ok ? a.pw[(size_t)(c0 + n) * F + f0 + k] : from_f<T>(0.f);
        }
    }
    if (kChain)
      for (int i = tid; i < 6 * KC; i += kThreads) {
        const int q = i / KC, k = i % KC;
        const bool ok = f0 + k < F;
        cp_async4(cs(st) + i, ok ? a.comb + (size_t)q * F + f0 + k : a.comb, ok);
      }
  };
  // gy of chunk f0 in stage st, in place of g: rounded to T, zero outside
  // the image and past F; the first C slice's CTAs also store its tile
  // pixels into pass (b)'s gy
  auto build = [&](int f0, int st) {
    const int f = f0 + v * V;
    const float* cb = cs(st) + v * V;  // comb rows A, B, C, mean, a_out, b_out, KC apart
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (prow[j] < 0) continue;
      T* gp = gs(st) + prow[j] * LDK + v * V;
      float gv[V], yv[V], ov[V];
      unpack(*reinterpret_cast<const uint4*>(gp), gv);
      unpack(*reinterpret_cast<const uint4*>(ys(st) + prow[j] * LDK + v * V), yv);
      // four channels' constants at a time (16-byte loads), few registers
      // held beside the GEMM's accumulators
#pragma unroll
      for (int u0 = 0; u0 < V; u0 += 4) {
        float4 k4[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) k4[q] = *reinterpret_cast<const float4*>(cb + q * KC + u0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          auto at = [&](int q) {
            const float4& k = k4[q];
            return u == 0 ? k.x : u == 1 ? k.y : u == 2 ? k.z : k.w;
          };
          const float y = yv[u0 + u];
          const float gf = a.mask_combine && !(affine_rn(y, at(4), at(5)) > 0.f) ? 0.f : gv[u0 + u];
          ov[u0 + u] = off[j] >= 0 && f + u0 + u < F ? gf * at(0) + at(1) + (y - at(3)) * at(2)
                                                     : 0.f;
        }
      }
      const uint4 out = pack(ov);  // gy rounded to T
      *reinterpret_cast<uint4*>(gp) = out;
      if (blockIdx.y == 0 && center[j] && off[j] >= 0 && f < F) {
        if (a.vec_f) {
          *reinterpret_cast<uint4*>(a.gy + off[j] + f) = out;
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u)
            if (f + u < F) a.gy[off[j] + f + u] = from_f<T>(ov[u]);
        }
      }
    }
  };

  // ---- dm = gy . pw^T over the 112 GEMM rows, K = F in chunks of KC ----
  // S stages, S - 1 chunks in flight; the GEMM rows past the ring are zero
  for (int i = tid; i < S * (kM - kHaloPx) * G; i += kThreads) {
    const int r = i / G, k = (i % G) * V;
    *reinterpret_cast<uint4*>(gs(r / (kM - kHaloPx)) + (kHaloPx + r % (kM - kHaloPx)) * LDK + k) =
        make_uint4(0, 0, 0, 0);
  }
  const int nch = (F + KC - 1) / KC;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nch) stage(st * KC, st);
    cp_async_commit();
  }
  // The chain mode builds gy one chunk ahead of the products: between two
  // barriers the warps turn chunk i + 1's g into gy and multiply chunk i,
  // so one barrier a chunk serves both and the two overlap across warps.
  constexpr int kAhead = kChain ? 1 : 0;
  static_assert(S >= 3, "the stages built, multiplied and refilled differ");
  if (kChain) {
    cp_async_wait<S - 2>();
    __syncthreads();
    build(0, 0);
  }
  float acc[4][NT][4] = {};
  const bool active = wn * (WC / 4) < nc;  // the warp's columns hold channels of C
  for (int i = 0; i < nch; ++i) {
    const int f0 = i * KC, st = i % S;
    cp_async_wait<S - 2 - kAhead>();
    __syncthreads();  // gy of chunk i and g of chunk i + kAhead are in; stage (i - 1) % S is free
    if (i + S - 1 < nch) stage(f0 + (S - 1) * KC, (i + S - 1) % S);
    cp_async_commit();
    if (kChain && i + 1 < nch) build(f0 + KC, (i + 1) % S);
    if (active)
      gemm_rows<NT, LDK>(acc, gs(st), ws(st), wm * 4, wn * (WC / 4),
                         (min(KC, F - f0) + KS - 1) / KS, lane);
  }
  cp_async_wait_all();
  __syncthreads();  // dm and x take the stages' place
  // the ring's x for the slice, zero outside the image and past C, in
  // flight while dm is stored
  if (a.vec_x) {
    constexpr int GX = WC / V;
    for (int i = tid; i < kHaloPx * GX; i += kThreads) {
      const int p = i / GX, k = (i % GX) * V;
      const int Y = ty0 - 1 + p / kHalo, X = tx0 - 1 + p % kHalo;
      const bool ok = k < nc && Y >= 0 && Y < H && X >= 0 && X < W;
      cp_async16(xs + p * LDD + k, ok ? a.x + (img + (size_t)Y * W + X) * C + c0 + k : a.x, ok);
    }
    cp_async_commit();
  } else {  // plain loads, all of a thread's in flight at once
    constexpr int kPer = kHaloPx / (kThreads / WC);
    const int k = tid % WC;
    T xv[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int p = tid / WC + u * (kThreads / WC), Y = ty0 - 1 + p / kHalo, X = tx0 - 1 + p % kHalo;
      const bool ok = k < nc && Y >= 0 && Y < H && X >= 0 && X < W;
      xv[u] = ok ? a.x[(img + (size_t)Y * W + X) * C + c0 + k] : from_f<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) xs[(tid / WC + u * (kThreads / WC)) * LDD + k] = xv[u];
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int mt = wm * 4 + mi;
    if (mt >= 7) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + h * 8 + g;
      if (p >= kHaloPx) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        *reinterpret_cast<float2*>(dms + p * LDD + wn * (WC / 4) + ni * 8 + 2 * t) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
  }

  cp_async_wait_all();
  __syncthreads();

  // ---- per channel, kRows rows of the tile a thread: dz, dx, m, ddw, S, T ----
  // z = relu(in_a*x + in_b) | dropout(x) | x is recomputed in fp32 from the
  // staged x as the 3x3 windows of dm and z slide along a row (one new
  // column a pixel), zero outside the image.
  constexpr int kGroups = kThreads / WC, kRows = kTile / kGroups;
  const int cl = tid % WC, c = c0 + cl, pg = tid / WC;
  float ddw[9] = {}, s_sum = 0.f, t_sum = 0.f;
  if (c < C) {
    float taps[9], ia = 0.f, ib = 0.f, imean = 0.f, irstd = 0.f;
#pragma unroll
    for (int q = 0; q < 9; ++q) taps[q] = to_f(a.dw[q * C + c]);
    if (a.in_aff) {
      ia = a.in_aff[c];
      ib = a.in_aff[C + c];
      imean = a.in_aff[2 * C + c];
      irstd = a.in_aff[3 * C + c];
    }
    // z at ring pixel (R, q) from its staged x (zero outside the image)
    auto zval = [&](int R, int q) {
      const float xv = to_f(xs[(R * kHalo + q) * LDD + cl]);
      const int Y = ty0 - 1 + R, X = tx0 - 1 + q;
      if (a.in_aff)
        return Y >= 0 && Y < H && X >= 0 && X < W ? fmaxf(affine_rn(xv, ia, ib), 0.f) : 0.f;
      if (a.thresh)
        return xv != 0.f && hash_keep(logical_idx(b, Y, X, c, H, W, C), a.seed, a.thresh)
                   ? xv * a.drop_scale
                   : 0.f;
      return xv;
    };
    // The thread's kRows tile rows go in bands of kBand: a band's rows read
    // ring rows r0 .. r0 + kBand + 1, and a window of those rows by 3
    // columns slides along the tile, one new column of dm and z a step, so
    // each ring value is loaded (and z computed) once a band.
    constexpr int kBand = 2, kWin = kBand + 2;
    static_assert(kRows % kBand == 0, "whole bands");
    for (int r0 = pg * kRows; r0 < (pg + 1) * kRows; r0 += kBand) {
      float wd[kWin][3], wz[kWin][3];
#pragma unroll
      for (int i = 0; i < kWin; ++i)
#pragma unroll
        for (int j = 1; j < 3; ++j) {
          wd[i][j] = dms[((r0 + i) * kHalo + j - 1) * LDD + cl];
          wz[i][j] = zval(r0 + i, j - 1);
        }
#pragma unroll
      for (int cc = 0; cc < kTile; ++cc) {
#pragma unroll
        for (int i = 0; i < kWin; ++i) {
          wd[i][0] = wd[i][1], wd[i][1] = wd[i][2];
          wz[i][0] = wz[i][1], wz[i][1] = wz[i][2];
          wd[i][2] = dms[((r0 + i) * kHalo + cc + 2) * LDD + cl];
          wz[i][2] = zval(r0 + i, cc + 2);
        }
        const int X = tx0 + cc;
#pragma unroll
        for (int rr = 0; rr < kBand; ++rr) {
          const int r = r0 + rr, Y = ty0 + r;
          float dz = 0.f, mv = 0.f;
          const float dmc = wd[rr + 1][1];
#pragma unroll
          for (int di = 0; di < 3; ++di)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
              const float tap = taps[di * 3 + dj];
              dz += wd[rr + 2 - di][2 - dj] * tap;  // the correlation with the flipped taps
              const float zv = wz[rr + di][dj];
              mv += zv * tap;
              ddw[di * 3 + dj] += zv * dmc;
            }
          if (Y >= H || X >= W) continue;
          const size_t px = img + (size_t)Y * W + X;
          float d = dz;
          if (a.in_aff) {  // the mask affine_rn(x) > 0 is z > 0
            const float xv = to_f(xs[((r + 1) * kHalo + cc + 1) * LDD + cl]);
            d = wz[rr + 1][1] > 0.f ? dz : 0.f;
            s_sum += d;
            t_sum += d * ((xv - imean) * irstd);
          } else if (a.thresh) {
            d = hash_keep(logical_idx(b, Y, X, c, H, W, C), a.seed, a.thresh) ? dz * a.drop_scale
                                                                              : 0.f;
          }
          a.dx[px * C + c] = from_f<T>(d);
          a.m[px * a.CM + c] = from_f<T>(mv);
        }
      }
    }
  }

  // fixed-order sum of the row groups' partials, one row per tile
  float* red = reinterpret_cast<float*>(smem);  // [kGroups][kNSums][WC], over dm
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 9; ++q) red[(pg * kNSums + q) * WC + cl] = ddw[q];
  red[(pg * kNSums + 9) * WC + cl] = s_sum;
  red[(pg * kNSums + 10) * WC + cl] = t_sum;
  __syncthreads();
  if (pg == 0 && c < C) {
    float* row = a.part + ((size_t)b * gridDim.x + tile) * kNSums * C;
    for (int q = 0; q < kNSums; ++q) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kGroups; ++i) s += red[(i * kNSums + q) * WC + cl];
      row[q * C + c] = s;
    }
  }
}

template <typename T, int WC>
__global__ void __launch_bounds__(kThreads, 2) chain_bwd_tile_kernel(const TileArgs<T> a) {
  chain_bwd_tile<T, WC, true>(a);
}

// K10's pass (a): the plain mode
template <typename T, int WC>
__global__ void __launch_bounds__(kThreads, 2) sepconv_bwd_tile_kernel(const TileArgs<T> a) {
  chain_bwd_tile<T, WC, false>(a);
}

// part[split][c * F + f] = Σ over the split's pixels of m[p][c] * gy[p][f];
// with kBias, also part[split][C * F + f] = Σ gy[p][f] (from the blocks of
// the first C tile). Rows of part are cols floats apart.
template <typename T, int TM, int TN, bool kBias>
__device__ __forceinline__ void chain_bwd_dpw(const DpwArgs<T>& a) {
  using L = DpwSmem<T, TM, TN>;
  constexpr int KC = L::KC, LDA = L::LDA, LDB = L::LDB, KS = BwdCfg<T>::KS, S = kStages;
  constexpr int MT = TM / 32, NT = TN / 32;  // m16 and n8 tiles of a warp (2 x 4 warps)
  extern __shared__ __align__(16) unsigned char smem[];
  auto ms = [&](int st) { return reinterpret_cast<T*>(smem + L::stage * st + L::ms); };
  auto gs = [&](int st) { return reinterpret_cast<T*>(smem + L::stage * st + L::gs); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp & 3, wm = warp >> 2, g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.x * TN, c0 = blockIdx.y * TM;
  const int p_begin = blockIdx.z * a.per, p_end = min(a.P, p_begin + a.per);
  const int C = a.C, F = a.F;
  const int nm = min(TM, C - c0), nf = min(TN, F - f0);
  // columns the GEMM reads: m to whole m16 tiles, gy to whole warp slices
  const int mcols = min(TM, (nm + 15) / 16 * 16);
  const int fcols = min(TN, (nf + TN / 4 - 1) / (TN / 4) * (TN / 4));
  auto stage = [&](int p0, int st) {
    stage_rows<T, TM>(ms(st), LDA, a.vec_m, mcols, a.m, [&](int r, int j) {
      return p0 + r < p_end && j < nm ? a.m + (size_t)(p0 + r) * a.CM + c0 + j
                                      : (const T*)nullptr;
    });
    stage_rows<T, TN>(gs(st), LDB, a.vec_g, fcols, a.gy, [&](int r, int j) {
      return p0 + r < p_end && j < nf ? a.gy + (size_t)(p0 + r) * F + f0 + j : (const T*)nullptr;
    });
  };
  const bool sums_bias = kBias && blockIdx.y == 0 && tid < nf;
  const bool active = wn * (TN / 4) < nf;
  float acc[MT][NT][4] = {}, bsum = 0.f;
  // S stages, S - 1 chunks of KC pixels in flight
  const int nch = (p_end - p_begin + KC - 1) / KC;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nch) stage(p_begin + st * KC, st);
    cp_async_commit();
  }
  for (int i = 0; i < nch; ++i) {
    const int p0 = p_begin + i * KC, st = i % S;
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk i is in stage st; stage (i - 1) % S is free
    if (i + S - 1 < nch) stage(p0 + (S - 1) * KC, (i + S - 1) % S);
    cp_async_commit();
    const T* gb = gs(st);
    if (sums_bias)
#pragma unroll 4
      for (int k = 0; k < KC; ++k) bsum += to_f(gb[k * LDB + tid]);
    if (active) {
      const int ksteps = (min(KC, p_end - p0) + KS - 1) / KS;
      // fp32: each mma depth into a fresh fragment (gemm_cols' kFresh); a
      // split's one accumulator over thousands of truncating mma sums put
      // dpw 5.1e-5 of max|fp64| from fp64 at enc1.1, batch 32, against
      // 5.4e-7 now (troubleshoot/fp32_split_ab.py, one_acc). bf16 keeps it:
      // its operands' own rounding is far larger.
      if constexpr (std::is_same<T, float>::value)
        gemm_cols<MT, NT, LDA, LDB, true>(acc, ms(st), gb, wm * MT, nm, wn * (TN / 4), ksteps,
                                          lane);
      else
        gemm_cols<MT, NT, LDA, LDB>(acc, ms(st), gb, wm * MT, nm, wn * (TN / 4), ksteps, lane);
    }
  }
  cp_async_wait_all();
  float* out = a.part + (size_t)blockIdx.z * a.cols;
  if (sums_bias) out[(size_t)C * F + f0 + tid] = bsum;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + (wm * MT + mi) * 16 + h * 8 + g;
      if (c >= C) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int f = f0 + wn * (TN / 4) + ni * 8 + 2 * t + jj;
          if (f < F) out[(size_t)c * F + f] = acc[mi][ni][2 * h + jj];
        }
    }
}

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kThreads) chain_bwd_dpw_kernel(const DpwArgs<T> a) {
  chain_bwd_dpw<T, TM, TN, false>(a);
}

// K10's pass (b): dpw and dbias
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kThreads) sepconv_bwd_dpw_kernel(const DpwArgs<T> a) {
  chain_bwd_dpw<T, TM, TN, true>(a);
}

// The launch plan chain_bwd_plan (fused_train.py) gives: the C slice of a
// pass-(a) CTA, pass (b)'s output tile, its splits and pixels a split, and
// both passes' shared-memory bytes.
struct BwdPlan {
  int wc, tm, tn, splits, per, smem_a, smem_b;
};

template <typename T>
int tile_smem(int wc) {
  return wc == 64 ? TileSmem<T, 64>::bytes : wc == 128 ? TileSmem<T, 128>::bytes : -1;
}

template <typename T>
int dpw_smem(int tm, int tn) {
  if ((tm != 64 && tm != 128) || (tn != 64 && tn != 128)) return -1;
  return (int)sizeof(T) * kStages * BwdCfg<T>::KC * (tm + 8 + tn + 8);
}

long long bwd_workspace(int B, int H, int W, int C, int F, int splits, bool bias_row) {
  const long long rows_a = (long long)B * ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  const long long cols_a = (long long)kNSums * C, cols_b = (long long)C * F + (bias_row ? F : 0);
  return rows_a * cols_a + reduce_scratch_floats(rows_a, cols_a) + (long long)splits * cols_b +
         reduce_scratch_floats(splits, cols_b);
}

template <typename K, typename A>
int launch_one(K kernel, dim3 grid, int smem, cudaStream_t stream, const A& args) {
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(TileArgs<T> a, float* work, float* sums, float* dpw, int B, const BwdPlan& p,
           bool plain, cudaStream_t stream) {
  constexpr int KC = BwdCfg<T>::KC, V = BwdCfg<T>::V;
  const int H = a.H, W = a.W, C = a.C, F = a.F;
  const long long P = (long long)B * H * W;
  const bool plan_ok = B > 0 && B <= 65535 && H > 0 && W > 0 && C > 0 && F > 0 &&
                       p.smem_a == tile_smem<T>(p.wc) && p.smem_b == dpw_smem<T>(p.tm, p.tn) &&
                       p.splits > 0 && p.splits <= 65535 &&
                       p.per > 0 && p.per % KC == 0 && (long long)p.per * (p.splits - 1) < P &&
                       (long long)p.per * p.splits >= P && P < (1LL << 31);
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* q) { return ((uintptr_t)q & 15) == 0; };
  a.tiles_x = (W + kTile - 1) / kTile;
  a.CM = (C + V - 1) / V * V;
  const int tiles = a.tiles_x * ((H + kTile - 1) / kTile);
  a.vec_f = F % V == 0 && aligned(a.g) && aligned(a.pw) &&
            (plain || (aligned(a.y) && aligned(a.gy)));
  a.vec_x = C % V == 0 && aligned(a.x);
  const long long rows_a = (long long)B * tiles, cols_a = (long long)kNSums * C;
  a.part = work;
  float* scratch_a = work + rows_a * cols_a;
  float* part_b = scratch_a + reduce_scratch_floats(rows_a, cols_a);
  const long long cols_b = (long long)C * F + (plain ? F : 0);
  float* scratch_b = part_b + (long long)p.splits * cols_b;

  const dim3 grid_a(tiles, (C + p.wc - 1) / p.wc, B);
  int err;
  if (p.wc == 64)
    err = plain ? launch_one(sepconv_bwd_tile_kernel<T, 64>, grid_a, p.smem_a, stream, a)
                : launch_one(chain_bwd_tile_kernel<T, 64>, grid_a, p.smem_a, stream, a);
  else
    err = plain ? launch_one(sepconv_bwd_tile_kernel<T, 128>, grid_a, p.smem_a, stream, a)
                : launch_one(chain_bwd_tile_kernel<T, 128>, grid_a, p.smem_a, stream, a);
  if (err) return err;
  if ((err = reduce_rows(a.part, (int)rows_a, (int)cols_a, scratch_a, sums, stream))) return err;

  DpwArgs<T> d;
  d.m = a.m;
  d.gy = plain ? a.g : a.gy;  // K10: pass (b) reads the cotangent itself
  d.part = part_b;
  d.P = (int)P, d.C = C, d.F = F, d.per = p.per, d.cols = cols_b;
  d.CM = a.CM;
  d.vec_m = aligned(a.m);
  d.vec_g = F % V == 0 && aligned(d.gy);
  const dim3 grid_b((F + p.tn - 1) / p.tn, (C + p.tm - 1) / p.tm, p.splits);
#define UNET_DPW(TM, TN)                                                                    \
  if (p.tm == TM && p.tn == TN)                                                             \
    err = plain ? launch_one(sepconv_bwd_dpw_kernel<T, TM, TN>, grid_b, p.smem_b, stream, d) \
                : launch_one(chain_bwd_dpw_kernel<T, TM, TN>, grid_b, p.smem_b, stream, d);
  UNET_DPW(64, 64)
  UNET_DPW(64, 128)
  UNET_DPW(128, 64)
  UNET_DPW(128, 128)
#undef UNET_DPW
  if (err) return err;
  return reduce_rows(part_b, p.splits, (int)cols_b, scratch_b, dpw, stream);
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* y, const void* in_aff, const void* comb,
               const void* dw, const void* pw, void* dx, void* m, void* gy, void* work,
               void* sums, void* dpw, int B, int H, int W, int C, int F, int mask_combine,
               int seed, int thresh, float drop_scale, const BwdPlan& p, bool plain,
               cudaStream_t stream) {
  TileArgs<T> a = {};
  a.x = static_cast<const T*>(x);
  a.g = static_cast<const T*>(g);
  a.y = static_cast<const T*>(y);
  a.in_aff = static_cast<const float*>(in_aff);
  a.comb = static_cast<const float*>(comb);
  a.dw = static_cast<const T*>(dw);
  a.pw = static_cast<const T*>(pw);
  a.dx = static_cast<T*>(dx);
  a.m = static_cast<T*>(m);
  a.gy = static_cast<T*>(gy);
  a.H = H, a.W = W, a.C = C, a.F = F, a.mask_combine = mask_combine;
  a.seed = (uint32_t)seed, a.thresh = (uint32_t)thresh, a.drop_scale = drop_scale;
  return launch<T>(a, static_cast<float*>(work), static_cast<float*>(sums),
                   static_cast<float*>(dpw), B, p, plain, stream);
}

}  // namespace
}  // namespace unet

// Floats of workspace unet_chain_bwd needs with pass (b) in `splits` splits.
extern "C" long long unet_chain_bwd_workspace(int B, int H, int W, int C, int F, int splits) {
  return unet::bwd_workspace(B, H, W, C, F, splits, false);
}

// Floats of workspace unet_sepconv_bwd needs with pass (b) in `splits` splits.
extern "C" long long unet_sepconv_bwd_workspace(int B, int H, int W, int C, int F, int splits) {
  return unet::bwd_workspace(B, H, W, C, F, splits, true);
}

// x, dx (B,H,W,C), m (B,H,W,CM) with CM = C rounded up to 16 bytes, and g,
// y, gy (B,H,W,F) in T; dw (3,3,C) and the
// pointwise pw (C,F) in T; in_aff (4,C) fp32 or null; comb (6,F) fp32;
// sums (11,C) fp32 = ddw (9 rows, tap-major), S, T; dpw (C,F) fp32. m and gy
// are pass-(a) outputs read by pass (b). thresh 0 = no dropout. (wc, tm, tn,
// splits, per, smem_a, smem_b) is chain_bwd_plan's launch (fused_train.py),
// refused when its shared-memory bytes differ from this file's layouts.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int unet_chain_bwd(const void* x, const void* g, const void* y, const void* in_aff,
                              const void* comb, const void* dw, const void* pw, void* dx,
                              void* m, void* gy, void* work, void* sums, void* dpw, int B, int H,
                              int W, int C, int F, int mask_combine, int seed, int thresh,
                              float drop_scale, int wc, int tm, int tn, int splits, int per,
                              int smem_a, int smem_b, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unet::BwdPlan p = {wc, tm, tn, splits, per, smem_a, smem_b};
  if (dtype == 0)
    return unet::launch_bwd<float>(x, g, y, in_aff, comb, dw, pw, dx, m, gy, work, sums, dpw, B,
                                   H, W, C, F, mask_combine, seed, thresh, drop_scale, p, false,
                                   s);
  if (dtype == 1)
    return unet::launch_bwd<__nv_bfloat16>(x, g, y, in_aff, comb, dw, pw, dx, m, gy, work, sums,
                                           dpw, B, H, W, C, F, mask_combine, seed, thresh,
                                           drop_scale, p, false, s);
  return (int)cudaErrorInvalidValue;
}

// K10: x, dx (B,H,W,C), m (B,H,W,CM) and g (B,H,W,F) in T; dw (3,3,C) and the
// pointwise pw (C,F) in T; sums (11,C) fp32 = ddw (9 rows, tap-major) and
// two zero rows; dpwb (C+1,F) fp32 = dpw, then dbias. m is a pass-(a)
// output read by pass (b). The plan as for unet_chain_bwd. Returns
// cudaGetLastError().
extern "C" int unet_sepconv_bwd(const void* x, const void* g, const void* dw, const void* pw,
                                void* dx, void* m, void* work, void* sums, void* dpwb, int B,
                                int H, int W, int C, int F, int wc, int tm, int tn, int splits,
                                int per, int smem_a, int smem_b, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unet::BwdPlan p = {wc, tm, tn, splits, per, smem_a, smem_b};
  if (dtype == 0)
    return unet::launch_bwd<float>(x, g, nullptr, nullptr, nullptr, dw, pw, dx, m, nullptr, work,
                                   sums, dpwb, B, H, W, C, F, 0, 0, 0, 1.f, p, true, s);
  if (dtype == 1)
    return unet::launch_bwd<__nv_bfloat16>(x, g, nullptr, nullptr, nullptr, dw, pw, dx, m,
                                           nullptr, work, sums, dpwb, B, H, W, C, F, 0, 0, 0,
                                           1.f, p, true, s);
  return (int)cudaErrorInvalidValue;
}
