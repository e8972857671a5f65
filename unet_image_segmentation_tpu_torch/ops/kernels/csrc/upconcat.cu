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
// four feeds move ~1.8 GB forward and ~2.1 GB backward in bf16 (0.53 and
// 0.63 ms at 3.35 TB/s) for 137 GFLOP of products forward and twice that
// backward (0.14 and 0.28 ms on the bf16 tensor cores): the bytes bound
// bf16. fp32 runs its products as 3xTF32 (three TF32 products each, 495
// TFLOP/s; TF32 alone would break the 1e-4 bar, 3xTF32 holds it as in K7,
// K8, K1 and K2): 1.26 ms forward (the products bound dec4 and dec3, the
// bytes dec2 and dec1) and 1.89 ms backward (the products but at dec1).
//
// Design (the plan is upconcat_plan in ops/fused_upconcat.py; the entries
// refuse a plan whose shared-memory bytes differ from FeedSmem / DwSmem):
//  - One tensor-core body for both dtypes and every shape: mma.sync bf16
//    m16n8k16 from ldmatrix, fp32 3xTF32 on m16n8k8 (gemm_3xtf32 for the
//    forward and dx; for d_kernel gemm_cols in bf16, as in K2/K10's pass (b),
//    and dw_gemm_fp32 in fp32), each warp splitting its fp32 fragments into
//    TF32 hi and lo as it loads them. Measured on the H100
//    (troubleshoot/fp32_split_ab.py, fp32, batch 32, dec4..dec1): splitting A
//    once where its stage lands, as K8 and K1 do, takes the forward from
//    0.721-0.854 ms to 0.730-0.904 with the lo buffer in a third stage's
//    place and to 0.883-1.360 with three stages and the buffer (one CTA an
//    SM): the split pass costs a barrier a chunk, and its buffer a stage or
//    the second CTA, more than the warps' repeated splits. In fp32 d_kernel
//    holds A's fragments and splits B's one at a time (gemm_3xtf32's order;
//    2% off the fp32 backward against gemm_cols', which K2 keeps: the other
//    order adds 3% there). Chunk tails and ragged widths are zero-filled
//    where they are staged, so odd C and F take the same products; only the
//    16-byte vectors fall back to element copies there.
//  - Forward and dx (feed_gemm): a CTA of 8 warps takes 128 pixels of x by
//    128 GEMM columns ((di,dj,f) forward, C for dx) and walks the depth (C
//    forward, 4F for dx) through a 3-stage cp.async ring, one barrier a
//    chunk, whole chunks unrolled. The column tiles of a pixel tile are
//    neighbours in the grid, so they run together: the first reads the A
//    tile from device memory, the others from L2. (A thread-block cluster
//    over the column tiles that shared each A chunk through distributed
//    shared memory measured slower at every feed on the H100: its cluster
//    barrier a chunk cost more than the L2 reads it saved.) dx gathers its
//    A rows straight from g (the pixel shuffle is an index map, each tile
//    row's output pixel computed once).
//  - Forward epilogue: bias added in fp32, rounded once, staged through
//    shared memory and written as 16-byte vectors; beside each up segment
//    the CTA copies the skip channels of the same output pixels, so every
//    [up | skip] row of cat is written once, in whole 16-byte runs, with
//    the skip loads batched ahead of the stores. dx is written the same
//    way, and the dx CTAs of the first column tile copy g[..., F:] to
//    d_skip for their rows.
//  - d_kernel (upconcat_dw_kernel): a split-K GEMM over pixels of 128x128
//    (C, 4F) tiles, x and dup pixel-major through a 3-stage cp.async ring
//    (bf16 read with ldmatrix.trans); one fp32 partial per split (in fp32
//    each pair of mma depths into a fresh fragment, then a rounding add,
//    dw_gemm_fp32), the splits
//    chosen so the grid fills whole waves of two CTAs an SM. The CTAs of
//    the first C tile also sum d_bias: every thread a 16-byte column group
//    over a fixed set of rows of each staged chunk, the row groups added
//    after the loop in a fixed order. reduce_rows() sums the partials in a
//    fixed order: no atomics, bit-reproducible runs. The CTAs of one pixel
//    split are neighbours in the grid, so x and g come from device memory
//    once and the other output tiles read them from L2.
#include <type_traits>

#include "mma_common.cuh"
#include "train_common.cuh"

namespace unet {
namespace {

constexpr int kBM = 128;      // pixels of x a forward / dx tile
constexpr int kBN = 128;      // GEMM columns a CTA
constexpr int kStages = 3;    // cp.async ring of the forward / dx
constexpr int kDwTile = 128;  // d_kernel tile: C rows x (di, dj, f) columns
constexpr int kDwStages = 3;  // cp.async ring of d_kernel

// Shared memory of a forward / dx CTA, in bytes; upconcat_plan mirrors it.
// In T: the A stages [kStages][kBM][LDK] and B stages [kStages][KC][LDN];
// then the output pixels of the tile's rows [kBM] (int). After the loop the
// output tile [kBM][LDC] in T takes the stages' place.
template <typename T>
struct FeedSmem {
  static constexpr int KC = ChunkCfg<T>::KC, V = ChunkCfg<T>::V, e = sizeof(T);
  static constexpr int LDK = KC + V, LDN = kBN + 8, LDC = kBN + V;
  static constexpr int As = 0, Bs = As + e * kStages * kBM * LDK;
  static constexpr int upix = Bs + e * kStages * KC * LDN;
  static constexpr int bytes = upix + 4 * kBM;
  static_assert(e * kBM * LDC <= upix, "the output tile fits over the stages");
};

// d_kernel's: kDwStages stages of x [KC][LD] and dup [KC][LD] in T, KC
// pixels a chunk.
template <typename T>
struct DwSmem {
  static constexpr int KC = ChunkCfg<T>::KC, LD = kDwTile + 8;
  static constexpr int stage = (int)sizeof(T) * KC * 2 * LD;
  static constexpr int bytes = kDwStages * stage;
};

template <typename T>
struct FeedArgs {
  const T* a;         // forward: x (P, C); dx: g (B, 2H, 2W, 2F)
  const T* b;         // forward: wmat (C, 4F); dx: wt (4F, C)
  const float* bias;  // forward: (F,)
  const T* skip;      // forward: (B, 2H, 2W, F)
  T* out;             // forward: cat (B, 2H, 2W, 2F); dx: (P, C)
  T* d_skip;          // dx: (B, 2H, 2W, F)
  int P, W, C, F, K, N, tiles_n;  // tiles_n: column tiles of kBN
  // 16-byte vectors: staging of A and of B, the epilogue's stores (and the
  // forward's skip loads), dx's d_skip copy
  int vec_a, vec_b, vec_out, vec_skip;
};

template <typename T>
struct DwArgs {
  const T* x;   // (P, C)
  const T* g;   // (B, 2H, 2W, 2F)
  float* part;  // [splits][(C + 1) * 4F]
  int P, W, C, F, per;
  long long cols;
  int vec_x, vec_g;
};

// Output pixel (2i, 2j) of x pixel p = (b, i, j) in the (B, 2H, 2W) image:
// with bi = b*H + i, (2 bi) * 2W + 2j. Tap q = (di, dj) adds up_step(q, W).
__device__ __forceinline__ int up_pixel(int p, int W) {
  const int bi = p / W;
  return 4 * W * bi + 2 * (p - bi * W);
}
__device__ __forceinline__ int up_step(int q, int W) { return (q >> 1) * 2 * W + (q & 1); }
// the tap of column n < 4F of (di, dj, f)
__device__ __forceinline__ int tap_of(int n, int F) {
  return (n >= F) + (n >= 2 * F) + (n >= 3 * F);
}

__device__ __forceinline__ void put_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The forward (kDx false) or dx GEMM of one CTA: pixel tile blockIdx.x /
// tiles_n, columns [col0, col0 + kBN) of column tile blockIdx.x % tiles_n
// (the column tiles of a pixel tile are neighbours in the grid, so they run
// together and read the tile's A from L2 after the first); warp (wm, wn) =
// (warp % 4, warp / 4) owns rows 32 wm .. and columns 64 wn .. of the tile.
template <typename T, bool kDx>
__device__ __forceinline__ void feed_gemm(const FeedArgs<T>& a) {
  using L = FeedSmem<T>;
  constexpr int KC = L::KC, KS = ChunkCfg<T>::KS, V = L::V, G = KC / V;
  constexpr int LDK = L::LDK, LDN = L::LDN, LDC = L::LDC, VR = kBN / V;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem + L::As);
  T* Bs = reinterpret_cast<T*>(smem + L::Bs);
  int* upix = reinterpret_cast<int*>(smem + L::upix);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int P = a.P, W = a.W, F = a.F, K = a.K, N = a.N;
  const int ct = (int)blockIdx.x % a.tiles_n;
  const int p0 = (int)blockIdx.x / a.tiles_n * kBM, col0 = ct * kBN;
  const int ncols = min(kBN, N - col0);
  for (int m = tid; m < kBM; m += kThreads) upix[m] = p0 + m < P ? up_pixel(p0 + m, W) : 0;
  __syncthreads();

  // element (tile row m, depth k) of A: x[p][k], or dup[p][k] read from g
  auto a_src = [&](int m, int k) -> const T* {
    if (p0 + m >= P || k >= K) return nullptr;
    if constexpr (kDx) {
      const int q = tap_of(k, F);
      return a.a + (size_t)(upix[m] + up_step(q, W)) * 2 * F + (k - q * F);
    } else {
      return a.a + (size_t)(p0 + m) * K + k;
    }
  };
  // chunk i into stage st: A's rows, and B's rows for this CTA's columns
  auto stage = [&](int i, int st) {
    const int k0 = i * KC;
    stage_tile<VR>(Bs + st * KC * LDN, LDN, KC, VR, a.vec_b, a.b, [&](int k, int j) {
      return k0 + k < K && j < ncols ? a.b + (size_t)(k0 + k) * N + col0 + j : (const T*)nullptr;
    });
    stage_tile<G>(As + st * kBM * LDK, LDK, kBM, G, a.vec_a, a.a,
                  [&](int m, int j) { return a_src(m, k0 + j); });
  };

  const int nch = (K + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch) stage(s, s);
    cp_async_commit();
  }
  float acc[2][8][4] = {};
  const bool active = wn * 64 < ncols;
  for (int i = 0; i < nch; ++i) {
    const int st = i % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i staged; every warp done with chunk i - 1
    if (i + kStages - 1 < nch) stage(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    if (active) {
      const T* A = As + st * kBM * LDK;
      const T* B = Bs + st * KC * LDN;
      // whole chunks with a constant depth, so the k-steps unroll
      auto product = [&](int ksteps) {
        if constexpr (sizeof(T) == 2) {
          warp_gemm<2, 8, LDK, LDN>(acc, A, B, wm * 2, kBM / 16, wn * 64, ksteps, lane);
        } else {
          gemm_3xtf32<2, 8, LDK, LDN>(acc, A, B, wm * 2, wn * 64, ksteps, lane);
        }
      };
      if (K - i * KC >= KC)
        product(KC / KS);
      else
        product((K - i * KC + KS - 1) / KS);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // the tile in T (forward: the bias added in fp32 first) into Cs [kBM][LDC]
  T* Cs = reinterpret_cast<T*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = wn * 64 + ni * 8 + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (!kDx) {
      if (col < ncols) b0 = a.bias[col0 + col - tap_of(col0 + col, F) * F];
      if (col + 1 < ncols) b1 = a.bias[col0 + col + 1 - tap_of(col0 + col + 1, F) * F];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put_pair(Cs + (wm * 32 + mi * 16 + g + 8 * h) * LDC + col, acc[mi][ni][2 * h] + b0,
                 acc[mi][ni][2 * h + 1] + b1);
  }
  __syncthreads();

  if constexpr (!kDx) {
    // each up segment of the tile and the skip channels beside it in cat
    const T* skip = a.skip;
    T* cat = a.out;
    if (a.vec_out) {
      constexpr int U = 8;  // skip vectors in flight a thread
      for (int base = tid; base < kBM * VR; base += kThreads * U) {
        uint4 sk[U];
        long long dst[U];  // offset of the up vector in cat, -1 where none
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int idx = base + u * kThreads, m = idx / VR, j = (idx % VR) * V;
          dst[u] = -1;
          sk[u] = make_uint4(0, 0, 0, 0);
          if (idx < kBM * VR && p0 + m < P && j < ncols) {
            const int q = tap_of(col0 + j, F), f = col0 + j - q * F;
            const size_t px = (size_t)upix[m] + up_step(q, W);
            dst[u] = (long long)(px * 2 * F + f);
            sk[u] = *reinterpret_cast<const uint4*>(skip + px * F + f);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (dst[u] < 0) continue;
          const int idx = base + u * kThreads;
          *reinterpret_cast<uint4*>(cat + dst[u]) =
              *reinterpret_cast<const uint4*>(Cs + (idx / VR) * LDC + (idx % VR) * V);
          *reinterpret_cast<uint4*>(cat + dst[u] + F) = sk[u];
        }
      }
    } else {
      for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
        const int m = idx / kBN, j = idx % kBN;
        if (p0 + m >= P || j >= ncols) continue;
        const int q = tap_of(col0 + j, F), f = col0 + j - q * F;
        const size_t px = (size_t)upix[m] + up_step(q, W);
        cat[px * 2 * F + f] = Cs[m * LDC + j];
        cat[px * 2 * F + F + f] = skip[px * F + f];
      }
    }
  } else {
    const int C = a.C;
    T* dx = a.out;
    if (a.vec_out) {
      for (int idx = tid; idx < kBM * VR; idx += kThreads) {
        const int m = idx / VR, j = (idx % VR) * V;
        if (p0 + m < P && j < ncols)
          *reinterpret_cast<uint4*>(dx + (size_t)(p0 + m) * C + col0 + j) =
              *reinterpret_cast<const uint4*>(Cs + m * LDC + j);
      }
    } else {
      for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
        const int m = idx / kBN, j = idx % kBN;
        if (p0 + m < P && j < ncols) dx[(size_t)(p0 + m) * C + col0 + j] = Cs[m * LDC + j];
      }
    }
    // d_skip = g[..., F:] at the four output pixels of the tile's rows
    if (ct == 0) {
      const T* gsrc = a.a;
      const int rows = min(kBM, P - p0);
      if (a.vec_skip) {
        constexpr int U = 4;  // vectors in flight a thread
        const int FV = F / V, total = rows * 4 * FV;
        for (int base = tid; base < total; base += kThreads * U) {
          uint4 v[U];
          long long o[U];  // offset of the vector in d_skip, -1 where none
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int idx = base + u * kThreads;
            o[u] = -1;
            v[u] = make_uint4(0, 0, 0, 0);
            if (idx < total) {
              const int m = idx / (4 * FV), rem = idx % (4 * FV), q = rem / FV;
              const size_t px = (size_t)upix[m] + up_step(q, W);
              const int f = (rem - q * FV) * V;
              o[u] = (long long)(px * F + f);
              v[u] = *reinterpret_cast<const uint4*>(gsrc + px * 2 * F + F + f);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (o[u] >= 0) *reinterpret_cast<uint4*>(a.d_skip + o[u]) = v[u];
        }
      } else {
        const int total = rows * 4 * F;
        for (int idx = tid; idx < total; idx += kThreads) {
          const int m = idx / (4 * F), rem = idx % (4 * F), q = rem / F, f = rem - q * F;
          const size_t px = (size_t)upix[m] + up_step(q, W);
          a.d_skip[px * F + f] = gsrc[px * 2 * F + F + f];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) upconcat_fwd_kernel(const FeedArgs<T> a) {
  feed_gemm<T, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) upconcat_dx_kernel(const FeedArgs<T> a) {
  feed_gemm<T, true>(a);
}

// K6's fp32 d_kernel product on gemm_cols' operands: acc[mi][ni] +=
// A[:, m-tile mt0 + mi]^T . B[:, n0 + 8ni ..] over a chunk's KSTEPS k8
// depths as 3xTF32, A [k][LDA] and B [k][LDB] pixel-major fp32 in shared
// memory. Each pair of depths goes into a fresh fragment that one rounding
// fp32 add puts into acc: an mma aligns its terms to the largest and
// truncates, so into a split's one accumulator over ~500 depths it lost
// about a bit a time (d_kernel 2.9e-5 of max|fp64| at batch 32, where JAX's
// order is 1.0e-6; troubleshoot/upconcat_digits.py). It holds A's
// fragments of the pair and splits B's an n-tile at a time, and takes every
// depth and m-tile of the chunk unrolled, with no test: rows past the split
// and channels past C are zero-filled where staged, so they add nothing
// (and those outputs are not stored). A fresh fragment a depth, or pairs
// in a loop with those tests, cost the fp32 backward more
// (troubleshoot/fp32_split_ab.py, one_acc against the tree).
template <int MT, int NT, int LDA, int LDB, int KSTEPS>
__device__ __forceinline__ void dw_gemm_fp32(float (&acc)[MT][NT][4], const float* A,
                                             const float* B, int mt0, int n0, int lane) {
  static_assert(KSTEPS % 2 == 0, "depths go in pairs");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ks += 2) {
    uint32_t ah[2][MT][4], al[2][MT][4];
#pragma unroll
    for (int d = 0; d < 2; ++d)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float* p = A + ((ks + d) * 8 + t) * LDA + (mt0 + mi) * 16 + g;
        split_tf32(p[0], ah[d][mi][0], al[d][mi][0]);
        split_tf32(p[8], ah[d][mi][1], al[d][mi][1]);
        split_tf32(p[4 * LDA], ah[d][mi][2], al[d][mi][2]);
        split_tf32(p[4 * LDA + 8], ah[d][mi][3], al[d][mi][3]);
      }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      float f[MT][4] = {};
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split_tf32(B[((ks + d) * 8 + t + 4 * h) * LDB + n0 + ni * 8 + g], bh[h], bl[h]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma_3xtf32(f[mi], ah[d][mi], al[d][mi], bh, bl);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += f[mi][r];
    }
  }
}

// part[split][c * 4F + n] = Σ over the split's pixels of x[p][c] dup[p][n];
// the CTAs of the first C tile also write part[split][C * 4F + n] = Σ
// dup[p][n]. grid (4F tiles, C tiles, splits); warp (wm, wn) = (warp % 4,
// warp / 4) owns rows 32 wm .. and columns 64 wn .. of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) upconcat_dw_kernel(const DwArgs<T> a) {
  using L = DwSmem<T>;
  constexpr int KC = L::KC, LD = L::LD, KS = ChunkCfg<T>::KS, V = ChunkCfg<T>::V;
  constexpr int S = kDwStages, VC = kDwTile / V, RG = kThreads / VC;
  extern __shared__ __align__(16) unsigned char smem[];
  auto xs = [&](int st) { return reinterpret_cast<T*>(smem + L::stage * st); };
  auto gs = [&](int st) { return reinterpret_cast<T*>(smem + L::stage * st) + KC * LD; };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int W = a.W, F = a.F, C = a.C, N = 4 * F;
  const int n0 = blockIdx.x * kDwTile, c0 = blockIdx.y * kDwTile;
  const int p_begin = blockIdx.z * a.per, p_end = min(a.P, p_begin + a.per);
  const int nm = min(kDwTile, C - c0), nn = min(kDwTile, N - n0);
  auto stage = [&](int p0, int st) {
    stage_tile<VC>(xs(st), LD, KC, VC, a.vec_x, a.x, [&](int r, int j) {
      return p0 + r < p_end && j < nm ? a.x + (size_t)(p0 + r) * C + c0 + j : (const T*)nullptr;
    });
    stage_tile<VC>(gs(st), LD, KC, VC, a.vec_g, a.g, [&](int r, int j) {
      if (p0 + r >= p_end || j >= nn) return (const T*)nullptr;
      const int q = tap_of(n0 + j, F);
      return a.g + (size_t)(up_pixel(p0 + r, W) + up_step(q, W)) * 2 * F + (n0 + j - q * F);
    });
  };
  const bool sums_bias = blockIdx.y == 0;
  const bool active = wn * 64 < nn;
  float acc[2][8][4] = {};
  float bsum[V] = {};  // d_bias of columns (tid % VC) * V .., rows tid / VC + RG k
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
#pragma unroll
      for (int k = tid / VC; k < KC; k += RG) {
        float v[V];
        unpack(*reinterpret_cast<const uint4*>(gb + k * LD + (tid % VC) * V), v);
#pragma unroll
        for (int j = 0; j < V; ++j) bsum[j] += v[j];
      }
    if (active) {
      // fp32: a fresh fragment a pair of depths (dw_gemm_fp32); bf16 keeps
      // one accumulator a split: its operands' own rounding is far larger
      if constexpr (std::is_same<T, float>::value)
        dw_gemm_fp32<2, 8, LD, LD, KC / KS>(acc, xs(st), gb, wm * 2, wn * 64, lane);
      else
        gemm_cols<2, 8, LD, LD>(acc, xs(st), gb, wm * 2, nm, wn * 64,
                                (min(KC, p_end - p0) + KS - 1) / KS, lane);
    }
  }
  cp_async_wait_all();
  float* out = a.part + (size_t)blockIdx.z * a.cols;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wm * 32 + mi * 16 + h * 8 + g;
      if (c >= C) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn * 64 + ni * 8 + 2 * t;  // N = 4F is even
        if (col < N)
          *reinterpret_cast<float2*>(out + (size_t)c * N + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  if (sums_bias) {
    __syncthreads();  // every warp done with the stages
    float* red = reinterpret_cast<float*>(smem);  // [RG][kDwTile]
#pragma unroll
    for (int j = 0; j < V; ++j) red[(tid / VC) * kDwTile + (tid % VC) * V + j] = bsum[j];
    __syncthreads();
    if (tid < nn) {
      float s = 0.f;
      for (int r = 0; r < RG; ++r) s += red[r * kDwTile + tid];
      out[(size_t)C * N + n0 + tid] = s;
    }
  }
}

// The plan of upconcat_plan (fused_upconcat.py) for a GEMM of P rows and N
// columns: tiles_n column tiles of kBN, smem bytes of dynamic shared
// memory, which must be FeedSmem's.
template <typename T>
bool feed_plan_ok(long long P, int N, int tiles_n, int smem) {
  return N > 0 && tiles_n == (N + kBN - 1) / kBN && smem == FeedSmem<T>::bytes && P > 0 &&
         4 * P < (1LL << 31) && (P + kBM - 1) / kBM * tiles_n < (1LL << 31);
}

// d_kernel's: splits of per pixels (a multiple of the chunk) that cover P.
template <typename T>
bool dw_plan_ok(long long P, int splits, int per, int smem) {
  return splits > 0 && splits <= 65535 && per > 0 && per % DwSmem<T>::KC == 0 &&
         (long long)per * (splits - 1) < P && (long long)per * splits >= P &&
         smem == DwSmem<T>::bytes;
}

long long dw_cols(int C, int F) { return (long long)(C + 1) * 4 * F; }

template <typename T>
int launch_fwd(const void* x, const void* wmat, const void* bias, const void* skip, void* cat,
               int B, int H, int W, int C, int F, int tiles_n, int smem, cudaStream_t stream) {
  constexpr int V = ChunkCfg<T>::V;
  const long long P = (long long)B * H * W;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || !feed_plan_ok<T>(P, 4 * F, tiles_n, smem))
    return (int)cudaErrorInvalidValue;
  FeedArgs<T> a = {};
  a.a = static_cast<const T*>(x);
  a.b = static_cast<const T*>(wmat);
  a.bias = static_cast<const float*>(bias);
  a.skip = static_cast<const T*>(skip);
  a.out = static_cast<T*>(cat);
  a.P = (int)P, a.W = W, a.C = C, a.F = F, a.K = C, a.N = 4 * F, a.tiles_n = tiles_n;
  a.vec_a = C % V == 0 && aligned16(x);
  a.vec_b = (4 * F) % V == 0 && aligned16(wmat);
  a.vec_out = F % V == 0 && aligned16(cat) && aligned16(skip);
  const dim3 grid((unsigned)((P + kBM - 1) / kBM * tiles_n), 1, 1);
  return launch_cluster(upconcat_fwd_kernel<T>, grid, kThreads, smem, 1, stream, a);
}

template <typename T>
int launch_bwd(const void* x, const void* wt, const void* g, void* dx, void* d_skip,
               float* work, float* dwb, int B, int H, int W, int C, int F, int tiles_n, int smem,
               int splits, int per, int smem_dw, cudaStream_t stream) {
  constexpr int V = ChunkCfg<T>::V;
  const long long P = (long long)B * H * W;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || !feed_plan_ok<T>(P, C, tiles_n, smem) ||
      !dw_plan_ok<T>(P, splits, per, smem_dw))
    return (int)cudaErrorInvalidValue;
  FeedArgs<T> a = {};
  a.a = static_cast<const T*>(g);
  a.b = static_cast<const T*>(wt);
  a.out = static_cast<T*>(dx);
  a.d_skip = static_cast<T*>(d_skip);
  a.P = (int)P, a.W = W, a.C = C, a.F = F, a.K = 4 * F, a.N = C, a.tiles_n = tiles_n;
  a.vec_a = F % V == 0 && aligned16(g);
  a.vec_b = C % V == 0 && aligned16(wt);
  a.vec_out = C % V == 0 && aligned16(dx);
  a.vec_skip = F % V == 0 && aligned16(g) && aligned16(d_skip);
  const dim3 grid((unsigned)((P + kBM - 1) / kBM * tiles_n), 1, 1);
  int err = launch_cluster(upconcat_dx_kernel<T>, grid, kThreads, smem, 1, stream, a);
  if (err) return err;

  DwArgs<T> d;
  d.x = static_cast<const T*>(x);
  d.g = static_cast<const T*>(g);
  d.part = work;
  d.P = (int)P, d.W = W, d.C = C, d.F = F, d.per = per;
  d.cols = dw_cols(C, F);
  d.vec_x = C % V == 0 && aligned16(x);
  d.vec_g = F % V == 0 && aligned16(g);
  const dim3 grid_dw((4 * F + kDwTile - 1) / kDwTile, (C + kDwTile - 1) / kDwTile, splits);
  err = launch_cluster(upconcat_dw_kernel<T>, grid_dw, kThreads, smem_dw, 1, stream, d);
  if (err) return err;
  float* scratch = work + (long long)splits * d.cols;
  return reduce_rows(work, splits, (int)d.cols, scratch, dwb, stream);
}

}  // namespace
}  // namespace unet

// x (B,H,W,C), skip (B,2H,2W,F), cat (B,2H,2W,2F) in T; the weights wmat
// (C,4F) in T, columns (di, dj, f); bias (F,) fp32. (tiles_n, smem) is
// the forward's launch plan of upconcat_plan (ops/fused_upconcat.py).
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int unet_upconcat(const void* x, const void* wmat, const void* bias, const void* skip,
                             void* cat, int B, int H, int W, int C, int F, int tiles_n, int smem,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return unet::launch_fwd<float>(x, wmat, bias, skip, cat, B, H, W, C, F, tiles_n, smem, s);
  if (dtype == 1)
    return unet::launch_fwd<__nv_bfloat16>(x, wmat, bias, skip, cat, B, H, W, C, F, tiles_n,
                                           smem, s);
  return (int)cudaErrorInvalidValue;
}

// Floats of workspace unet_upconcat_bwd needs with `splits` d_kernel splits.
extern "C" long long unet_upconcat_bwd_workspace(int B, int H, int W, int C, int F, int splits) {
  (void)B, (void)H, (void)W;
  const long long cols = unet::dw_cols(C, F);
  return (long long)splits * cols + unet::reduce_scratch_floats(splits, cols);
}

// x, dx (B,H,W,C), g (B,2H,2W,2F), d_skip (B,2H,2W,F) in T; the weights wt
// (4F,C) in T, rows (di, dj, f): the transpose kernel (2,2,F,C) as it lies;
// dwb (C+1, 4F) fp32: rows c < C d_kernel in (C, (di,dj,f)) order, row C
// the column sums of dup. (tiles_n, smem) is dx's launch plan, (splits,
// per, smem_dw) d_kernel's, both of upconcat_plan. Returns
// cudaGetLastError().
extern "C" int unet_upconcat_bwd(const void* x, const void* wt, const void* g, void* dx,
                                 void* d_skip, void* work, void* dwb, int B, int H, int W, int C,
                                 int F, int tiles_n, int smem, int splits, int per, int smem_dw,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(dwb);
  if (dtype == 0)
    return unet::launch_bwd<float>(x, wt, g, dx, d_skip, w, o, B, H, W, C, F, tiles_n, smem,
                                   splits, per, smem_dw, s);
  if (dtype == 1)
    return unet::launch_bwd<__nv_bfloat16>(x, wt, g, dx, d_skip, w, o, B, H, W, C, F, tiles_n,
                                           smem, splits, per, smem_dw, s);
  return (int)cudaErrorInvalidValue;
}
