// K7: a fused inference ConvBlock pair, two sepconv + folded-BN + ReLU blocks
// in one kernel, with block 1's output y1 kept on chip.
//
// Replaces the TPU kernel unet_image_segmentation_tpu/ops/pallas/fused_sepconv.py
// :_sepconv_pair_kernel_db (launched by fused_sepconv_pair), in its float
// modes: plain, pool=True (the encoder's 2x2 max pool of the dtype-cast y2
// written beside y2) and two-stream (block 1's input is the channel concat
// [x | x2], read from two pointers, so the decoder's concat is never stored);
// in its int8 I/O mode (quant_out with int8 input), where x, x2, y2 and the
// pool are int8 and the compute stays in T; in its float-in/int8-out mode
// (quant_out with a float input: x and x2 in T, y2 and the pool int8); and
// in each of them with edge flags, for row-sharded serving.
// Semantics kept: the dw1 result is rounded to the compute dtype T before
// pw1; y1 = relu(affine) rounded to T; y1 is ZERO outside the image, so block
// 2's 'same' padding sees zeros and not block 1 evaluated past the edge; the
// dw2 result is rounded to T before pw2; y2 rounded to T; every sum in fp32.
//
// What bounds it on the H100: per output pixel a stage does 9C + C*F1 + 9F1
// + F1*F2 multiply-adds while it reads C and writes F2 elements. In bf16 the
// products run on the tensor cores and the bytes bound the path (0.73 ms
// over the nine stages at batch 32 against 0.33 ms of bf16 products); in
// fp32 the products run as 3xTF32 (three TF32 products each, 495 TFLOP/s:
// 1.99 ms, against 4.9 ms for the same products as fp32 FMAs on the CUDA
// cores) and the operations bound it. The kernel reaches about a tenth of
// either bound: it is bound by the issue of its CUDA-core work and the
// latency that leaves exposed at 8-16 warps an SM (troubleshoot/pair_phases.py
// splits a CTA's cycles by phase): at the 256 px stages, 32768 CTAs of one
// spend half their cycles in fixed costs, the staging and the epilogue
// (enc1's 3-channel input takes the plain-load path, 30% in staging its
// x); at the deep stages block 1 (the depthwise, a cluster barrier and the
// staged x and weights a chunk, GEMM1) takes 55-80% and GEMM2 10-32% in
// bf16; in fp32 block 1 and GEMM2 (their 3xTF32 products) take 67-96% of
// a CTA at every stage but enc1. The int8 I/O mode reads and writes a byte a
// value, which lowers the bf16 bound to 0.45 ms (troubleshoot/roofline.py)
// and leaves the kernel's time where the float mode's is: the same issue and
// latency bound it (chip_smoke.py phase 13).
//
// Design (the plan is pair_plan in ops/fused_sepconv.py, which must agree
// with PairSmem below):
//   * One thread-block cluster of n CTAs (n in {1, 2, 4, 8}) per 8x8 output
//     tile and image. CTA r owns slice r of F1 and slice r of F2 (s1, s2
//     channels, multiples of 16; the width W in {64, 128} pads them).
//   * Block 1, per chunk of KC input channels: every CTA stages its share
//     (KC/n channels) of the chunk's 12x12 halo tile of x (and x2) into
//     shared memory with cp.async, double-buffered against the previous
//     chunk's GEMM, computes dw1 on the 10x10 ring for that share and
//     stores the rounded result into every CTA's A buffer through
//     distributed shared memory; one cluster barrier later each CTA runs
//     GEMM1 (112 ring rows x its F1 slice x the chunk) on the tensor cores.
//     So dw1 of x is computed once per tile, not once per F1 chunk.
//   * Block 1's epilogue: affine, ReLU, zero outside the image and outside
//     F1, rounded into the CTA's own y1 slice (100 ring pixels).
//   * Block 2: dw2 on the CTA's own F1 slice (per channel: no exchange),
//     rounded into d2 (64 pixels x the slice); one cluster barrier; GEMM2
//     for the CTA's F2 slice over all of F1, pulling each CTA's d2 chunk
//     through distributed shared memory into a local double buffer (the
//     next chunk's loads in flight during the current chunk's products).
//   * y1 is built once per output tile: the only recompute left is the
//     ring (100 of 64 pixels for dw1, 112 GEMM rows for GEMM1), the
//     padding of the channels to KC, the mma depth and the slice width.
//     Executed over useful multiply-adds at batch 32, 256 px (pair_work):
//     enc1 1.37 (bf16; the 3 input channels pad to one k16 step) / 1.16
//     (fp32), enc2-enc4 1.25, bneck 1.25, dec4-dec1 1.49-1.50; 1.41 (bf16)
//     and 1.40 (fp32) over the path, against 4.94 for the first K7.
//   * Products: bf16 on mma.sync m16n8k16 (ldmatrix fragments, fp32 sums);
//     fp32 as 3xTF32 on mma.sync m16n8k8 (a = a_hi + a_lo, each TF32; the
//     sum a_lo*b_hi + a_hi*b_lo + a_hi*b_hi keeps ~fp32 accuracy where TF32
//     alone would break the 1e-4 bar). The 8 warps stand 2 along M by 4
//     along N: a warp owns W/4 columns of 4 of GEMM1's 7 m16 tiles, or of 2
//     of GEMM2's 4.
//   * A cluster of one CTA (the 64- and 128-channel stages) takes no
//     cluster barrier and no distributed-shared-memory access: CTA barriers
//     and its own shared memory stand in for them.
//   * Block 2's buffers take block 1's x tiles and dw1 chunks where they
//     fit, so an SM holds two CTAs (128 registers a thread) in bf16 and in
//     fp32 at W = 64; fp32 at W = 128 holds one. Staging is cp.async
//     wherever widths and pointers align to 16 bytes (plain loads else, as
//     for the 3-channel input); each thread keeps one column group, so no
//     address needs a runtime division; dw1 takes two ring pixels an item,
//     dw2 keeps its taps in registers.
//   * The 64 output pixels follow tile_px2's order along M, so a thread's
//     accumulator rows hold whole 2x2 windows and the fused pool is local.
//   * Int8 I/O (the template's XB = 1): the wrapper folds in_scale into the
//     dw1 taps and 1/out_scale into scale2/shift2 (ops/fused_sepconv.py
//     fold_int8). x stays int8 in shared memory, its tiles a half (bf16) or
//     a quarter (fp32) of T's, in the same column groups of V channels, each
//     one V-byte cp.async (so a cluster share of 8 channels still stages as
//     vectors); dw1 converts the values to fp32 as it reads them, exactly,
//     so with pow2 scales the sums equal the float kernel's on the
//     dequantized input. The epilogue stores rint(min(y2, 127)) from fp32
//     (half to even, no rounding to T first) as int8 and pools those values.
//   * Float-in/int8-out (the template's XB = sizeof(T), OB = 1): x stages as
//     in the float mode and the epilogue is the int8 I/O mode's; only
//     1/out_scale is folded (into scale2/shift2).
//   * Edge flags (edge_top, edge_bot; run-time arguments, no instances of
//     their own): the x slab is a row shard with 2 halo rows each side, and a
//     set flag says that side's halo rows stand for rows beyond the true
//     image edge. y1 is then zero on the slab's first (last) 2 rows too, as
//     it is beyond the slab, so block 2's 'same' padding sees zeros there,
//     as on the unsharded image (the JAX kernel's kill of slab rows <= 1 and
//     >= H - 2).
#include <cooperative_groups.h>

#include <type_traits>

#include "mma_common.cuh"
#include "sepconv_common.cuh"

namespace cg = cooperative_groups;

// Phase marks, compiled only into the library troubleshoot/pair_phases.py
// builds with -DUNET_PAIR_PHASES: thread 0 of every CTA writes the clock64
// cycles from its start to each of the kPairPhases marks into
// unet_pair_phases[CTA][mark] (the CTA being blockIdx.y * gridDim.x +
// blockIdx.x). The kernel library proper has none of it.
#ifdef UNET_PAIR_PHASES
constexpr int kPairPhases = 8;
__device__ long long* unet_pair_phases;
#define PAIR_PHASES_START const long long phases_t0 = clock64();
#define PAIR_PHASE(i)                                                                     \
  if (threadIdx.x == 0)                                                                   \
    unet_pair_phases[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kPairPhases + (i)] = \
        clock64() - phases_t0;
#else
#define PAIR_PHASES_START
#define PAIR_PHASE(i)
#endif

namespace unet {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kPairThreads = 256;
constexpr int kHalo = kTile + 2;        // side of the y1 ring tile
constexpr int kHaloPx = kHalo * kHalo;  // 100 y1 pixels
constexpr int kM1 = 112;                // GEMM1 rows: the 100 ring pixels in 7 m16 tiles
constexpr int kXs = kTile + 4;          // side of the staged x tile
constexpr int kXsPx = kXs * kXs;        // 144 x pixels

// Shared-memory layout of one CTA, in bytes; pair_plan (fused_sepconv.py)
// mirrors it. The fp32 affines [4][W] (scale1, shift1 of the F1 slice,
// scale2, shift2 of the F2 slice), then in T the dw1 taps [2][9][KC], dw2
// taps [9][W] and weight chunks [2][KC][LDN]; then block 1's x halo tiles
// [2][144][KC] (XB bytes a value: int8 or T) and dw1 chunks [2][112][LDK],
// whose place block 2's buffers, y1 [100][LDN], d2 [64][LDN] and the pulled
// d2 chunks [2][64][LDK], take (block 1 is done with them by then).
template <typename T, int W, int XB>
struct PairSmem {
  static constexpr int KC = ChunkCfg<T>::KC, LDK = KC + ChunkCfg<T>::V, LDN = W + 8;
  static constexpr int e = sizeof(T);
  static constexpr int aff = 0, taps1 = 4 * 4 * W, taps2 = taps1 + e * 2 * 9 * KC;
  static constexpr int Bs = taps2 + e * 9 * W, xs = Bs + e * 2 * KC * LDN;
  static constexpr int As = xs + XB * 2 * kXsPx * KC, block1_end = As + e * 2 * kM1 * LDK;
  static constexpr int y1s = xs, d2s = y1s + e * kHaloPx * LDN;
  static constexpr int A2s = d2s + e * kTilePx * LDN, block2_end = A2s + e * 2 * kTilePx * LDK;
  static constexpr int bytes = block1_end > block2_end ? block1_end : block2_end;
  // two CTAs an SM where their shared memory fits (228 KB an SM, 1 KB of it
  // reserved a CTA); the registers are then held to 128 a thread
  static constexpr int min_blocks = 2 * (bytes + 1024) <= 228 * 1024 ? 2 : 1;
};

// XT: the type of x and x2, OT: of out and pooled (each T or int8_t)
template <typename T, typename XT, typename OT>
struct PairArgs {
  const XT* x;
  const XT* x2;
  const T* dw1;
  const T* pw1;
  const float* scale1;
  const float* shift1;
  const T* dw2;
  const T* pw2;
  const float* scale2;
  const float* shift2;
  OT* out;
  OT* pooled;
  int H, W, Cx, Cx2, F1, F2, tiles_x, n, s1, s2;
  int vec_x, vec_w1, vec_w2;  // 16-byte staging allowed (widths and pointers aligned)
  int edge_top, edge_bot;     // y1 is zero on the slab's first / last 2 rows
};

// Order of the 64 output pixels along GEMM2's M: m = 16*mt + 8*h + g lies in
// 2x2 window q = 2g + mt/2 at position i = 2*(mt%2) + h. An mma thread holds
// rows g and g+8 of its m-tiles, so each pair of m-tiles (2j, 2j+1) gives it
// one whole window per column.
__device__ __forceinline__ void tile_px2(int m, int& r, int& c) {
  const int mt = m >> 4, h = (m >> 3) & 1, g = m & 7;
  const int q = 2 * g + (mt >> 1), i = 2 * (mt & 1) + h;
  r = 2 * (q >> 2) + (i >> 1);
  c = 2 * (q & 3) + (i & 1);
}

__device__ __forceinline__ float affine_relu(float v, float sc, float sh) {
  // separately rounded, as the plain version computes v * scale + shift
  return fmaxf(__fadd_rn(__fmul_rn(v, sc), sh), 0.f);
}

// N bytes global -> shared (N = 4, 8 or 16), zero-filled when !ok
template <int N>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(N), "r"(ok ? N : 0)
               : "memory");
}

// The x halo tile: stage_tile's copy in T; in int8 the same column groups of
// V channels, each one V-byte cp.async, or plain loads as stage_tile's.
template <int G, int V, typename XT, typename Src>
__device__ __forceinline__ void stage_x_tile(XT* dst, int lds, int rows, int groups, bool vec,
                                             const XT* any, Src src) {
  if constexpr (sizeof(XT) > 1) {
    stage_tile<G>(dst, lds, rows, groups, vec, any, src);
  } else {
    if (vec) {
      const int j = (threadIdx.x % G) * V;
      if (j >= groups * V) return;
      for (int r = threadIdx.x / G; r < rows; r += kPairThreads / G) {
        const XT* p = src(r, j);
        cp_async_bytes<V>(dst + r * lds + j, p ? p : any, p != nullptr);
      }
      return;
    }
    constexpr int CB = 16, RS = kPairThreads / CB;  // columns, rows of a pass
    for (int c = threadIdx.x % CB; c < groups * V; c += CB) {
      for (int r0 = threadIdx.x / CB; r0 < rows; r0 += 8 * RS) {
        XT v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u * RS;
          const XT* p = r < rows ? src(r, c) : nullptr;
          v[u] = p ? *p : XT(0);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (r0 + u * RS < rows) dst[(r0 + u * RS) * lds + c] = v[u];
      }
    }
  }
}

// V staged x values as fp32: one 16-byte vector of T, or V bytes of int8
// (exact: |q| <= 127)
__device__ __forceinline__ void load_x(const bf16* p, float (&f)[8]) {
  unpack(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load_x(const float* p, float (&f)[4]) {
  unpack(*reinterpret_cast<const uint4*>(p), f);
}
template <int N>
__device__ __forceinline__ void int8x4(uint32_t w, float (&f)[N], int o) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[o + i] = (float)((int)(w << (24 - 8 * i)) >> 24);
}
__device__ __forceinline__ void load_x(const int8_t* p, float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  int8x4(u.x, f, 0);
  int8x4(u.y, f, 4);
}
__device__ __forceinline__ void load_x(const int8_t* p, float (&f)[4]) {
  int8x4(*reinterpret_cast<const uint32_t*>(p), f, 0);
}

// Store columns f, f+1 of an output row: in T (store_pair), or as int8 values
// already rounded to integers in [0, 127]
template <typename T>
__device__ __forceinline__ void store_out(T* row, int f, int F, bool second, float v0, float v1) {
  store_pair(row, f, F, second, v0, v1);
}
__device__ __forceinline__ void store_out(int8_t* row, int f, int F, bool second, float v0,
                                          float v1) {
  const signed char q0 = (signed char)__float2int_rn(v0), q1 = (signed char)__float2int_rn(v1);
  if (second && (F & 1) == 0) {
    *reinterpret_cast<char2*>(row + f) = make_char2(q0, q1);
    return;
  }
  row[f] = q0;
  if (second) row[f + 1] = q1;
}

// XB, OB: the bytes of an x and of a y value, sizeof(T), or 1 for int8 (x
// int8 only with y int8)
template <typename T, int W, int XB, int OB>
__global__ void __launch_bounds__(kPairThreads, PairSmem<T, W, XB>::min_blocks)
    sepconv_pair_cluster_kernel(const PairArgs<T, std::conditional_t<XB == 1, int8_t, T>,
                                               std::conditional_t<OB == 1, int8_t, T>> a) {
  using XT = std::conditional_t<XB == 1, int8_t, T>;
  constexpr bool Q = OB == 1;
  using L = PairSmem<T, W, XB>;
  constexpr int KC = ChunkCfg<T>::KC, KS = ChunkCfg<T>::KS, V = ChunkCfg<T>::V;
  constexpr int LDK = L::LDK, LDN = L::LDN;
  // 8 warps, 2 along M by 4 along N: a warp owns NT n8 tiles (W / 4 columns)
  // and 4 of GEMM1's 7 m16 tiles (3 in the second row) or 2 of GEMM2's 4
  constexpr int NT = W / 32, MT1 = 4, MT2 = 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* aff = reinterpret_cast<float*>(smem + L::aff);  // [4][W] scale1, shift1, scale2, shift2
  T* taps1 = reinterpret_cast<T*>(smem + L::taps1);      // [2][9][KC] dw1 taps of the share
  T* taps2 = reinterpret_cast<T*>(smem + L::taps2);      // [9][W] dw2 taps of the F1 slice
  XT* xs = reinterpret_cast<XT*>(smem + L::xs);          // [2][144][KC] x halo tile of the share
  T* As = reinterpret_cast<T*>(smem + L::As);            // [2][112][LDK] dw1 of the chunk
  T* Bs = reinterpret_cast<T*>(smem + L::Bs);            // [2][KC][LDN] pw1 / pw2 chunk
  T* y1s = reinterpret_cast<T*>(smem + L::y1s);          // [100][LDN] y1 slice on the ring
  T* d2s = reinterpret_cast<T*>(smem + L::d2s);          // [64][LDN] dw2 of the y1 slice
  T* A2s = reinterpret_cast<T*>(smem + L::A2s);          // [2][64][LDK] a d2 chunk of any CTA

  PAIR_PHASES_START
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / n, b = blockIdx.y;
  const int ty0 = (tile / a.tiles_x) * kTile, tx0 = (tile % a.tiles_x) * kTile;
  const int H = a.H, Wd = a.W, Cx = a.Cx, C = a.Cx + a.Cx2, F1 = a.F1, F2 = a.F2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp & 3, wm = warp >> 2, g = lane >> 2, t = lane & 3;
  const int sh = KC / n;  // this CTA's share of a chunk's channels
  const int f1_0 = rank * a.s1, len1 = max(0, min(a.s1, F1 - f1_0));
  const int f2_0 = rank * a.s2, len2 = max(0, min(a.s2, F2 - f2_0));

  // a barrier of the cluster, or of the CTA alone when it is the cluster
  auto cluster_sync = [&]() {
    if (n == 1)
      __syncthreads();
    else
      cluster.sync();
  };

  // channels of chunk c0 that GEMM1 reads (padded to the mma depth), and the
  // part of this CTA's share among them (a multiple of V)
  auto share_len = [&](int c0) {
    const int kpad = min(KC, (C - c0 + KS - 1) / KS * KS);
    return max(0, min(sh, kpad - rank * sh));
  };
  // x halo tile and dw1 taps of this CTA's share of chunk c0 into buffer buf
  auto stage_x = [&](int c0, int buf) {
    const int cs = c0 + rank * sh, groups = share_len(c0) / V;
    stage_x_tile<KC / V, V>(xs + buf * kXsPx * KC, KC, kXsPx, groups, a.vec_x, a.x,
                            [&](int q, int k) {
      const int Y = ty0 - 2 + q / kXs, X = tx0 - 2 + q % kXs, c = cs + k;
      if (Y < 0 || Y >= H || X < 0 || X >= Wd || c >= C) return (const XT*)nullptr;
      const size_t pix = ((size_t)b * H + Y) * Wd + X;
      return c < Cx ? a.x + pix * Cx + c : a.x2 + pix * a.Cx2 + (c - Cx);
    });
    stage_tile<KC / V>(taps1 + buf * 9 * KC, KC, 9, groups, a.vec_x, a.dw1, [&](int tap, int k) {
      return cs + k < C ? a.dw1 + tap * C + cs + k : (const T*)nullptr;
    });
  };
  // Bs[buf][k][j] = w[r0 + k][c0 + j] for k < rows, j < cols, else 0
  auto stage_w = [&](const T* w, int ld, int r0, int rows, int c0, int cols, int vec, int buf) {
    stage_tile<W / V>(Bs + buf * KC * LDN, LDN, KC, W / V, vec, w, [&](int k, int j) {
      return k < rows && j < cols ? w + (size_t)(r0 + k) * ld + c0 + j : (const T*)nullptr;
    });
  };

  // dw1 of this CTA's share of chunk c0 on the ring, rounded to T, into
  // buffer buf of every CTA's As. A thread keeps one group of V channels and
  // takes two horizontally neighbouring ring pixels at a time, so the four
  // x columns and three taps of each row it loads serve both.
  auto dw1_push = [&](int c0, int buf) {
    const XT* src = xs + buf * kXsPx * KC;
    const T* tp = taps1 + buf * 9 * KC;
    constexpr int G = KC / V;
    const int v = tid % G;
    if (v >= share_len(c0) / V) return;
    const int off = buf * kM1 * LDK + rank * sh + v * V;
    for (int pp = tid / G; pp < kHaloPx / 2; pp += kPairThreads / G) {
      const int py = pp / (kHalo / 2), px = 2 * (pp % (kHalo / 2));
      float s0[V] = {}, s1[V] = {};
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        float tv[3][V];
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          unpack(*reinterpret_cast<const uint4*>(tp + (di * 3 + dj) * KC + v * V), tv[dj]);
#pragma unroll
        for (int dx = 0; dx < 4; ++dx) {
          float xv[V];
          load_x(src + ((py + di) * kXs + px + dx) * KC + v * V, xv);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if (dx < 3) s0[j] = fmaf(xv[j], tv[dx][j], s0[j]);
            if (dx > 0) s1[j] = fmaf(xv[j], tv[dx - 1][j], s1[j]);
          }
        }
      }
      const int p = py * kHalo + px;
      const uint4 v0 = pack(s0), v1 = pack(s1);
      if (n == 1) {
        *reinterpret_cast<uint4*>(As + off + p * LDK) = v0;
        *reinterpret_cast<uint4*>(As + off + (p + 1) * LDK) = v1;
      } else {
        for (int q = 0; q < n; ++q) {
          T* dst = cluster.map_shared_rank(As, q) + off + p * LDK;
          *reinterpret_cast<uint4*>(dst) = v0;
          *reinterpret_cast<uint4*>(dst + LDK) = v1;
        }
      }
    }
  };

  // ---- block 1: y1 slice = relu(affine(dw1(x) . pw1[:, slice])) on the ring ----
  // the slice's affines and dw2 taps, and chunk 0, all in flight together
  for (int i = tid; i < 4 * W; i += kPairThreads) {
    const int which = i / W, j = i % W, f = (which < 2 ? f1_0 : f2_0) + j;
    const bool ok = j < (which < 2 ? len1 : len2);
    const float* src = which == 0 ? a.scale1 : which == 1 ? a.shift1 : which == 2 ? a.scale2
                                                                                   : a.shift2;
    cp_async4(aff + i, ok ? src + f : a.scale1, ok);
  }
  stage_tile<W / V>(taps2, W, 9, W / V, a.vec_w1, a.dw2, [&](int tap, int j) {
    return j < len1 ? a.dw2 + tap * F1 + f1_0 + j : (const T*)nullptr;
  });
  PAIR_PHASE(0)
  const int nch1 = (C + KC - 1) / KC;
  stage_x(0, 0);
  stage_w(a.pw1, F1, 0, min(KC, C), f1_0, len1, a.vec_w1, 0);
  cp_async_commit();
  PAIR_PHASE(1)
  cluster_sync();  // every CTA of the cluster runs before any remote store
  float acc1[MT1][NT][4] = {};
  for (int i = 0; i < nch1; ++i) {
    const int c0 = i * KC, buf = i & 1;
    cp_async_wait_all();
    __syncthreads();
    if (i == 0) {
      PAIR_PHASE(2)
    }
    if (i + 1 < nch1) {
      stage_x(c0 + KC, buf ^ 1);
      stage_w(a.pw1, F1, c0 + KC, min(KC, C - c0 - KC), f1_0, len1, a.vec_w1, buf ^ 1);
    }
    cp_async_commit();
    dw1_push(c0, buf);
    cluster_sync();  // the chunk's dw1 is complete in every CTA
    const int ksteps = min(KC, (C - c0 + KS - 1) / KS * KS) / KS;
    warp_gemm<MT1, NT, LDK, LDN>(acc1, As + buf * kM1 * LDK, Bs + buf * KC * LDN, wm * MT1, 7,
                                 wn * 8 * NT, ksteps, lane);
  }

  // GEMM2's chunks: chunk j -> (source CTA q, first column kc of its F1
  // slice, valid columns); its weights go to Bs[(nch1 + j) & 1], and chunk
  // 0's are requested now, the buffer being free since chunk nch1 - 2
  auto chunk_of = [&](int j, int& q, int& kc, int& cols) {
    for (q = 0; q < n; ++q) {
      const int len = max(0, min(a.s1, F1 - q * a.s1)), cnt = (len + KC - 1) / KC;
      if (j < cnt) {
        kc = j * KC;
        cols = min(KC, len - kc);
        return;
      }
      j -= cnt;
    }
  };
  PAIR_PHASE(3)
  int nch2 = 0;
  for (int q = 0; q < n; ++q) nch2 += (max(0, min(a.s1, F1 - q * a.s1)) + KC - 1) / KC;
  const bool gemm2 = len2 > 0 && nch2 > 0;
  if (gemm2) {
    int q, kc, cols;
    chunk_of(0, q, kc, cols);
    stage_w(a.pw2, F2, q * a.s1 + kc, cols, f2_0, len2, a.vec_w2, nch1 & 1);
  }
  cp_async_commit();
  __syncthreads();  // y1 may reuse the x tiles and dw1 chunks

  // y1 = relu(affine), zero outside the image (and on the slab's flagged
  // halo rows) and outside F1, rounded to T
  const int y_lo = a.edge_top ? 2 : 0, y_hi = a.edge_bot ? H - 2 : H;
  float sc1[NT][2], sh1[NT][2];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = wn * 8 * NT + ni * 8 + 2 * t + jj;
      sc1[ni][jj] = aff[col], sh1[ni][jj] = aff[W + col];
    }
#pragma unroll
  for (int mi = 0; mi < MT1; ++mi) {
    const int mt = wm * MT1 + mi;
    if (mt >= 7) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + h * 8 + g;
      if (p >= kHaloPx) continue;
      const int Y = ty0 - 1 + p / kHalo, X = tx0 - 1 + p % kHalo;
      const bool inside = Y >= y_lo && Y < y_hi && X >= 0 && X < Wd;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int col = wn * 8 * NT + ni * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          v[jj] = inside && col + jj < len1
                      ? affine_relu(acc1[mi][ni][2 * h + jj], sc1[ni][jj], sh1[ni][jj])
                      : 0.f;
        store_pair(y1s + p * LDN, col, 0, true, v[0], v[1]);
      }
    }
  }
  __syncthreads();
  PAIR_PHASE(4)

  // ---- block 2's depthwise on the slice, for the 64 output pixels ----
  // A thread keeps one group of V channels, its 9 taps in registers.
  {
    constexpr int G = W / V;
    const int v = tid % G;
    float tv[9][V];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      unpack(*reinterpret_cast<const uint4*>(taps2 + tap * W + v * V), tv[tap]);
#pragma unroll 2
    for (int m = tid / G; m < kTilePx; m += kPairThreads / G) {
      int r, c;
      tile_px2(m, r, c);
      float s[V] = {};
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          float yv[V];
          unpack(*reinterpret_cast<const uint4*>(y1s + ((r + di) * kHalo + c + dj) * LDN + v * V),
                 yv);
#pragma unroll
          for (int j = 0; j < V; ++j) s[j] = fmaf(yv[j], tv[di * 3 + dj][j], s[j]);
        }
      *reinterpret_cast<uint4*>(d2s + m * LDN + v * V) = pack(s);
    }
  }
  cluster_sync();  // every CTA's d2 slice is complete
  PAIR_PHASE(5)

  // ---- GEMM2: y2[:, F2 slice] = sum over the CTAs' F1 slices of d2 . pw2 ----
  // a d2 chunk: 64 rows x KC columns = 512 vectors, two a thread
  auto load_a2 = [&](int q, int kc, uint4 (&r)[2]) {
    const T* src = q == rank ? d2s : cluster.map_shared_rank(d2s, q);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kPairThreads, m = i / (KC / V), v = i % (KC / V);
      r[e] = *reinterpret_cast<const uint4*>(src + m * LDN + kc + v * V);
    }
  };
  auto store_a2 = [&](int buf, const uint4 (&r)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kPairThreads, m = i / (KC / V), v = i % (KC / V);
      *reinterpret_cast<uint4*>(A2s + buf * kTilePx * LDK + m * LDK + v * V) = r[e];
    }
  };

  float acc2[MT2][NT][4] = {};
  if (gemm2) {
    int q, kc, cols;
    uint4 pre[2];
    chunk_of(0, q, kc, cols);
    load_a2(q, kc, pre);
    store_a2(0, pre);
    for (int j = 0; j < nch2; ++j) {
      const int buf = j & 1, wbuf = (nch1 + j) & 1;
      chunk_of(j, q, kc, cols);
      const int ksteps = (cols + KS - 1) / KS;
      cp_async_wait_all();
      __syncthreads();
      const bool more = j + 1 < nch2;
      if (more) {
        int q1, kc1, cols1;
        chunk_of(j + 1, q1, kc1, cols1);
        stage_w(a.pw2, F2, q1 * a.s1 + kc1, cols1, f2_0, len2, a.vec_w2, wbuf ^ 1);
        load_a2(q1, kc1, pre);
      }
      cp_async_commit();
      warp_gemm<MT2, NT, LDK, LDN>(acc2, A2s + buf * kTilePx * LDK, Bs + wbuf * KC * LDN,
                                   wm * MT2, 4, wn * 8 * NT, ksteps, lane);
      if (more) store_a2(buf ^ 1, pre);
    }
  }

  PAIR_PHASE(6)
  // y2 = relu(affine) in T, or in int8 rint(min(y2, 127)) from fp32. A
  // thread's rows of its two m-tiles are one 2x2 window (tile_px2), so the
  // pool is the max over its own four values.
  const size_t img = (size_t)b * H * Wd;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int col = wn * 8 * NT + ni * 8 + 2 * t;
    if (col >= len2) continue;
    const bool second = col + 1 < len2;
    float sc[2], shf[2], mx[2] = {0.f, 0.f};  // every value is >= 0 after the ReLU
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) sc[jj] = aff[2 * W + col + jj], shf[jj] = aff[3 * W + col + jj];
    int r = 0, c = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tile_px2((wm * MT2 + e) * 16 + h * 8 + g, r, c);
        float v[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float y = affine_relu(acc2[e][ni][2 * h + jj], sc[jj], shf[jj]);
          v[jj] = Q ? rintf(fminf(y, 127.f)) : round_to<T>(y);
          mx[jj] = fmaxf(mx[jj], v[jj]);
        }
        const int Y = ty0 + r, X = tx0 + c;
        if (Y < H && X < Wd)
          store_out(a.out + (img + (size_t)Y * Wd + X) * F2, f2_0 + col, F2, second, v[0], v[1]);
      }
    const int Yq = ty0 + (r & ~1), Xq = tx0 + (c & ~1);
    if (a.pooled != nullptr && Yq < H && Xq < Wd)
      store_out(a.pooled + (((size_t)b * (H / 2) + Yq / 2) * (Wd / 2) + Xq / 2) * F2,
                f2_0 + col, F2, second, mx[0], mx[1]);
  }
  PAIR_PHASE(7)
  // no CTA leaves while another may still read its d2; the arrival releases
  // nothing (every remote access before it was a read, already complete)
  if (n > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
}

template <typename T, int W, typename XT, typename OT>
int launch(PairArgs<T, XT, OT> a, int B, int tiles, int smem, cudaStream_t stream) {
  if (smem != PairSmem<T, W, (int)sizeof(XT)>::bytes) return (int)cudaErrorInvalidValue;
  return launch_cluster(sepconv_pair_cluster_kernel<T, W, (int)sizeof(XT), (int)sizeof(OT)>,
                        dim3(a.n * tiles, B, 1), kPairThreads, smem, a.n, stream, a);
}

inline bool aligned_to(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

template <typename T, typename XT, typename OT>
int launch_pair(const void* x, const void* x2, const void* dw1, const void* pw1,
                const void* scale1, const void* shift1, const void* dw2, const void* pw2,
                const void* scale2, const void* shift2, void* out, void* pooled, int B, int H,
                int W, int Cx, int Cx2, int F1, int F2, int n, int s1, int s2, int width,
                int smem, int edge_top, int edge_bot, cudaStream_t stream) {
  constexpr int V = ChunkCfg<T>::V;
  const bool plan_ok = (n == 1 || n == 2 || n == 4 || n == 8) && s1 % 16 == 0 &&
                       s2 % 16 == 0 && s1 > 0 && s2 > 0 && s1 <= width && s2 <= width &&
                       n * s1 >= F1 && n * s2 >= F2 && Cx > 0 && Cx2 >= 0 && B > 0 &&
                       B <= 65535 && H > 0 && W > 0;
  if (!plan_ok || (Cx2 > 0 && x2 == nullptr)) return (int)cudaErrorInvalidValue;
  PairArgs<T, XT, OT> a;
  a.x = static_cast<const XT*>(x);
  a.x2 = static_cast<const XT*>(x2);
  a.dw1 = static_cast<const T*>(dw1);
  a.pw1 = static_cast<const T*>(pw1);
  a.scale1 = static_cast<const float*>(scale1);
  a.shift1 = static_cast<const float*>(shift1);
  a.dw2 = static_cast<const T*>(dw2);
  a.pw2 = static_cast<const T*>(pw2);
  a.scale2 = static_cast<const float*>(scale2);
  a.shift2 = static_cast<const float*>(shift2);
  a.out = static_cast<OT*>(out);
  a.pooled = static_cast<OT*>(pooled);
  a.edge_top = edge_top != 0, a.edge_bot = edge_bot != 0;
  a.H = H, a.W = W, a.Cx = Cx, a.Cx2 = Cx2, a.F1 = F1, a.F2 = F2;
  a.tiles_x = (W + kTile - 1) / kTile;
  a.n = n, a.s1 = s1, a.s2 = s2;
  // x's vectors: V channels, 16 bytes in T, V bytes in int8
  constexpr int xvb = V * sizeof(XT);
  a.vec_x = Cx % V == 0 && Cx2 % V == 0 && aligned_to(x, xvb) &&
            (Cx2 == 0 || aligned_to(x2, xvb)) && aligned16(dw1);
  a.vec_w1 = F1 % V == 0 && aligned16(pw1) && aligned16(dw2);
  a.vec_w2 = F2 % V == 0 && aligned16(pw2);
  const int tiles = a.tiles_x * ((H + kTile - 1) / kTile);
  if (width == 64) return launch<T, 64>(a, B, tiles, smem, stream);
  if (width == 128) return launch<T, 128>(a, B, tiles, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace unet

#ifdef UNET_PAIR_PHASES
// Where the phase marks go: a device buffer of kPairPhases int64 a CTA.
extern "C" int unet_pair_phases_buffer(void* buf) {
  return (int)cudaMemcpyToSymbol(unet_pair_phases, &buf, sizeof(buf));
}
#endif

// x2 may be null when Cx2 == 0; pooled may be null (no pool output; H and W
// must be even when it is given). (n, s1, s2, width, smem) is the launch plan
// of pair_plan (fused_sepconv.py): n CTAs a cluster, F1 and F2 slices of s1
// and s2 channels, the slice width 64 or 128, the dynamic shared memory in
// bytes (checked against this file's layout). dtype: the compute dtype, 0 =
// float32, 1 = bfloat16 (the weights'). in_int8, out_int8: x and x2, out and
// pooled in the compute dtype (0) or int8 (1; the scales folded into the
// weights); int8 in goes only with int8 out. edge_top, edge_bot: the edge
// flags (0 or 1). Returns cudaGetLastError() after the launch.
extern "C" int unet_sepconv_pair(const void* x, const void* x2, const void* dw1, const void* pw1,
                                 const void* scale1, const void* shift1, const void* dw2,
                                 const void* pw2, const void* scale2, const void* shift2,
                                 void* out, void* pooled, int B, int H, int W, int Cx, int Cx2,
                                 int F1, int F2, int n, int s1, int s2, int width, int smem,
                                 int dtype, int in_int8, int out_int8, int edge_top,
                                 int edge_bot, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UNET_PAIR_ARGS                                                                       \
  x, x2, dw1, pw1, scale1, shift1, dw2, pw2, scale2, shift2, out, pooled, B, H, W, Cx, Cx2, \
      F1, F2, n, s1, s2, width, smem, edge_top, edge_bot, s
  const int mode = 2 * in_int8 + out_int8;  // 0 float, 1 float in / int8 out, 3 int8 I/O
  if (dtype == 0 && mode == 0) return unet::launch_pair<float, float, float>(UNET_PAIR_ARGS);
  if (dtype == 0 && mode == 1) return unet::launch_pair<float, float, int8_t>(UNET_PAIR_ARGS);
  if (dtype == 0 && mode == 3) return unet::launch_pair<float, int8_t, int8_t>(UNET_PAIR_ARGS);
  if (dtype == 1 && mode == 0) return unet::launch_pair<bf16, bf16, bf16>(UNET_PAIR_ARGS);
  if (dtype == 1 && mode == 1) return unet::launch_pair<bf16, bf16, int8_t>(UNET_PAIR_ARGS);
  if (dtype == 1 && mode == 3) return unet::launch_pair<bf16, int8_t, int8_t>(UNET_PAIR_ARGS);
#undef UNET_PAIR_ARGS
  return (int)cudaErrorInvalidValue;
}
