// The forward separable-conv body of K8 (sepconv_block.cu) and K1
// (chain_fwd.cu) on the tensor cores: over one 8x8 output tile and one
// slice of F,
//   acc = (dw3x3(z) -> T) . pw[:, slice]        (fp32 sums)
// where z is the staged input after the caller's prologue (K1: its hash
// dropout or relu(a*x + b), run once per staged element; K8: none), and
// acc goes to the caller's epilogue (K8: scale, shift, ReLU; K1: y rounded
// to T and the Σy/Σy² partials).
//
// Rounding points are the Pallas kernels': z in T, zero outside the image
// AFTER the prologue ('same' padding in z space, since relu(b) != 0); the
// depthwise sum in fp32 (taps in the order di, dj), rounded to T before the
// pointwise; the pointwise summed in fp32.
//
// What bounds it on the H100: per pixel 9C multiply-adds of depthwise on
// the CUDA cores and C*F of pointwise products, for C + F elements moved.
// The products run on the tensor cores, so in bf16 the bytes bound every
// U-Net block (1.27 ms over the 18 at batch 32 against 0.33 ms of products
// and 0.29 of depthwise at the peaks); in fp32 (products as 3xTF32, three
// TF32 products each) the bytes bound the 256 px blocks and the products
// the deeper ones. The kernel reaches about a sixth of that bound in bf16
// (NVIDIA H100 80GB HBM3, 700 W): a CTA's chunk steps take about the same
// time at every cluster size, and taking out one part at a time (the
// depthwise, the products, the staging of x, the epilogue's stores) in
// check calls shortened it by amounts that add up, so the parts run one
// after another at two CTAs an SM rather than overlapping. Routing the
// stores through shared memory as 16-byte rows changed nothing measurable.
//
// Design (the plan is fwd_plan in ops/fused_train.py, which must agree with
// FwdSmem below; fwd_work there counts what the plan executes):
//   * One thread-block cluster of n CTAs (n in {1, 2, 4, 8}) per 8x8 output
//     tile and image; CTA r owns F channels [r*s, (r+1)*s), s a multiple of
//     16 and at most the GEMM width W in {64, 128}. n = 1 up to F = 128.
//   * A cluster takes `per` consecutive tiles of the batch in one double-
//     buffered stream of chunks, so the next tile's first chunk is in
//     flight during a tile's last products and epilogue. On the card that
//     paid at the 256 and 128 px blocks and cost where it left only 2-3
//     waves of CTAs, hence fwd_plan's rule: at most 8 tiles a cluster, and
//     no fewer than 8 waves of CTAs where the tiles allow it.
//   * Per chunk of KC input channels (64 bf16, 32 fp32), double-buffered
//     with cp.async against the previous chunk's products: every CTA stages
//     its share (KC/n channels) of the chunk's 10x10 halo of x and the
//     share's taps, and the chunk's rows of pw for its own slice. Plain
//     loads where a width or a pointer is off the 16-byte vector (enc1.1's
//     3 channels).
//   * The caller's prologue rewrites the staged share in place (K1), one
//     CTA barrier later the depthwise of the share runs on the CUDA cores
//     in fp32 (a thread keeps one 16-byte group of channels, its taps in
//     registers, and takes two neighbouring pixels, so each x it loads
//     serves both), rounded to T, into the A buffer [64 px][KC] of EVERY
//     CTA of the cluster through distributed shared memory. So the
//     depthwise (and K1's dropout hash or affine) is done once per tile and
//     element, not once per F slice. fp32 stores each value already split
//     into its TF32 hi and lo parts, so the four warps that read it split
//     nothing.
//   * One cluster barrier a chunk; then the CTA's 8 warps (2 along M, 4
//     along N) run the 64 x W x KC product on mma.sync: bf16 m16n8k16 from
//     ldmatrix; fp32 as 3xTF32 on m16n8k8 (TF32 alone breaks the 1e-4
//     bar), A by ldmatrix from the split buffers, B split in the warp.
//     Warps whose columns lie past the slice skip the products.
//   * Why a cluster and not one CTA per slice that redoes the depthwise
//     (fwd_work's counts over the U-Net's 18 blocks at batch 32): a slice
//     that recomputed the depthwise would run it n times, 14.2 G multiply-
//     adds in place of 10.0 G; at the card's measured rates (K12b's fp32
//     54 Top/s, a bf16 matmul's 774 Top/s) that is 0.52 ms of CUDA-core
//     work in place of 0.37 beside 0.43 ms of products, and at F = 1024
//     (n = 8) 72 depthwise multiply-adds a pixel and input channel cost as
//     much as its 1024 products: the deepest blocks would double. With the
//     cluster only the mma depth's padding is left: 1.011 (bf16) and 1.004
//     (fp32) executed over useful; 5.33 at enc1.1, whose 3 channels fill a
//     16-deep (8 in fp32: 2.67) mma step. F <= 128 takes one CTA a tile,
//     whose cluster barrier is a CTA barrier.
//   * K1's halo mode (row-sharded training): a run-time pointer, no
//     template instance of its own. With FwdArgs::halo set, stage() takes
//     the staged rows Y = -1 and Y = H of a shard's first and last tile
//     rows from the halo (B, 2, W, C) (row 0 above the shard, row 1 below,
//     z values the neighbours exchanged) in place of zeros; columns X = -1
//     and X = W stay zero. The prologue's image test (rows outside
//     0..H-1 are left as staged) keeps them out of the dropout and the
//     affine, since they are z already; the chunk loop, the products and
//     the epilogue's sums over the shard's own rows stay as they are.
#pragma once

#include <cooperative_groups.h>

#include "mma_common.cuh"

namespace unet {

constexpr int kFwdHalo = kTile + 2;              // side of the staged x tile
constexpr int kFwdHaloPx = kFwdHalo * kFwdHalo;  // 100 pixels

// Shared memory of one CTA, in bytes; fwd_plan (fused_train.py) mirrors it.
// In T: the x halo tiles [2][100][KC] and taps [2][9][KC] of the CTA's
// share, the A buffers [2][64][LDK] (fp32: [2][2][64][LDK], the TF32 hi
// then lo parts) and the pw chunks [2][KC][LDN]; then the epilogue's fp32
// scratch [4][W] (K1's column sums of the two warp rows).
template <typename T, int W>
struct FwdSmem {
  static constexpr int KC = ChunkCfg<T>::KC, LDK = KC + ChunkCfg<T>::V, LDN = W + 8;
  static constexpr int e = sizeof(T), parts = sizeof(T) == 4 ? 2 : 1;
  static constexpr int xs = 0, taps = xs + e * 2 * kFwdHaloPx * KC;
  static constexpr int As = taps + e * 2 * 9 * KC;
  static constexpr int Bs = As + e * 2 * parts * kTilePx * LDK;
  static constexpr int red = Bs + e * 2 * KC * LDN;
  static constexpr int bytes = red + 4 * 4 * W;
};

template <typename T>
struct FwdArgs {
  const T* x;   // (B, H, W, C)
  const T* dw;  // (3, 3, C)
  const T* pw;  // (C, F)
  const T* halo;  // (B, 2, W, C) z rows above and below a row shard, or null
  int B, H, W, C, F, tiles_x, tiles, n, s, per;
  int vec_x, vec_w;  // 16-byte staging of x and dw / of pw (widths and pointers aligned)
};

// One 8x8 output tile of a CTA: image b, tile index (of tiles an image),
// the tile's corner, and the CTA's slice: first channel and width.
struct FwdTile {
  int b, tile, ty0, tx0, f0, len;
};

template <typename T>
inline FwdArgs<T> fwd_args(const void* x, const void* dw, const void* pw, int B, int H, int W,
                           int C, int F, int n, int s, int per, const void* halo = nullptr) {
  constexpr int V = ChunkCfg<T>::V;
  FwdArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.dw = static_cast<const T*>(dw);
  a.pw = static_cast<const T*>(pw);
  a.halo = static_cast<const T*>(halo);
  a.B = B, a.H = H, a.W = W, a.C = C, a.F = F;
  a.tiles_x = (W + kTile - 1) / kTile;
  a.tiles = a.tiles_x * ((H + kTile - 1) / kTile);
  a.n = n, a.s = s, a.per = per;
  a.vec_x = C % V == 0 && aligned16(x) && aligned16(dw) && aligned16(halo);
  a.vec_w = F % V == 0 && aligned16(pw);
  return a;
}

// Store a tile's outputs, the fragments of acc (already in their final
// value) rounded to T, into y (B, H, W, F) as column pairs; columns past the
// slice and pixels past the image are not stored.
template <typename T, int W>
__device__ __forceinline__ void store_tile(const FwdArgs<T>& a, const float (&acc)[2][W / 32][4],
                                           const FwdTile& t, T* y) {
  constexpr int NT = W / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp & 3, wm = warp >> 2, g = lane >> 2, tq = lane & 3;
  const size_t img = (size_t)t.b * a.H * a.W;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int col = wn * 8 * NT + ni * 8 + 2 * tq;
    if (col >= t.len) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int Y = t.ty0 + 2 * (wm * 2 + mi) + h, X = t.tx0 + g;
        if (Y < a.H && X < a.W)
          store_pair(y + (img + (size_t)Y * a.W + X) * a.F, t.f0 + col, a.F, col + 1 < t.len,
                     acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  }
}

// The launch plan of fwd_plan (fused_train.py) for these dimensions: n CTAs
// a cluster, slices of s channels, width 64 or 128, per tiles a cluster,
// smem bytes of dynamic shared memory, which must be FwdSmem's.
template <typename T>
inline bool fwd_plan_ok(int B, int H, int W, int C, int F, int n, int s, int width, int per,
                        int smem) {
  const int bytes = width == 64 ? FwdSmem<T, 64>::bytes : FwdSmem<T, 128>::bytes;
  const long long tiles = (long long)B * ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  return (n == 1 || n == 2 || n == 4 || n == 8) && s > 0 && s % 16 == 0 && s <= width &&
         n * s >= F && (width == 64 || width == 128) && smem == bytes && B > 0 && H > 0 &&
         W > 0 && C > 0 && F > 0 && per > 0 && (tiles + per - 1) / per * n < (1LL << 31);
}

// Launch a kernel of the body: a cluster of n CTAs for every per tiles, on
// the grid (n * ceil(B * tiles / per)). Returns cudaGetLastError() after
// the launch.
template <typename T, typename... Params, typename... Args>
inline int launch_fwd(void (*kernel)(Params...), const FwdArgs<T>& a, int smem,
                      cudaStream_t stream, Args... args) {
  const long long clusters = ((long long)a.B * a.tiles + a.per - 1) / a.per;
  return launch_cluster(kernel, dim3((unsigned)(a.n * clusters), 1, 1), kThreads, smem, a.n,
                        stream, a, args...);
}

// One CTA's part of the per tiles (b * tiles + tile order) of cluster
// blockIdx.x / n: every chunk of every tile in one double-buffered stream,
// so the next tile's first chunk is in flight during this tile's last
// products and epilogue. After a tile's last chunk, epilogue(acc, tile)
// gets the products, warp (wm, wn) = (warp / 4, warp % 4) holding m-tiles
// 2wm, 2wm + 1 of the 64 rows (row m = tile pixel (m / 8, m % 8); a
// thread's fragment rows g and g + 8 of m-tile mt are pixels (2mt, g) and
// (2mt + 1, g)) and n8 tiles wn * W/4 .. of the slice; every thread of the
// CTA calls it. With kPrologue, prologue(xs, cs, len, tile) rewrites the
// staged share (xs [100][KC], channels cs .. cs + len of the halo of the
// tile) in place and must leave pixels outside the image and channels >= C
// zero.
template <typename T, int W, bool kPrologue, typename Prologue, typename Epilogue>
__device__ __forceinline__ void sepconv_fwd_tiles(const FwdArgs<T>& a, unsigned char* smem,
                                                  Prologue prologue, Epilogue epilogue) {
  namespace cg = cooperative_groups;
  using L = FwdSmem<T, W>;
  constexpr int KC = ChunkCfg<T>::KC, KS = ChunkCfg<T>::KS, V = ChunkCfg<T>::V;
  constexpr int LDK = L::LDK, LDN = L::LDN, NT = W / 32, G = KC / V;
  static_assert(kThreads % G == 0, "a thread keeps one channel group");
  T* xs = reinterpret_cast<T*>(smem + L::xs);      // [2][100][KC] x halo of the share
  T* taps = reinterpret_cast<T*>(smem + L::taps);  // [2][9][KC] its taps
  T* As = reinterpret_cast<T*>(smem + L::As);      // [2][parts][64][LDK] dw of the chunk
  T* Bs = reinterpret_cast<T*>(smem + L::Bs);      // [2][KC][LDN] pw chunk of the slice

  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, rank = (int)cluster.block_rank();
  const int H = a.H, Wd = a.W, C = a.C, F = a.F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp & 3, wm = warp >> 2;
  const int sh = KC / n;  // this CTA's share of a chunk's channels
  const int f0 = rank * a.s, len = max(0, min(a.s, F - f0));
  const int first = (int)(blockIdx.x / n) * a.per;
  const int last = min(a.B * a.tiles, first + a.per);

  auto tile_of = [&](int item) {
    const int b = item / a.tiles, tile = item - b * a.tiles;
    return FwdTile{b, tile, (tile / a.tiles_x) * kTile, (tile % a.tiles_x) * kTile, f0, len};
  };
  // a barrier of the cluster, or of the CTA alone when it is the cluster
  auto cluster_sync = [&]() {
    if (n == 1)
      __syncthreads();
    else
      cluster.sync();
  };
  // channels of chunk c0 that the products read (padded to the mma depth),
  // and the part of this CTA's share among them (a multiple of V)
  auto share_len = [&](int c0) {
    const int kpad = min(KC, (C - c0 + KS - 1) / KS * KS);
    return max(0, min(sh, kpad - rank * sh));
  };
  // chunk c0 of tile t into buffer buf: the slice's pw rows, the share's
  // taps and x halo (in the halo mode its rows -1 and H from a.halo)
  auto stage = [&](const FwdTile& t, int c0, int buf) {
    const int rows = min(KC, C - c0);
    stage_tile<W / V>(Bs + buf * KC * LDN, LDN, KC, W / V, a.vec_w, a.x, [&](int k, int j) {
      return k < rows && j < len ? a.pw + (size_t)(c0 + k) * F + f0 + j : (const T*)nullptr;
    });
    const int cs = c0 + rank * sh, groups = share_len(c0) / V;
    stage_tile<G>(taps + buf * 9 * KC, KC, 9, groups, a.vec_x, a.x, [&](int tap, int k) {
      return cs + k < C ? a.dw + tap * C + cs + k : (const T*)nullptr;
    });
    const size_t img = (size_t)t.b * H * Wd;
    stage_tile<G>(xs + buf * kFwdHaloPx * KC, KC, kFwdHaloPx, groups, a.vec_x, a.x,
                  [&](int p, int k) {
                    const int Y = t.ty0 - 1 + p / kFwdHalo, X = t.tx0 - 1 + p % kFwdHalo;
                    if (X < 0 || X >= Wd || cs + k >= C) return (const T*)nullptr;
                    if (Y >= 0 && Y < H) return a.x + (img + (size_t)Y * Wd + X) * C + cs + k;
                    if (a.halo == nullptr || (Y != -1 && Y != H)) return (const T*)nullptr;
                    return a.halo + (((size_t)t.b * 2 + (Y < 0 ? 0 : 1)) * Wd + X) * C + cs + k;
                  });
  };
  // V depthwise sums of pixel m, channels col.. of the chunk, into buffer
  // buf of every CTA's A: rounded to T (bf16), or split into TF32 hi, lo
  auto store_a = [&](int buf, int m, int col, const float (&s)[V]) {
    uint4 part[L::parts];
    if constexpr (sizeof(T) == 2) {
      part[0] = pack(s);
    } else {
      uint32_t hi[V], lo[V];
#pragma unroll
      for (int j = 0; j < V; ++j) split_tf32(s[j], hi[j], lo[j]);
      part[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      part[1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    const int off = buf * L::parts * kTilePx * LDK + m * LDK + col;
    for (int q = 0; q < n; ++q) {
      T* dst = (n == 1 ? As : cluster.map_shared_rank(As, q)) + off;
#pragma unroll
      for (int p = 0; p < L::parts; ++p)
        *reinterpret_cast<uint4*>(dst + p * kTilePx * LDK) = part[p];
    }
  };
  // the depthwise of this CTA's share of chunk c0 (staged in buffer buf)
  auto dw_push = [&](int c0, int buf) {
    const int v = tid % G;
    if (v >= share_len(c0) / V) return;
    const T* src = xs + buf * kFwdHaloPx * KC + v * V;
    const T* tp = taps + buf * 9 * KC + v * V;
    const int col = rank * sh + v * V;
    for (int pp = tid / G; pp < kTilePx / 2; pp += kThreads / G) {
      const int py = pp / (kTile / 2), px = 2 * (pp % (kTile / 2));
      float s0[V] = {}, s1[V] = {};
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        float tv[3][V];
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          unpack(*reinterpret_cast<const uint4*>(tp + (di * 3 + dj) * KC), tv[dj]);
#pragma unroll
        for (int dx = 0; dx < 4; ++dx) {
          float xv[V];
          unpack(*reinterpret_cast<const uint4*>(src + ((py + di) * kFwdHalo + px + dx) * KC),
                 xv);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if (dx < 3) s0[j] = fmaf(xv[j], tv[dx][j], s0[j]);
            if (dx > 0) s1[j] = fmaf(xv[j], tv[dx - 1][j], s1[j]);
          }
        }
      }
      store_a(buf, py * kTile + px, col, s0);
      store_a(buf, py * kTile + px + 1, col, s1);
    }
  };

  const int nch = (C + KC - 1) / KC;
  FwdTile cur = tile_of(first);
  stage(cur, 0, 0);
  cp_async_commit();
  cluster_sync();  // every CTA of the cluster runs before any remote store
  float acc[2][NT][4] = {};
  for (int item = first, i = 0, buf = 0;;) {
    const int c0 = i * KC;
    cp_async_wait_all();
    __syncthreads();  // this chunk staged; every warp done with the last one's buffers
    int next_i = i + 1, next_item = item;
    if (next_i == nch) next_i = 0, ++next_item;
    const FwdTile next = next_item == item ? cur : tile_of(next_item);
    if (next_item < last) stage(next, next_i * KC, buf ^ 1);
    cp_async_commit();
    if constexpr (kPrologue) {
      prologue(xs + buf * kFwdHaloPx * KC, c0 + rank * sh, share_len(c0), cur);
      __syncthreads();
    }
    dw_push(c0, buf);
    cluster_sync();  // the chunk's depthwise is complete in every CTA
    if (wn * (W / 4) < len) {
      const int ksteps = min(KC, (C - c0 + KS - 1) / KS * KS) / KS;
      if constexpr (sizeof(T) == 2) {
        warp_gemm<2, NT, LDK, LDN>(acc, As + buf * kTilePx * LDK, Bs + buf * KC * LDN, wm * 2, 4,
                                   wn * 8 * NT, ksteps, lane);
      } else {
        const T* A = As + 2 * buf * kTilePx * LDK;
        warp_gemm_split<2, NT, LDK, LDN>(acc, A, A + kTilePx * LDK, Bs + buf * KC * LDN, wm * 2,
                                         wn * 8 * NT, ksteps, lane);
      }
    }
    if (next_i == 0) {
      epilogue(acc, cur);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    if (next_item >= last) break;
    item = next_item, i = next_i, buf ^= 1, cur = next;
  }
  // no remote access follows the last cluster barrier, so a CTA may leave
}

}  // namespace unet
