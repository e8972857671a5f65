// Tensor-core fragments and asynchronous copies shared by the kernels that
// run their products on mma.sync (sepconv_pair.cu, sepconv_fwd.cuh,
// chain_bwd.cu, upconcat.cu): shared-memory addresses, cp.async, ldmatrix,
// the bf16 m16n8k16 and TF32 m16n8k8 products, the 3xTF32 split, 16-byte
// vectors of T unpacked to fp32 and packed back, the chunk sizes, staging,
// warp products (A row-major or pixel-major), paired stores and the
// cluster launch.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k8; g = lane / 4, t = lane
// % 4): A rows g and g + 8; B column g; C rows g and g + 8, columns 2t and
// 2t + 1. ldmatrix .x4 loads four 8x8 b16 matrices, lanes 8j..8j+7 giving
// the row addresses of matrix j; .trans loads each transposed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sepconv_common.cuh"

namespace unet {

// The sepconv kernels' chunking (K7, K8, K1): KC input channels of a chunk
// (the GEMM depth staged at once), KS the mma's depth, V elements of T in 16
// bytes (one vector load or store).
template <typename T> struct ChunkCfg;
template <> struct ChunkCfg<__nv_bfloat16> { static constexpr int KC = 64, KS = 16, V = 8; };
template <> struct ChunkCfg<float> { static constexpr int KC = 32, KS = 8, V = 4; };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a . b on m16n8k16, bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a . b on m16n8k8, TF32 operands, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v = hi + lo, each rounded to TF32 (the 3xTF32 split: the products
// lo*hi + hi*lo + hi*hi keep ~fp32 accuracy where TF32 alone would not)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// c += a . b as 3xTF32 from split operands
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// 16-byte vectors of T (8 bf16 or 4 fp32) as fp32, and back: pack rounds
// each value to T (round to nearest even), as from_f does.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// acc[mi][ni] += A[m-tile mt0+mi rows] . B[:, n0 + 8ni .. +8] over ksteps mma
// depths. A is [row][LDA] (k contiguous), B is [k][LDB] (n contiguous), both
// in shared memory. m-tiles at or past mt_end are skipped.
template <int MT, int NT, int LDA, int LDB>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], const __nv_bfloat16* A,
                                          const __nv_bfloat16* B, int mt0, int mt_end, int n0,
                                          int ksteps, int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t b[NT / 2][4];  // n-tiles 2np and 2np+1: {b0, b1} each
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
      ldsm_x4_trans(b[np], B + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + n0 +
                               np * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (mt0 + mi >= mt_end) break;
      uint32_t a[4];
      ldsm_x4(a, A + ((mt0 + mi) * 16 + (lane & 15)) * LDA + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        mma_bf16(acc[mi][ni], a, b[ni / 2][2 * (ni & 1)], b[ni / 2][2 * (ni & 1) + 1]);
    }
  }
}

template <int MT, int NT, int LDA, int LDB>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], const float* A,
                                          const float* B, int mt0, int mt_end, int n0,
                                          int ksteps, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_tf32(B[(ks * 8 + t + 4 * h) * LDB + n0 + ni * 8 + g], bh[ni][h], bl[ni][h]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (mt0 + mi >= mt_end) break;
      const float* p = A + ((mt0 + mi) * 16 + g) * LDA + ks * 8 + t;
      uint32_t ah[4], al[4];
      split_tf32(p[0], ah[0], al[0]);
      split_tf32(p[8 * LDA], ah[1], al[1]);
      split_tf32(p[4], ah[2], al[2]);
      split_tf32(p[8 * LDA + 4], ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        mma_tf32(acc[mi][ni], al, bh[ni]);
        mma_tf32(acc[mi][ni], ah, bl[ni]);
        mma_tf32(acc[mi][ni], ah, bh[ni]);
      }
    }
  }
}

// Store v[0..1] (columns f, f+1) of an output pixel row, as one vector where
// both columns exist and the pair is aligned.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int f, int F, bool second, float v0,
                                           float v1) {
  if (second && (F & 1) == 0) {
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<__nv_bfloat162*>(row + f) = __floats2bfloat162_rn(v0, v1);
    } else {
      *reinterpret_cast<float2*>(row + f) = make_float2(v0, v1);
    }
    return;
  }
  row[f] = from_f<T>(v0);
  if (second) row[f + 1] = from_f<T>(v1);
}

// acc[mi][ni] += A[m-tile mt0+mi rows] . B[:, n0 + 8ni .. +8] over ksteps k8
// depths as 3xTF32, A already split into its TF32 hi (Ah) and lo (Al) parts,
// each [row][LDA] (k contiguous) and read with ldmatrix (a 16-byte row of
// four 32-bit words is an 8x8 b16 row); B [k][LDB] fp32, split here.
template <int MT, int NT, int LDA, int LDB>
__device__ __forceinline__ void warp_gemm_split(float (&acc)[MT][NT][4], const float* Ah,
                                                const float* Al, const float* B, int mt0,
                                                int n0, int ksteps, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_tf32(B[(ks * 8 + t + 4 * h) * LDB + n0 + ni * 8 + g], bh[ni][h], bl[ni][h]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int off = ((mt0 + mi) * 16 + (lane & 15)) * LDA + ks * 8 + (lane >> 4) * 4;
      uint32_t ah[4], al[4];
      ldsm_x4(ah, Ah + off);
      ldsm_x4(al, Al + off);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_3xtf32(acc[mi][ni], ah, al, bh[ni], bl[ni]);
    }
  }
}

// acc[mi][ni] += A^T[m-tile mt0 + mi] . B[:, n0 + 8ni ..] over ksteps mma
// depths, m-tiles whose first row is at or past m_end skipped. A is
// [k][LDA] (rows contiguous), B is [k][LDB] (columns contiguous): both
// pixel-major, read with ldmatrix.trans.
template <int MT, int NT, int LDA, int LDB>
__device__ __forceinline__ void gemm_cols(float (&acc)[MT][NT][4], const __nv_bfloat16* A,
                                          const __nv_bfloat16* B, int mt0, int m_end, int n0,
                                          int ksteps, int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t b[NT / 2][4];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
      ldsm_x4_trans(b[np], B + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + n0 +
                               np * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if ((mt0 + mi) * 16 >= m_end) break;
      uint32_t a[4];
      ldsm_x4_trans(a, A + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDA + (mt0 + mi) * 16 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        mma_bf16(acc[mi][ni], a, b[ni / 2][2 * (ni & 1)], b[ni / 2][2 * (ni & 1) + 1]);
    }
  }
}

// The fp32 operands as 3xTF32. With kFresh, each mma depth's three products
// go into a fresh fragment that an fp32 add (round to nearest) then puts
// into acc: an mma aligns its terms to the largest and truncates, so into
// one large accumulator over thousands of depths it loses about a bit a
// time (K2/K10's fp32 dpw; troubleshoot/dpw_digits.py), into a fragment of
// its own next to nothing.
template <int MT, int NT, int LDA, int LDB, bool kFresh = false>
__device__ __forceinline__ void gemm_cols(float (&acc)[MT][NT][4], const float* A,
                                          const float* B, int mt0, int m_end, int n0, int ksteps,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_tf32(B[(ks * 8 + t + 4 * h) * LDB + n0 + ni * 8 + g], bh[ni][h], bl[ni][h]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if ((mt0 + mi) * 16 >= m_end) break;
      const float* p = A + (ks * 8 + t) * LDA + (mt0 + mi) * 16 + g;
      uint32_t ah[4], al[4];
      split_tf32(p[0], ah[0], al[0]);
      split_tf32(p[8], ah[1], al[1]);
      split_tf32(p[4 * LDA], ah[2], al[2]);
      split_tf32(p[4 * LDA + 8], ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        if (kFresh) {
          float d[4] = {};
          mma_3xtf32(d, ah, al, bh[ni], bl[ni]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] += d[r];
        } else {
          mma_3xtf32(acc[mi][ni], ah, al, bh[ni], bl[ni]);
        }
      }
    }
  }
}

// acc[mi][ni] += A[m-tile mt0 + mi] . B[:, n0 + 8ni ..] over ksteps k8
// depths as 3xTF32, A [row][LDA] (k contiguous) and B [k][LDB] (n
// contiguous), fp32 in shared memory; the results of warp_gemm<float>. It
// holds the A fragments of a depth (8 registers an m-tile) and splits each B
// fragment just before its products, where warp_gemm<float> and gemm_cols
// hold B's (8 an n-tile): for a warp of 2 x 8 tiles this keeps K6 (64
// accumulators) within 128 registers. Every m-tile is computed (no branch
// between the products): rows past the caller's edge must hold zeros or be
// ignored.
template <int MT, int NT, int LDA, int LDB>
__device__ __forceinline__ void gemm_3xtf32(float (&acc)[MT][NT][4], const float* A,
                                            const float* B, int mt0, int n0, int ksteps,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      // fragment a0..a3: (r, k), (r + 8, k), (r, k + 4), (r + 8, k + 4)
      const float* p = A + ((mt0 + mi) * 16 + g) * LDA + ks * 8 + t;
      split_tf32(p[0], ah[mi][0], al[mi][0]);
      split_tf32(p[8 * LDA], ah[mi][1], al[mi][1]);
      split_tf32(p[4], ah[mi][2], al[mi][2]);
      split_tf32(p[8 * LDA + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_tf32(B[(ks * 8 + t + 4 * h) * LDB + n0 + ni * 8 + g], bh[h], bl[h]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) mma_3xtf32(acc[mi][ni], ah[mi], al[mi], bh, bl);
    }
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Stage a rows x (G * V) tile of T into shared memory dst (row stride lds):
// element (r, j) is *src(r, j), or 0 where src gives nullptr; only the first
// `groups` column groups of V are written. With vec, src(r, j) for j a
// multiple of V points to V elements in one 16-byte-aligned vector (or is
// nullptr for all of them) and the copy is cp.async, completed by the
// caller's cp_async_wait_all; a thread keeps one column group. Without vec,
// plain loads, 8 in flight a thread, stored at once. No runtime division.
template <int G, typename T, typename Src>
__device__ __forceinline__ void stage_tile(T* dst, int lds, int rows, int groups, bool vec,
                                           const T* any, Src src) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    static_assert(kThreads % G == 0, "a pass covers whole rows");
    const int j = (threadIdx.x % G) * V;
    if (j >= groups * V) return;
    for (int r = threadIdx.x / G; r < rows; r += kThreads / G) {
      const T* p = src(r, j);
      cp_async16(dst + r * lds + j, p ? p : any, p != nullptr);
    }
    return;
  }
  constexpr int CB = 16, RS = kThreads / CB;  // columns, rows of a pass
  for (int c = threadIdx.x % CB; c < groups * V; c += CB) {
    for (int r0 = threadIdx.x / CB; r0 < rows; r0 += 8 * RS) {
      T v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r0 + u * RS;
        const T* p = r < rows ? src(r, c) : nullptr;
        v[u] = p ? *p : from_f<T>(0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (r0 + u * RS < rows) dst[(r0 + u * RS) * lds + c] = v[u];
    }
  }
}

// Launch kernel(args...) on grid x threads CTAs with smem bytes of dynamic
// shared memory, in thread-block clusters of n CTAs along x. Returns
// cudaGetLastError() after the launch.
template <typename... Params, typename... Args>
inline int launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, int smem, int n,
                          cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace unet
