// The memory-streaming body of K4 (tail_pool.cu), K5 (head.cu) and K11
// (head_mc.cu): a ring of shared-memory stages filled by TMA bulk copies,
// persistent CTAs, and per-CTA partial sums that the last CTA to arrive adds
// up in a fixed order inside the same launch.
//
// These kernels read a few bytes per operation, so device memory bounds
// them; what keeps such a kernel below the memory's rate on Hopper is too
// few bytes in flight per SM (every thread waiting on its own 16-byte loads)
// and the second launch that sums the blocks' rows. Here:
//
// - A CTA takes a contiguous range of work units (a unit is one contiguous
//   span of pixels or a pair of image rows, plus what goes with it). The
//   grid is one CTA per SM of the card (the plan's `ctas`, from
//   build.sm_count), so each CTA walks its range once and no unit is
//   scheduled twice. A CTA has 16 warps: with 8, K5's forward (which only
//   reads) took as long to compute a stage as to load it and overlapped
//   the two poorly; K4 and K5's backward, which also write, ran at the
//   same rate with 8 warps or 16. The ring's depth (3 to 6 stages) moved
//   none of them.
// - One thread issues the unit's copies (cp.async.bulk, global -> shared,
//   completion counted in bytes on the stage's mbarrier) kStreamStages units
//   ahead; the other threads never wait on a global load, only on the
//   mbarrier of the stage they consume. A __syncthreads after each stage
//   hands the stage back before its refill.
// - Each CTA writes one row of partial sums. It then takes a ticket from an
//   arrival counter (an integer atomic: no value is ever added atomically);
//   the CTA that draws the last ticket sums the rows in row order, column
//   by column, and resets the counter for the next launch. Two runs on the
//   same inputs give the same bits.
#pragma once

#include "sepconv_common.cuh"

namespace unet {

constexpr int kStreamThreads = 512;  // threads a CTA: 16 warps, the SM's only CTA
constexpr int kStreamStages = 3;     // stages of the ring
constexpr int kStreamBarBytes = 64;  // the ring's mbarriers, ahead of the stages
constexpr int kStageAlign = 128;     // every stage starts on a 128-byte boundary

__host__ __device__ constexpr long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

// Shared-memory bytes of a ring of kStreamStages stages of `stage` bytes,
// the stages' space reused after the loop for `red` bytes of block sums.
__host__ __device__ constexpr long long stream_smem(long long stage, long long red) {
  return kStreamBarBytes +
         (round_up(stage, kStageAlign) * kStreamStages > red
              ? round_up(stage, kStageAlign) * kStreamStages
              : red);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, > 0) from 16-byte aligned global src to 16-byte
// aligned shared dst, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The contiguous range of `units` that CTA `cta` of `ctas` takes.
__device__ __forceinline__ void unit_range(long long units, int ctas, int cta, long long& begin,
                                           long long& end) {
  begin = units * cta / ctas;
  end = units * (cta + 1) / ctas;
}

// The ring loop. Op provides
//   void load(long long unit, char* stage, uint64_t* bar)  [thread 0]:
//       fill the stage: any plain copies first, then mbar_expect_tx(bar,
//       bytes) exactly once (0 bytes too), then the bulk copies of those
//       bytes, so the barrier's phase also releases the plain copies;
//   void consume(long long unit, const char* stage)  [all threads].
// consume() may call __syncthreads (every thread walks the same units).
template <class Op>
__device__ __forceinline__ void stream_units(Op& op, char* smem, long long stage_bytes,
                                             long long begin, long long end) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  char* ring = smem + kStreamBarBytes;
  const long long stride = round_up(stage_bytes, kStageAlign);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStreamStages; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStreamStages && begin + s < end; ++s)
      op.load(begin + s, ring + s * stride, bars + s);
  for (long long u = begin; u < end; ++u) {
    const long long k = u - begin;
    const int s = (int)(k % kStreamStages);
    mbar_wait(bars + s, (uint32_t)((k / kStreamStages) & 1));
    op.consume(u, ring + s * stride);
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && u + kStreamStages < end) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      op.load(u + kStreamStages, ring + s * stride, bars + s);
    }
  }
}

// Sum of v over the warp in a fixed (xor butterfly) order; every lane gets it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// After every CTA wrote its row partials[blockIdx.x][0, ld): the last CTA
// to arrive writes out[c] = sum over rows r = 0..gridDim.x-1 of
// partials[r][c] for c < cols, in that row order. ld is a multiple of 4;
// red is >= kStreamThreads * 16 bytes of shared memory free for the block
// sums.
// Every thread of every CTA calls it.
__device__ __forceinline__ void last_cta_sums(const float* partials, int ld, int cols,
                                              float* __restrict__ out, unsigned* counter,
                                              float4* red) {
  __shared__ int last;
  __threadfence();  // this CTA's row is visible before its ticket is drawn
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = gridDim.x, quads = ld / 4;
  // row groups: kStreamThreads / quads of them (at most 16) when a row is
  // short, each summing every groups-th row; then the groups in order
  const int groups = max(1, min(16, kStreamThreads / max(quads, 1)));
  const int lanes = kStreamThreads / groups;
  const int grp = threadIdx.x / lanes, q = threadIdx.x % lanes;
  const float4* p = reinterpret_cast<const float4*>(partials);
  for (int q0 = 0; q0 < quads; q0 += lanes) {
    const int quad = q0 + q;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (quad < quads && grp < groups) {
#pragma unroll 8
      for (int r = grp; r < rows; r += groups) {
        const float4 v = __ldcg(p + (size_t)r * quads + quad);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    if (groups > 1) {
      red[threadIdx.x] = acc;
      __syncthreads();
      if (grp == 0) {
        for (int g = 1; g < groups; ++g) {
          const float4 v = red[g * lanes + q];
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
      }
      __syncthreads();
    }
    if (grp == 0 && quad < quads) {
      const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (quad * 4 + i < cols) out[quad * 4 + i] = a[i];
    }
  }
  if (threadIdx.x == 0) *counter = 0u;  // every ticket of this launch is drawn
}

}  // namespace unet
