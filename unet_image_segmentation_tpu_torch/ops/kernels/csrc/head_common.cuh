// What the segmentation heads K5 (head.cu) and K11 (head_mc.cu) share on
// the streaming body of stream_sums.cuh: their work unit, a run of
// consecutive pixels of one sample with its targets, copied into a stage of
// the ring, the lanes a pixel group takes, the checks of a plan's runs, and
// the launch.
#pragma once

#include <type_traits>

#include "stream_sums.cuh"
#include "train_common.cuh"

namespace unet {
namespace {

template <typename T>
__host__ __device__ constexpr int head_vec() { return 16 / (int)sizeof(T); }

// N channels in T at p, 8 or 16 bytes, aligned
template <typename T, int N>
using VecRaw = typename std::conditional<N * sizeof(T) == 16, uint4, uint2>::type;

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  const VecRaw<T, N> raw = *reinterpret_cast<const VecRaw<T, N>*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[N]) {
  VecRaw<T, N> raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < N; ++j) e[j] = from_f<T>(in[j]);
  *reinterpret_cast<VecRaw<T, N>*>(p) = raw;
}

// The heads' work unit, a run: `pixels` consecutive pixels of one
// sample (the last run of a sample may be shorter). A stage holds the run's
// y ([pixels][F] in T) and then its targets: the 16-byte aligned span around
// them, copied by cp.async.bulk, whose last partial 16 bytes of the whole
// target tensor (when B*H*W is not a multiple of 16) the issuing thread
// copies itself.
template <typename T>
__host__ __device__ constexpr long long head_stage_bytes(int pixels, int F) {
  return (long long)pixels * F * sizeof(T) + round_up(pixels, 16) + 32;
}

// A run's place and its copies into a stage.
template <typename T>
struct RunSpan {
  const T* y;
  const uint8_t* tgt;
  int HW, F, pixels, runs;  // runs: per sample
  long long total;          // B * HW, the targets' bytes

  __device__ void init(const T* y_, const uint8_t* tgt_, int B, int HW_, int F_, int pixels_) {
    y = y_;
    tgt = tgt_;
    HW = HW_;
    F = F_;
    pixels = pixels_;
    runs = (HW + pixels - 1) / pixels;
    total = (long long)B * HW;
  }

  __device__ void place(long long unit, int& b, size_t& q0, int& np) const {
    b = (int)(unit / runs);
    const int p0 = (int)(unit % runs) * pixels;
    np = min(pixels, HW - p0);
    q0 = (size_t)b * HW + p0;
  }

  // the stage's y, and its targets from the run's first pixel on
  __device__ const T* stage_y(const char* stage) const {
    return reinterpret_cast<const T*>(stage);
  }
  __device__ const uint8_t* stage_t(const char* stage, size_t q0) const {
    return reinterpret_cast<const uint8_t*>(stage) + (size_t)pixels * F * sizeof(T) +
           (reinterpret_cast<uintptr_t>(tgt + q0) & 15);
  }

  __device__ void load(long long unit, char* stage, uint64_t* bar) const {
    int b, np;
    size_t q0;
    place(unit, b, q0, np);
    uint8_t* ts = reinterpret_cast<uint8_t*>(stage) + (size_t)pixels * F * sizeof(T);
    const uintptr_t src = reinterpret_cast<uintptr_t>(tgt + q0);
    const uintptr_t a0 = src & ~(uintptr_t)15, a1 = (src + np + 15) & ~(uintptr_t)15;
    const uintptr_t tail = reinterpret_cast<uintptr_t>(tgt + total) & ~(uintptr_t)15;
    const uintptr_t bulk_end = a1 < tail ? a1 : tail;
    for (uintptr_t p = src > tail ? src : tail; p < src + np; ++p)
      ts[p - a0] = *reinterpret_cast<const uint8_t*>(p);
    const uint32_t ybytes = (uint32_t)((size_t)np * F * sizeof(T));
    const uint32_t tbytes = bulk_end > a0 ? (uint32_t)(bulk_end - a0) : 0u;
    mbar_expect_tx(bar, ybytes + tbytes);
    bulk_load(stage, y + q0 * F, ybytes, bar);
    if (tbytes) bulk_load(ts, reinterpret_cast<const void*>(a0), tbytes, bar);
  }
};

// K5's L: the power of two at or above F / V (at most 32).
int group_lanes(int F, int elem) {
  const int G = F / (16 / elem);
  int L = 1;
  while (L < G) L *= 2;
  return L;
}

// The checks of a head's plan common to K5 and K11 (runs of `pixels` in
// groups of L lanes, ctas): cudaErrorInvalidValue for a plan the kernels do
// not lay out so.
template <typename T>
int check_run_plan(int B, int HW, int F, int pixels, int ctas) {
  const int L = group_lanes(F, (int)sizeof(T));
  const long long units = (long long)B * ((HW + pixels - 1) / pixels);
  if (F % head_vec<T>() || L > 32 || pixels < L || pixels % L || ctas < 1 || ctas > units)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// One launch of a head kernel on the streaming body with `smem` bytes of
// dynamic shared memory; cudaGetLastError() after it.
template <class Kernel, class... Args>
int launch_stream(Kernel kernel, int ctas, int smem, cudaStream_t stream, Args... args) {
  const int err =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kernel<<<ctas, kStreamThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace unet
