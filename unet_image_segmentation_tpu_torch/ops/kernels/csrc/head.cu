// K5: the segmentation head fused into the last decoder chain's exit (its
// softmax sibling K11 follows K5 in this file).
//
// Replaces the TPU kernels unet_image_segmentation_tpu/ops/pallas/
// fused_head.py:_head_fwd_kernel and _head_bwd_kernel (launched by
// head_fwd_sums and head_bwd from the custom VJP _head_core). Per pixel of
// the chain's last raw link output y (B,H,W,F) in T, with the last block's
// batch-moment affine a, b, the head weights w (already rounded to T) and
// bias hb (rounded to T):
//
//   z  = relu(a*y + b) -> T
//   l  = T(T(Σ_c z_c w_c) + hb), the dot in fp32;  p = 1 / (1 + exp(-l))
//   forward: per-sample fp32 sums i = Σp t, p = Σp, t = Σt; it/pt/tt at
//            p > 0.5; ir/pr/tr at p >= 1 (Keras's int-cast counts).
//            Probabilities are never stored.
//   backward (the forward recomputed): dy = dI[b] t + dP[b],
//            dlog = dy p (1 - p), dl = T(dlog),
//            dzt_c = (a y + b > 0) ? dl w_c : 0   (fp32, written in T)
//            S = Σ dzt, T = Σ dzt (y - mean) rstd, dw_c = Σ z_c dl,
//            db = Σ dlog.
//
// What bounds it on the H100: device memory. At dec1 of batch 32 (y is
// 32x256x256x64) the forward reads y and the targets (270 MB in bf16, ~0.08
// ms at 3.35 TB/s); the backward also writes dzt (539 MB, ~0.16 ms). The
// arithmetic is ~10 flops per element.
//
// The first K5 split a pixel over a group of L lanes (one 16-byte vector
// each), summed its dot with log2(L) xor shuffles, and left the sigmoid and
// the nine sums to one lane of the group, on a grid fixed at ~4 blocks an SM
// of a 132-SM card, each thread waiting on its own 16-byte loads, with a
// second launch for the row sums: 29% and 32% of its bound in bf16.
//
// Design: the streaming body of stream_sums.cuh. A CTA an SM
// (ops/fused_head.head_plan) walks runs of consecutive pixels of one sample;
// one thread copies each run's y and targets into a 3-stage ring with
// cp.async.bulk. A group of L lanes (the power of two at or above F/V) takes
// L pixels at a time from shared memory, lane g reading its 16-byte channel
// chunk of each (a group's reads of a pixel are one contiguous span, so the
// banks do not conflict), and a transposing xor reduction (group_dots: L - 1
// shuffles for L pixels) leaves lane g with pixel g's dot, so the logit, the
// sigmoid, the sums and the backward's dl run in every lane. The backward
// broadcasts each pixel's dl to its group, recomputes the chunk from shared
// memory and writes dzt as 16-byte vectors. Each thread keeps its channels'
// S, T and dw (and its pixels' sums) in registers; the CTA sums its threads
// in a fixed order into one row, and the last CTA to arrive sums the rows in
// row order inside the same launch: no atomics on values. The ReLU mask is
// decided on a*y+b with separate roundings (affine_rn), as the plain version
// computes it, and the sigmoid uses expf.
#include <algorithm>

#include "stream_sums.cuh"
#include "train_common.cuh"

namespace unet {
namespace {

constexpr int kHeadSums = 9;      // i, p, t, it, pt, tt, ir, pr, tr

template <typename T>
__host__ __device__ constexpr int head_vec() { return 16 / (int)sizeof(T); }

template <typename T, int V>
__device__ __forceinline__ void load_vec16(const T* p, float (&out)[V]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec16(T* p, const float (&in)[V]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = from_f<T>(in[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// K5's work unit, a run: `pixels` consecutive pixels of one sample (the last
// run of a sample may be shorter). A stage holds the run's y ([pixels][F]
// in T) and then its targets: the 16-byte aligned span around them, copied
// by cp.async.bulk, whose last partial 16 bytes of the whole target tensor
// (when B*H*W is not a multiple of 16) the issuing thread copies itself.
template <typename T>
__host__ __device__ constexpr long long head_stage_bytes(int pixels, int F) {
  return (long long)pixels * F * sizeof(T) + round_up(pixels, 16) + 32;
}

// Shared memory of K5's forward (which = 0) and backward (which = 1) with
// runs of `pixels`: the ring, or after it the block sums (the backward's
// S, T and dw, 3V floats a thread; last_cta_sums' 16 bytes a thread).
template <typename T>
__host__ __device__ constexpr long long head_smem(int pixels, int F, int which) {
  return stream_smem(head_stage_bytes<T>(pixels, F),
                     (long long)kStreamThreads * (which ? 12 * head_vec<T>() : 16));
}

// Lane l of a group of L (a power of two) holds v[k], its 16-byte channel
// chunk's share of pixel k's dot (k < L). Afterwards v[0] of lane l holds
// pixel l's whole dot: log2(L) rounds of xor shuffles, each halving the
// pixels a lane holds (L - 1 shuffles for L pixels, in a fixed order). A
// round is a template instance, so every index of v is a constant and v
// stays in registers.
template <int L, int OFF>
struct GroupDots {
  static __device__ __forceinline__ void run(float (&v)[L], int lane) {
    const bool upper = lane & OFF;
#pragma unroll
    for (int i = 0; i < OFF; ++i) {
      const float send = upper ? v[i] : v[i + OFF];
      const float keep = upper ? v[i + OFF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    GroupDots<L, OFF / 2>::run(v, lane);
  }
};

template <int L>
struct GroupDots<L, 0> {
  static __device__ __forceinline__ void run(float (&)[L], int) {}
};

template <int L>
__device__ __forceinline__ float group_dots(float (&v)[L], int lane) {
  GroupDots<L, L / 2>::run(v, lane);
  return v[0];
}

// What K5's forward and backward share: the run's place, its copies into a
// stage, and each lane's pixel logit. A group of L lanes (L the power of two
// at or above F/V) takes L pixels at a time: lane g reads its channel chunk
// of each pixel from shared memory (a group's reads of a pixel are one
// contiguous span), and group_dots leaves lane g with pixel g's logit, so
// the sigmoid and everything after it run in every lane.
template <typename T, int L>
struct HeadRun {
  static constexpr int V = head_vec<T>();
  const T* y;
  const uint8_t* tgt;
  int HW, F, pixels, runs;  // runs: per sample
  long long total;          // B * HW, the targets' bytes
  float a[V], sh[V], w[V], hb;
  int lane, grp;            // lane of the group, group of the CTA

  __device__ void place(long long unit, int& b, size_t& q0, int& np) const {
    b = (int)(unit / runs);
    const int p0 = (int)(unit % runs) * pixels;
    np = min(pixels, HW - p0);
    q0 = (size_t)b * HW + p0;
  }

  __device__ int tgt_skew(size_t q0) const {
    return (int)(reinterpret_cast<uintptr_t>(tgt + q0) & 15);
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

  // This lane's chunk of pixel px of the stage: a*y+b, z (rounded to T), y.
  __device__ float chunk(const T* ys, int px, float (&yv)[V], float (&wl)[V],
                         float (&z)[V]) const {
    load_vec16<T, V>(ys + (size_t)px * F + lane * V, yv);
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      wl[k] = affine_rn(yv[k], a[k], sh[k]);
      z[k] = round_to<T>(fmaxf(wl[k], 0.f));
      dot = fmaf(z[k], w[k], dot);
    }
    return dot;
  }

  // The logit of pixel pb + lane (pixel group pb of the run's np pixels).
  __device__ float logit(const T* ys, int pb, int np) const {
    float v[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      float yv[V], wl[V], z[V];
      v[k] = pb + k < np && lane < F / V ? chunk(ys, pb + k, yv, wl, z) : 0.f;
    }
    return round_to<T>(round_to<T>(group_dots<L>(v, lane)) + hb);
  }
};

template <typename T, int L>
__device__ void head_run_init(HeadRun<T, L>& r, const T* y, const uint8_t* tgt,
                              const float* aff, const float* w, const float* hb, int B,
                              int HW, int F, int pixels) {
  constexpr int V = head_vec<T>();
  r.y = y;
  r.tgt = tgt;
  r.HW = HW;
  r.F = F;
  r.pixels = pixels;
  r.runs = (HW + pixels - 1) / pixels;
  r.total = (long long)B * HW;
  r.lane = threadIdx.x % L;
  r.grp = threadIdx.x / L;
  const bool act = r.lane < F / V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    r.a[k] = act ? aff[r.lane * V + k] : 0.f;
    r.sh[k] = act ? aff[F + r.lane * V + k] : 0.f;
    r.w[k] = act ? w[r.lane * V + k] : 0.f;
  }
  r.hb = hb[0];
}

template <typename T, int L>
struct HeadFwdOp : HeadRun<T, L> {
  float s[kHeadSums];
  int cur;           // the sample whose sums s holds
  float* row;        // this CTA's partial row, (B, 9)
  float (*wred)[kHeadSums];

  // the CTA's sums of sample cur into its row (once a sample: a CTA's runs
  // are contiguous); every thread calls it
  __device__ void flush() {
#pragma unroll
    for (int k = 0; k < kHeadSums; ++k) {
      const float v = warp_sum(s[k]);
      if (threadIdx.x % 32 == 0) wred[threadIdx.x / 32][k] = v;
      s[k] = 0.f;
    }
    __syncthreads();
    if (threadIdx.x < kHeadSums) {
      float acc = 0.f;
      for (int wp = 0; wp < kStreamThreads / 32; ++wp) acc += wred[wp][threadIdx.x];
      row[cur * kHeadSums + threadIdx.x] = acc;
    }
    __syncthreads();
  }

  __device__ void consume(long long unit, const char* stage) {
    int b, np;
    size_t q0;
    this->place(unit, b, q0, np);
    if (b != cur) {
      if (cur >= 0) flush();
      cur = b;
    }
    const T* ys = reinterpret_cast<const T*>(stage);
    const uint8_t* ts = reinterpret_cast<const uint8_t*>(stage) +
                        (size_t)this->pixels * this->F * sizeof(T) + this->tgt_skew(q0);
    const int groups = (np + L - 1) / L;
    for (int g0 = 0; g0 < groups; g0 += kStreamThreads / L) {
      const int pb = (g0 + this->grp) * L;
      const float l = this->logit(ys, pb, np);
      const int px = pb + this->lane;
      if (px >= np) continue;
      const float p = 1.f / (1.f + expf(-l));
      const float t = ts[px] ? 1.f : 0.f;
      const float pred = p > 0.5f ? 1.f : 0.f, pr = p >= 1.f ? 1.f : 0.f;
      s[0] += p * t;
      s[1] += p;
      s[2] += t;
      s[3] += pred * t;
      s[4] += pred;
      s[5] += t;
      s[6] += pr * t;
      s[7] += pr;
      s[8] += t;
    }
  }
};

// partials[blockIdx.x]: the CTA's (B, 9) sums (ld floats a row); the last
// CTA to arrive sums the rows into sums (B, 9).
template <typename T, int L>
__global__ void __launch_bounds__(kStreamThreads, 1)
    head_fwd_kernel(const T* __restrict__ y, const uint8_t* __restrict__ tgt,
                    const float* __restrict__ aff, const float* __restrict__ w,
                    const float* __restrict__ hb, float* __restrict__ partials,
                    float* __restrict__ sums, unsigned* counter, int B, int HW, int F,
                    int pixels, int ld) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float wred[kStreamThreads / 32][kHeadSums];
  HeadFwdOp<T, L> op;
  head_run_init<T, L>(op, y, tgt, aff, w, hb, B, HW, F, pixels);
#pragma unroll
  for (int k = 0; k < kHeadSums; ++k) op.s[k] = 0.f;
  op.cur = -1;
  op.row = partials + (size_t)blockIdx.x * ld;
  op.wred = wred;
  for (int c = threadIdx.x; c < ld; c += kStreamThreads) op.row[c] = 0.f;  // samples not taken
  long long begin, end;
  unit_range((long long)B * op.runs, gridDim.x, blockIdx.x, begin, end);
  stream_units(op, smem, head_stage_bytes<T>(pixels, F), begin, end);
  if (op.cur >= 0) op.flush();
  last_cta_sums(partials, ld, B * kHeadSums, sums, counter,
                reinterpret_cast<float4*>(smem + kStreamBarBytes));
}

template <typename T, int L>
struct HeadBwdOp : HeadRun<T, L> {
  static constexpr int V = head_vec<T>();
  const float* gsc;
  T* dzt;
  float mean[V], rstd[V], st[V], tt[V], dw[V], db, dI, dP;
  int cur;  // the sample whose dI, dP are held

  __device__ void consume(long long unit, const char* stage) {
    int b, np;
    size_t q0;
    this->place(unit, b, q0, np);
    if (b != cur) {
      dI = gsc[2 * b];
      dP = gsc[2 * b + 1];
      cur = b;
    }
    const T* ys = reinterpret_cast<const T*>(stage);
    const uint8_t* ts = reinterpret_cast<const uint8_t*>(stage) +
                        (size_t)this->pixels * this->F * sizeof(T) + this->tgt_skew(q0);
    const int F = this->F, lane = this->lane;
    const bool act = lane < F / V;
    const int groups = (np + L - 1) / L;
    for (int g0 = 0; g0 < groups; g0 += kStreamThreads / L) {
      const int pb = (g0 + this->grp) * L;
      const float l = this->logit(ys, pb, np);
      float dl = 0.f;
      if (pb + lane < np) {
        const float p = 1.f / (1.f + expf(-l));
        const float t = ts[pb + lane] ? 1.f : 0.f;
        const float dlog = (dI * t + dP) * p * (1.f - p);
        dl = round_to<T>(dlog);
        db += dlog;
      }
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float dlk = __shfl_sync(0xffffffffu, dl, k, L);
        if (pb + k >= np || !act) continue;
        float yv[V], wl[V], z[V], d[V];
        this->chunk(ys, pb + k, yv, wl, z);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          d[j] = wl[j] > 0.f ? __fmul_rn(dlk, this->w[j]) : 0.f;
          st[j] += d[j];
          tt[j] += d[j] * ((yv[j] - mean[j]) * rstd[j]);
          dw[j] += z[j] * dlk;
        }
        store_vec16<T, V>(dzt + (q0 + pb + k) * F + lane * V, d);
      }
    }
  }
};

// partials[blockIdx.x]: the CTA's S (F) | T (F) | dw (F) | db (1), ld floats
// a row; the last CTA to arrive sums the rows into out (3F + 1).
template <typename T, int L>
__global__ void __launch_bounds__(kStreamThreads, 1)
    head_bwd_kernel(const T* __restrict__ y, const uint8_t* __restrict__ tgt,
                    const float* __restrict__ aff4, const float* __restrict__ w,
                    const float* __restrict__ hb, const float* __restrict__ gsc,
                    T* __restrict__ dzt, float* __restrict__ partials, float* __restrict__ out,
                    unsigned* counter, int B, int HW, int F, int pixels, int ld) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float wred[kStreamThreads / 32];
  constexpr int V = head_vec<T>();
  HeadBwdOp<T, L> op;
  head_run_init<T, L>(op, y, tgt, aff4, w, hb, B, HW, F, pixels);
  op.gsc = gsc;
  op.dzt = dzt;
  const bool act = op.lane < F / V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    op.mean[k] = act ? aff4[2 * F + op.lane * V + k] : 0.f;
    op.rstd[k] = act ? aff4[3 * F + op.lane * V + k] : 0.f;
    op.st[k] = op.tt[k] = op.dw[k] = 0.f;
  }
  op.db = op.dI = op.dP = 0.f;
  op.cur = -1;
  long long begin, end;
  unit_range((long long)B * op.runs, gridDim.x, blockIdx.x, begin, end);
  stream_units(op, smem, head_stage_bytes<T>(pixels, F), begin, end);

  // the CTA's S, T, dw: channel f sums the groups' lanes that hold it, in
  // group order; db over the warps in order
  float* red = reinterpret_cast<float*>(smem + kStreamBarBytes);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    red[threadIdx.x * 3 * V + k] = op.st[k];
    red[threadIdx.x * 3 * V + V + k] = op.tt[k];
    red[threadIdx.x * 3 * V + 2 * V + k] = op.dw[k];
  }
  const float db = warp_sum(op.db);
  if (threadIdx.x % 32 == 0) wred[threadIdx.x / 32] = db;
  __syncthreads();
  float* row = partials + (size_t)blockIdx.x * ld;
  for (int c = threadIdx.x; c < 3 * F; c += kStreamThreads) {
    const int f = c % F, part = c / F;
    const float* col = red + (f / V) * 3 * V + part * V + f % V;
    float acc = 0.f;
    for (int g = 0; g < kStreamThreads / L; ++g) acc += col[(size_t)g * L * 3 * V];
    row[c] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int wp = 0; wp < kStreamThreads / 32; ++wp) acc += wred[wp];
    row[3 * F] = acc;
  }
  last_cta_sums(partials, ld, 3 * F + 1, out, counter,
                reinterpret_cast<float4*>(smem + kStreamBarBytes));
}

// K5's L: the power of two at or above F / V (at most 32).
int group_lanes(int F, int elem) {
  const int G = F / (16 / elem);
  int L = 1;
  while (L < G) L *= 2;
  return L;
}

// The checks of K5's plan (runs of `pixels`, ctas, smem) against the
// kernel's layout: cudaErrorInvalidValue for a plan it does not lay out so.
template <typename T>
int check_head_plan(int B, int HW, int F, int pixels, int ctas, int smem, int which) {
  const int L = group_lanes(F, (int)sizeof(T));
  const long long units = (long long)B * ((HW + pixels - 1) / pixels);
  if (F % head_vec<T>() || L > 32 || pixels < L || pixels % L || ctas < 1 || ctas > units ||
      smem != head_smem<T>(pixels, F, which))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, int L>
int launch_fwd_l(const void* y, const void* tgt, const void* aff, const void* w, const void* hb,
                 float* work, float* sums, unsigned* counter, int B, int HW, int F, int pixels,
                 int ctas, int smem, int ld, cudaStream_t stream) {
  const int err = (int)cudaFuncSetAttribute(head_fwd_kernel<T, L>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  head_fwd_kernel<T, L><<<ctas, kStreamThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const uint8_t*>(tgt), static_cast<const float*>(aff),
      static_cast<const float*>(w), static_cast<const float*>(hb), work, sums, counter, B, HW, F,
      pixels, ld);
  return (int)cudaGetLastError();
}

template <typename T, int L>
int launch_bwd_l(const void* y, const void* tgt, const void* aff4, const void* w, const void* hb,
                 const void* gsc, void* dzt, float* work, float* out, unsigned* counter, int B,
                 int HW, int F, int pixels, int ctas, int smem, int ld, cudaStream_t stream) {
  const int err = (int)cudaFuncSetAttribute(head_bwd_kernel<T, L>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  head_bwd_kernel<T, L><<<ctas, kStreamThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const uint8_t*>(tgt),
      static_cast<const float*>(aff4), static_cast<const float*>(w),
      static_cast<const float*>(hb), static_cast<const float*>(gsc), static_cast<T*>(dzt), work,
      out, counter, B, HW, F, pixels, ld);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* y, const void* tgt, const void* aff, const void* w, const void* hb,
               float* work, float* sums, unsigned* counter, int B, int HW, int F, int pixels,
               int ctas, int smem, cudaStream_t s) {
  if (const int err = check_head_plan<T>(B, HW, F, pixels, ctas, smem, 0)) return err;
  const int ld = (int)round_up(9LL * B, 4);
#define UNET_HEAD_FWD(L)                                                                  \
  case L:                                                                                 \
    return launch_fwd_l<T, L>(y, tgt, aff, w, hb, work, sums, counter, B, HW, F, pixels, \
                              ctas, smem, ld, s);
  switch (group_lanes(F, (int)sizeof(T))) {
    UNET_HEAD_FWD(1)
    UNET_HEAD_FWD(2)
    UNET_HEAD_FWD(4)
    UNET_HEAD_FWD(8)
    UNET_HEAD_FWD(16)
    UNET_HEAD_FWD(32)
  }
#undef UNET_HEAD_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_bwd(const void* y, const void* tgt, const void* aff4, const void* w, const void* hb,
               const void* gsc, void* dzt, float* work, float* out, unsigned* counter, int B,
               int HW, int F, int pixels, int ctas, int smem, cudaStream_t s) {
  if (const int err = check_head_plan<T>(B, HW, F, pixels, ctas, smem, 1)) return err;
  const int ld = (int)round_up(3LL * F + 1, 4);
#define UNET_HEAD_BWD(L)                                                                    \
  case L:                                                                                   \
    return launch_bwd_l<T, L>(y, tgt, aff4, w, hb, gsc, dzt, work, out, counter, B, HW, F, \
                              pixels, ctas, smem, ld, s);
  switch (group_lanes(F, (int)sizeof(T))) {
    UNET_HEAD_BWD(1)
    UNET_HEAD_BWD(2)
    UNET_HEAD_BWD(4)
    UNET_HEAD_BWD(8)
    UNET_HEAD_BWD(16)
    UNET_HEAD_BWD(32)
  }
#undef UNET_HEAD_BWD
  return (int)cudaErrorInvalidValue;
}

// K11's blocks per sample: about 4 blocks per SM of a 132-SM card in all.
int blocks_per_sample(int B, int HW, int F, int elem) {
  const int R = kThreads / group_lanes(F, elem);
  const int want = (528 + B - 1) / B;
  return std::max(1, std::min(want, (HW + R - 1) / R));
}

// ---------------------------------------------------------------------------
// K11: the softmax head, NC = 2..4 classes.
//
// Replaces the TPU kernels unet_image_segmentation_tpu/ops/pallas/
// fused_head.py:_head_fwd_kernel_mc and _head_bwd_kernel_mc (launched by
// head_fwd_sums_mc and head_bwd_mc). Per pixel, with the head weights w
// (F, NC) and biases hb (NC,) rounded to T and class-id targets t:
//
//   z   = relu(a*y + b) -> T
//   l_c = T(T(Σ_f z_f w_fc) + hb_c);  p = softmax(l) in fp32 (max-subtracted
//         exp, normalised);  pred = the first class of maximal p
//   forward: per-sample fp32 sums I_c = Σ p_c [t=c], P_c = Σ p_c,
//            T_c = Σ [t=c], CCE = Σ -log(max(p_t, 1e-7)), CM[t][pred] += 1
//            (a target id >= NC counts in no class)
//   backward: dy_c = dI_c [t=c] + dP_c + dCCE (p_c >= eps ? -[t=c]/max(p_c, eps) : 0),
//             dl_c = p_c (dy_c - Σ_k p_k dy_k), dlb_c = T(dl_c),
//             dzt_f = (a y + b > 0) ? Σ_c dlb_c w_fc : 0   (written in T),
//             S = Σ dzt, T = Σ dzt (y - mean) rstd, dw_fc = Σ z_f dlb_c,
//             db_c = Σ dl_c (the unrounded dl).
//
// Bound on the H100 as K5's: device memory (y read once per direction, dzt
// written by the backward; 2 * NC + 10 flops per channel a pixel).
//
// Design (the first K5's, which K11 keeps until it moves onto K5's
// streaming body): a pixel is split over a group of L lanes (L the power of
// two at or above F/V), one 16-byte vector of y each, on a grid of
// (blocks_per_sample, B). The NC dot products, the softmax and the
// backward's class sums are computed with separately rounded products and
// sums (no FMA contraction) in the order the plain version uses: the
// thread's channels in sequence, then the xor butterfly over the pixel's
// group, then the classes in sequence. Logits, probabilities and the argmax
// therefore agree with the plain version bit for bit on the card, and the
// confusion-matrix counts come out equal. Per-sample partial rows are
// summed by the fixed-order reduce_rows(); the counts are exact in fp32
// (under 2^24 pixels a sample).
// ---------------------------------------------------------------------------

constexpr float kClipEps = 1e-7f;

template <int NC>
__host__ __device__ constexpr int mc_sums() { return 3 * NC + 1 + NC * NC; }

template <typename T, int V, int NC>
__device__ __forceinline__ void mc_logits(const float (&yv)[V], const float (&a)[V],
                                          const float (&sh)[V], const float (&w)[NC][V],
                                          const float (&hb)[NC], int L, float (&wl)[V],
                                          float (&z)[V], float (&l)[NC]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    wl[j] = affine_rn(yv[j], a[j], sh[j]);
    z[j] = round_to<T>(fmaxf(wl[j], 0.f));
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float d = __fmul_rn(z[0], w[c][0]);
#pragma unroll
    for (int j = 1; j < V; ++j) d = __fadd_rn(d, __fmul_rn(z[j], w[c][j]));
    for (int off = L / 2; off > 0; off >>= 1)
      d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, off));
    l[c] = round_to<T>(__fadd_rn(round_to<T>(d), hb[c]));
  }
}

template <int NC>
__device__ __forceinline__ void mc_softmax(const float (&l)[NC], float (&p)[NC]) {
  float m = l[0];
#pragma unroll
  for (int c = 1; c < NC; ++c) m = fmaxf(m, l[c]);
  float e[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) e[c] = expf(__fsub_rn(l[c], m));
  float s = e[0];
#pragma unroll
  for (int c = 1; c < NC; ++c) s = __fadd_rn(s, e[c]);
#pragma unroll
  for (int c = 0; c < NC; ++c) p[c] = __fdiv_rn(e[c], s);
}

// the first class whose probability is maximal
template <int NC>
__device__ __forceinline__ int mc_argmax(const float (&p)[NC]) {
  float m = p[0];
#pragma unroll
  for (int c = 1; c < NC; ++c) m = fmaxf(m, p[c]);
  int pred = NC - 1;
#pragma unroll
  for (int c = NC - 1; c >= 0; --c)
    if (p[c] == m) pred = c;
  return pred;
}

// partials[blockIdx.x][b * NS + k]: the block's share of sample b's sums in
// the order I (NC) | P (NC) | T (NC) | CCE | CM (NC x NC, row = target).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    head_fwd_mc_kernel(const T* __restrict__ y, const uint8_t* __restrict__ tgt,
                       const float* __restrict__ aff, const float* __restrict__ w,
                       const float* __restrict__ hb_p, float* __restrict__ partials, int B,
                       int HW, int F, int L) {
  constexpr int V = head_vec<T>();
  constexpr int NS = mc_sums<NC>();
  __shared__ float red[kThreads * NS];
  const int G = F / V, R = kThreads / L;
  const int lane = threadIdx.x % L, r = threadIdx.x / L;
  const bool act = lane < G;
  const int f0 = lane * V, b = blockIdx.y;
  float a[V], sh[V], wv[NC][V], hb[NC];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = act ? aff[f0 + j] : 0.f;
    sh[j] = act ? aff[F + f0 + j] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) wv[c][j] = act ? w[(f0 + j) * NC + c] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) hb[c] = hb_p[c];
  float s[NS] = {};
  const T* yb = y + (size_t)b * HW * F;
  for (int base = blockIdx.x * R; base < HW; base += gridDim.x * R) {
    const int px = base + r;
    const bool valid = px < HW;
    float yv[V] = {}, wl[V], z[V], l[NC];
    if (valid && act) load_vec16<T, V>(yb + (size_t)px * F + f0, yv);
    mc_logits<T, V, NC>(yv, a, sh, wv, hb, L, wl, z, l);
    if (valid && lane == 0) {
      float p[NC];
      mc_softmax<NC>(l, p);
      const int pred = mc_argmax<NC>(p);
      const int t = tgt[(size_t)b * HW + px];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s[NC + c] += p[c];
        if (c != t) continue;
        s[c] += p[c];
        s[2 * NC + c] += 1.f;
        s[3 * NC] -= logf(fmaxf(p[c], kClipEps));
#pragma unroll
        for (int k = 0; k < NC; ++k)
          if (k == pred) s[3 * NC + 1 + c * NC + k] += 1.f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) red[threadIdx.x * NS + k] = s[k];
  __syncthreads();
  if (threadIdx.x < NS) {
    float acc = 0.f;
    for (int rr = 0; rr < R; ++rr) acc += red[rr * L * NS + threadIdx.x];
    partials[(size_t)blockIdx.x * B * NS + b * NS + threadIdx.x] = acc;
  }
}

// partials[blockIdx.y * gridDim.x + blockIdx.x] rows of (2 + NC) F + NC:
// S (F) | T (F) | dw (F x NC) | db (NC).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    head_bwd_mc_kernel(const T* __restrict__ y, const uint8_t* __restrict__ tgt,
                       const float* __restrict__ aff4, const float* __restrict__ w,
                       const float* __restrict__ hb_p, const float* __restrict__ gsc,
                       T* __restrict__ dzt, float* __restrict__ partials, int HW, int F, int L) {
  constexpr int V = head_vec<T>();
  constexpr int NS = (2 + NC) * V + NC;
  extern __shared__ float red[];  // [kThreads][NS]
  const int G = F / V, R = kThreads / L;
  const int lane = threadIdx.x % L, r = threadIdx.x / L;
  const bool act = lane < G;
  const int f0 = lane * V, b = blockIdx.y;
  float a[V], sh[V], mean[V], rstd[V], wv[NC][V], hb[NC], gi[NC], gp[NC];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = act ? aff4[f0 + j] : 0.f;
    sh[j] = act ? aff4[F + f0 + j] : 0.f;
    mean[j] = act ? aff4[2 * F + f0 + j] : 0.f;
    rstd[j] = act ? aff4[3 * F + f0 + j] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) wv[c][j] = act ? w[(f0 + j) * NC + c] : 0.f;
  }
  const float* g = gsc + b * (2 * NC + 1);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    hb[c] = hb_p[c];
    gi[c] = g[c];
    gp[c] = g[NC + c];
  }
  const float gc = g[2 * NC];
  float st[V] = {}, tt[V] = {}, dw[NC][V] = {}, db[NC] = {};
  const size_t img = (size_t)b * HW;
  for (int base = blockIdx.x * R; base < HW; base += gridDim.x * R) {
    const int px = base + r;
    const bool valid = px < HW;
    float yv[V] = {}, wl[V], z[V], l[NC];
    if (valid && act) load_vec16<T, V>(y + (img + px) * F + f0, yv);
    mc_logits<T, V, NC>(yv, a, sh, wv, hb, L, wl, z, l);
    if (!valid) continue;
    float p[NC], dy[NC], dlb[NC];
    mc_softmax<NC>(l, p);
    const int t = tgt[img + px];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float tc = c == t ? 1.f : 0.f;
      const float q = p[c] >= kClipEps ? __fdiv_rn(-tc, fmaxf(p[c], kClipEps)) : 0.f;
      dy[c] = __fadd_rn(__fadd_rn(__fmul_rn(gi[c], tc), gp[c]), __fmul_rn(gc, q));
    }
    float ydot = __fmul_rn(p[0], dy[0]);
#pragma unroll
    for (int c = 1; c < NC; ++c) ydot = __fadd_rn(ydot, __fmul_rn(p[c], dy[c]));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float dl = __fmul_rn(p[c], __fsub_rn(dy[c], ydot));
      dlb[c] = round_to<T>(dl);
      if (lane == 0) db[c] += dl;
    }
    if (!act) continue;
    float d[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = __fmul_rn(dlb[0], wv[0][j]);
#pragma unroll
      for (int c = 1; c < NC; ++c) v = __fadd_rn(v, __fmul_rn(dlb[c], wv[c][j]));
      d[j] = wl[j] > 0.f ? v : 0.f;
      st[j] += d[j];
      tt[j] += d[j] * ((yv[j] - mean[j]) * rstd[j]);
#pragma unroll
      for (int c = 0; c < NC; ++c) dw[c][j] += z[j] * dlb[c];
    }
    store_vec16<T, V>(dzt + (img + px) * F + f0, d);
  }
  float* mine = red + threadIdx.x * NS;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mine[j] = st[j];
    mine[V + j] = tt[j];
#pragma unroll
    for (int c = 0; c < NC; ++c) mine[(2 + c) * V + j] = dw[c][j];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) mine[(2 + NC) * V + c] = db[c];
  __syncthreads();
  if (r == 0 && act) {
    float* row = partials + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ((2 + NC) * F + NC);
    for (int k = 0; k < (2 + NC) * V; ++k) {
      float acc = 0.f;
      for (int rr = 0; rr < R; ++rr) acc += red[(rr * L + lane) * NS + k];
      const int part = k / V, f = f0 + k % V;
      row[part < 2 ? part * F + f : 2 * F + f * NC + (part - 2)] = acc;
    }
    if (lane == 0) {
      for (int c = 0; c < NC; ++c) {
        float acc = 0.f;
        for (int rr = 0; rr < R; ++rr) acc += red[(rr * L) * NS + (2 + NC) * V + c];
        row[(2 + NC) * F + c] = acc;
      }
    }
  }
}

template <typename T, int NC>
int launch_fwd_mc(const void* y, const void* tgt, const void* aff, const void* w, const void* hb,
                  float* work, float* sums, int B, int HW, int F, cudaStream_t stream) {
  constexpr int NS = mc_sums<NC>();
  const int L = group_lanes(F, (int)sizeof(T));
  const int bps = blocks_per_sample(B, HW, F, (int)sizeof(T));
  head_fwd_mc_kernel<T, NC><<<dim3(bps, B), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const uint8_t*>(tgt), static_cast<const float*>(aff),
      static_cast<const float*>(w), static_cast<const float*>(hb), work, B, HW, F, L);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  float* scratch = work + (long long)bps * B * NS;
  return reduce_rows(work, bps, B * NS, scratch, sums, stream);
}

template <typename T, int NC>
int launch_bwd_mc(const void* y, const void* tgt, const void* aff4, const void* w,
                  const void* hb, const void* gsc, void* dzt, float* work, float* out, int B,
                  int HW, int F, cudaStream_t stream) {
  constexpr int NS = (2 + NC) * head_vec<T>() + NC;
  const int smem = kThreads * NS * (int)sizeof(float);
  int err = (int)cudaFuncSetAttribute(head_bwd_mc_kernel<T, NC>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const int L = group_lanes(F, (int)sizeof(T));
  const int bps = blocks_per_sample(B, HW, F, (int)sizeof(T));
  head_bwd_mc_kernel<T, NC><<<dim3(bps, B), kThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const uint8_t*>(tgt), static_cast<const float*>(aff4),
      static_cast<const float*>(w), static_cast<const float*>(hb),
      static_cast<const float*>(gsc), static_cast<T*>(dzt), work, HW, F, L);
  if ((err = (int)cudaGetLastError())) return err;
  const long long rows = (long long)bps * B;
  const int cols = (2 + NC) * F + NC;
  float* scratch = work + rows * cols;
  return reduce_rows(work, (int)rows, cols, scratch, out, stream);
}

template <typename T>
int fwd_mc(int NC, const void* y, const void* tgt, const void* aff, const void* w, const void* hb,
           float* work, float* sums, int B, int HW, int F, cudaStream_t s) {
  switch (NC) {
    case 2: return launch_fwd_mc<T, 2>(y, tgt, aff, w, hb, work, sums, B, HW, F, s);
    case 3: return launch_fwd_mc<T, 3>(y, tgt, aff, w, hb, work, sums, B, HW, F, s);
    case 4: return launch_fwd_mc<T, 4>(y, tgt, aff, w, hb, work, sums, B, HW, F, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_mc(int NC, const void* y, const void* tgt, const void* aff4, const void* w,
           const void* hb, const void* gsc, void* dzt, float* work, float* out, int B, int HW,
           int F, cudaStream_t s) {
  switch (NC) {
    case 2: return launch_bwd_mc<T, 2>(y, tgt, aff4, w, hb, gsc, dzt, work, out, B, HW, F, s);
    case 3: return launch_bwd_mc<T, 3>(y, tgt, aff4, w, hb, gsc, dzt, work, out, B, HW, F, s);
    case 4: return launch_bwd_mc<T, 4>(y, tgt, aff4, w, hb, gsc, dzt, work, out, B, HW, F, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace unet

// y (B,H,W,F) in T, HW = H*W, 16-byte aligned; tgt (B,H,W) uint8 0/1; aff
// (2,F) fp32 = a, b; w (F,) and hb (1,) fp32, rounded to T; sums (B,9) fp32
// in the order i, p, t, it, pt, tt, ir, pr, tr; work (ctas, round_up(9B, 4))
// fp32 rows; counter an unsigned int that is 0 and is left 0; the plan of
// ops/fused_head.head_plan: runs of `pixels`, ctas, smem bytes. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan the kernel does
// not lay out so.
extern "C" int unet_head_fwd(const void* y, const void* tgt, const void* aff, const void* w,
                             const void* hb, void* work, void* sums, void* counter, int B,
                             int HW, int F, int pixels, int ctas, int smem, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(sums);
  unsigned* c = static_cast<unsigned*>(counter);
  if (dtype == 0)
    return unet::launch_fwd<float>(y, tgt, aff, w, hb, wk, o, c, B, HW, F, pixels, ctas, smem, s);
  if (dtype == 1)
    return unet::launch_fwd<__nv_bfloat16>(y, tgt, aff, w, hb, wk, o, c, B, HW, F, pixels, ctas,
                                           smem, s);
  return (int)cudaErrorInvalidValue;
}

// As unet_head_fwd, plus aff4 (4,F) fp32 = a, b, mean, rstd; gsc (B,2) fp32
// = dI, dP; dzt (B,H,W,F) in T; out (3F+1) fp32 = S | T | dw | db; work
// (ctas, round_up(3F+1, 4)) fp32 rows. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernel does not lay out so.
extern "C" int unet_head_bwd(const void* y, const void* tgt, const void* aff4, const void* w,
                             const void* hb, const void* gsc, void* dzt, void* work, void* out,
                             void* counter, int B, int HW, int F, int pixels, int ctas, int smem,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
  unsigned* c = static_cast<unsigned*>(counter);
  if (dtype == 0)
    return unet::launch_bwd<float>(y, tgt, aff4, w, hb, gsc, dzt, wk, o, c, B, HW, F, pixels,
                                   ctas, smem, s);
  if (dtype == 1)
    return unet::launch_bwd<__nv_bfloat16>(y, tgt, aff4, w, hb, gsc, dzt, wk, o, c, B, HW, F,
                                           pixels, ctas, smem, s);
  return (int)cudaErrorInvalidValue;
}

// Floats of workspace unet_head_fwd_mc (which = 0) or unet_head_bwd_mc
// (which = 1) needs for NC classes.
extern "C" long long unet_head_mc_workspace(int B, int HW, int F, int NC, int dtype, int which) {
  const int elem = dtype == 0 ? 4 : 2;
  const long long rows = unet::blocks_per_sample(B, HW, F, elem) * (which ? (long long)B : 1LL);
  const long long cols = which ? (2LL + NC) * F + NC : (long long)B * (3 * NC + 1 + NC * NC);
  return rows * cols + unet::reduce_scratch_floats(rows, cols);
}

// K11 forward. y (B,H,W,F) in T, HW = H*W; tgt (B,H,W) uint8 class ids;
// aff (2,F) fp32 = a, b; w (F,NC) and hb (NC,) fp32, rounded to T; sums
// (B, 3NC+1+NC*NC) fp32 = I | P | T | CCE | CM. NC in 2..4. Returns
// cudaGetLastError().
extern "C" int unet_head_fwd_mc(const void* y, const void* tgt, const void* aff, const void* w,
                                const void* hb, void* work, void* sums, int B, int HW, int F,
                                int NC, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(sums);
  if (dtype == 0) return unet::fwd_mc<float>(NC, y, tgt, aff, w, hb, wk, o, B, HW, F, s);
  if (dtype == 1)
    return unet::fwd_mc<__nv_bfloat16>(NC, y, tgt, aff, w, hb, wk, o, B, HW, F, s);
  return (int)cudaErrorInvalidValue;
}

// K11 backward: as unet_head_fwd_mc, plus aff4 (4,F) fp32 = a, b, mean,
// rstd; gsc (B, 2NC+1) fp32 = dI (NC) | dP (NC) | dCCE; dzt (B,H,W,F) in T;
// out ((2+NC)F + NC) fp32 = S | T | dw (F,NC) | db (NC). Returns
// cudaGetLastError().
extern "C" int unet_head_bwd_mc(const void* y, const void* tgt, const void* aff4, const void* w,
                                const void* hb, const void* gsc, void* dzt, void* work, void* out,
                                int B, int HW, int F, int NC, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return unet::bwd_mc<float>(NC, y, tgt, aff4, w, hb, gsc, dzt, wk, o, B, HW, F, s);
  if (dtype == 1)
    return unet::bwd_mc<__nv_bfloat16>(NC, y, tgt, aff4, w, hb, gsc, dzt, wk, o, B, HW, F, s);
  return (int)cudaErrorInvalidValue;
}
