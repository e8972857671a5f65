// K5: the sigmoid segmentation head fused into the last decoder chain's
// exit (its softmax sibling K11 is head_mc.cu).
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
#include "head_common.cuh"

namespace unet {
namespace {

constexpr int kHeadSums = 9;      // i, p, t, it, pt, tt, ir, pr, tr

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

// What K5's forward and backward share: the run, and each lane's pixel
// logit. A group of L lanes (L the power of two at or above F/V) takes L
// pixels at a time: lane g reads its channel chunk of each pixel from shared
// memory (a group's reads of a pixel are one contiguous span), and
// group_dots leaves lane g with pixel g's logit, so the sigmoid and
// everything after it run in every lane.
template <typename T, int L>
struct HeadRun : RunSpan<T> {
  static constexpr int V = head_vec<T>();
  float a[V], sh[V], w[V], hb;
  int lane, grp;            // lane of the group, group of the CTA

  // This lane's chunk of pixel px of the stage: a*y+b, z (rounded to T), y.
  __device__ float chunk(const T* ys, int px, float (&yv)[V], float (&wl)[V],
                         float (&z)[V]) const {
    load_vec<T, V>(ys + (size_t)px * this->F + lane * V, yv);
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
      v[k] = pb + k < np && lane < this->F / V ? chunk(ys, pb + k, yv, wl, z) : 0.f;
    }
    return round_to<T>(round_to<T>(group_dots<L>(v, lane)) + hb);
  }
};

template <typename T, int L>
__device__ void head_run_init(HeadRun<T, L>& r, const T* y, const uint8_t* tgt,
                              const float* aff, const float* w, const float* hb, int B,
                              int HW, int F, int pixels) {
  constexpr int V = head_vec<T>();
  r.init(y, tgt, B, HW, F, pixels);
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
    const T* ys = this->stage_y(stage);
    const uint8_t* ts = this->stage_t(stage, q0);
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
    const T* ys = this->stage_y(stage);
    const uint8_t* ts = this->stage_t(stage, q0);
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
        store_vec<T, V>(dzt + (q0 + pb + k) * F + lane * V, d);
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

// The checks of K5's plan (runs of `pixels`, ctas, smem) against the
// kernel's layout: cudaErrorInvalidValue for a plan it does not lay out so.
template <typename T>
int check_head_plan(int B, int HW, int F, int pixels, int ctas, int smem, int which) {
  if (const int err = check_run_plan<T>(B, HW, F, pixels, ctas)) return err;
  return smem != head_smem<T>(pixels, F, which) ? (int)cudaErrorInvalidValue : 0;
}

template <typename T>
int launch_fwd(const void* y, const void* tgt, const void* aff, const void* w, const void* hb,
               float* work, float* sums, unsigned* counter, int B, int HW, int F, int pixels,
               int ctas, int smem, cudaStream_t s) {
  if (const int err = check_head_plan<T>(B, HW, F, pixels, ctas, smem, 0)) return err;
  const int ld = (int)round_up(9LL * B, 4);
#define UNET_HEAD_FWD(L)                                                                 \
  case L:                                                                                \
    return launch_stream(head_fwd_kernel<T, L>, ctas, smem, s, static_cast<const T*>(y),   \
                         static_cast<const uint8_t*>(tgt), static_cast<const float*>(aff), \
                         static_cast<const float*>(w), static_cast<const float*>(hb), work,  \
                         sums, counter, B, HW, F, pixels, ld);
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
#define UNET_HEAD_BWD(L)                                                                   \
  case L:                                                                                  \
    return launch_stream(head_bwd_kernel<T, L>, ctas, smem, s, static_cast<const T*>(y),     \
                         static_cast<const uint8_t*>(tgt), static_cast<const float*>(aff4),  \
                         static_cast<const float*>(w), static_cast<const float*>(hb),        \
                         static_cast<const float*>(gsc), static_cast<T*>(dzt), work, out,    \
                         counter, B, HW, F, pixels, ld);
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

