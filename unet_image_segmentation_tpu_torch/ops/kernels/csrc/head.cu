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
// Design: a pixel is handled by a group of L threads (L the power of two at
// or above F/V, V = 16 bytes of channels), so each thread loads one 16-byte
// vector of y and its dot partial is summed over the group by xor shuffles.
// Blocks cover a fixed range of one sample's pixels (grid (blocks per
// sample, B)); all threads of a block walk the same rounds, so the shuffles
// never diverge. Each thread keeps its channels' S, T and dw in registers; a
// block sums its threads in a fixed order into one row of partials, and
// reduce_rows() sums the rows in a fixed order: no atomics anywhere. The
// ReLU mask is decided on a*y+b with separate roundings (affine_rn), as the
// plain version computes it, and the sigmoid uses expf.
#include <algorithm>

#include "train_common.cuh"

namespace unet {
namespace {

constexpr int kHeadSums = 9;      // i, p, t, it, pt, tt, ir, pr, tr
constexpr int kMaxV = 8;          // channels of one 16-byte vector, bf16

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

// The logit of one pixel from its group's vectors: every lane of the group
// gets the full dot. wl and z are the thread's channels' affine and z.
template <typename T, int V>
__device__ __forceinline__ float head_logit(const float (&yv)[V], const float (&a)[V],
                                            const float (&sh)[V], const float (&w)[V],
                                            float hb, int L, float (&wl)[V], float (&z)[V]) {
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    wl[j] = affine_rn(yv[j], a[j], sh[j]);
    z[j] = round_to<T>(fmaxf(wl[j], 0.f));
    dot = fmaf(z[j], w[j], dot);
  }
  for (int off = L / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  return round_to<T>(round_to<T>(dot) + hb);
}

// partials[blockIdx.x][b * 9 + k]: the block's share of sample b's sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    head_fwd_kernel(const T* __restrict__ y, const uint8_t* __restrict__ tgt,
                    const float* __restrict__ aff, const float* __restrict__ w,
                    const float* __restrict__ hb_p, float* __restrict__ partials, int B, int HW,
                    int F, int L) {
  constexpr int V = head_vec<T>();
  __shared__ float red[kThreads * kHeadSums];
  const int G = F / V, R = kThreads / L;
  const int lane = threadIdx.x % L, r = threadIdx.x / L;
  const bool act = lane < G;
  const int f0 = lane * V, b = blockIdx.y;
  float a[V], sh[V], wv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = act ? aff[f0 + j] : 0.f;
    sh[j] = act ? aff[F + f0 + j] : 0.f;
    wv[j] = act ? w[f0 + j] : 0.f;
  }
  const float hb = hb_p[0];
  float s[kHeadSums] = {};
  const T* yb = y + (size_t)b * HW * F;
  for (int base = blockIdx.x * R; base < HW; base += gridDim.x * R) {
    const int px = base + r;
    const bool valid = px < HW;
    float yv[V] = {}, wl[V], z[V];
    if (valid && act) load_vec16<T, V>(yb + (size_t)px * F + f0, yv);
    const float l = head_logit<T, V>(yv, a, sh, wv, hb, L, wl, z);
    if (valid && lane == 0) {
      const float p = 1.f / (1.f + expf(-l));
      const float t = tgt[(size_t)b * HW + px] ? 1.f : 0.f;
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
#pragma unroll
  for (int k = 0; k < kHeadSums; ++k) red[threadIdx.x * kHeadSums + k] = s[k];
  __syncthreads();
  if (threadIdx.x < kHeadSums) {
    float acc = 0.f;
    for (int rr = 0; rr < R; ++rr) acc += red[rr * L * kHeadSums + threadIdx.x];
    partials[(size_t)blockIdx.x * B * kHeadSums + b * kHeadSums + threadIdx.x] = acc;
  }
}

// partials[blockIdx.y * gridDim.x + blockIdx.x] rows of 3F+1: S | T | dw | db.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    head_bwd_kernel(const T* __restrict__ y, const uint8_t* __restrict__ tgt,
                    const float* __restrict__ aff4, const float* __restrict__ w,
                    const float* __restrict__ hb_p, const float* __restrict__ gsc,
                    T* __restrict__ dzt, float* __restrict__ partials, int HW, int F, int L) {
  constexpr int V = head_vec<T>();
  constexpr int NS = 3 * V + 1;
  __shared__ float red[kThreads * (3 * kMaxV + 1)];
  const int G = F / V, R = kThreads / L;
  const int lane = threadIdx.x % L, r = threadIdx.x / L;
  const bool act = lane < G;
  const int f0 = lane * V, b = blockIdx.y;
  float a[V], sh[V], mean[V], rstd[V], wv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = act ? aff4[f0 + j] : 0.f;
    sh[j] = act ? aff4[F + f0 + j] : 0.f;
    mean[j] = act ? aff4[2 * F + f0 + j] : 0.f;
    rstd[j] = act ? aff4[3 * F + f0 + j] : 0.f;
    wv[j] = act ? w[f0 + j] : 0.f;
  }
  const float hb = hb_p[0], dI = gsc[2 * b], dP = gsc[2 * b + 1];
  float st[V] = {}, tt[V] = {}, dw[V] = {}, db = 0.f;
  const size_t img = (size_t)b * HW;
  for (int base = blockIdx.x * R; base < HW; base += gridDim.x * R) {
    const int px = base + r;
    const bool valid = px < HW;
    float yv[V] = {}, wl[V], z[V];
    if (valid && act) load_vec16<T, V>(y + (img + px) * F + f0, yv);
    const float l = head_logit<T, V>(yv, a, sh, wv, hb, L, wl, z);
    if (!valid) continue;
    const float p = 1.f / (1.f + expf(-l));
    const float t = tgt[img + px] ? 1.f : 0.f;
    const float dlog = (dI * t + dP) * p * (1.f - p);
    const float dl = round_to<T>(dlog);
    if (lane == 0) db += dlog;
    if (!act) continue;
    float d[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      d[j] = wl[j] > 0.f ? __fmul_rn(dl, wv[j]) : 0.f;
      st[j] += d[j];
      tt[j] += d[j] * ((yv[j] - mean[j]) * rstd[j]);
      dw[j] += z[j] * dl;
    }
    store_vec16<T, V>(dzt + (img + px) * F + f0, d);
  }
  float* mine = red + threadIdx.x * NS;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mine[j] = st[j];
    mine[V + j] = tt[j];
    mine[2 * V + j] = dw[j];
  }
  mine[3 * V] = db;
  __syncthreads();
  if (r == 0 && act) {
    float* row = partials + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (3 * F + 1);
    for (int k = 0; k < 3 * V; ++k) {
      float acc = 0.f;
      for (int rr = 0; rr < R; ++rr) acc += red[(rr * L + lane) * NS + k];
      row[(k / V) * F + f0 + k % V] = acc;
    }
    if (lane == 0) {
      float acc = 0.f;
      for (int rr = 0; rr < R; ++rr) acc += red[(rr * L) * NS + 3 * V];
      row[3 * F] = acc;
    }
  }
}

int group_lanes(int F, int elem) {
  const int G = F / (16 / elem);
  int L = 1;
  while (L < G) L *= 2;
  return L;
}

// Blocks per sample: about 4 blocks per SM of a 132-SM card in all.
int blocks_per_sample(int B, int HW, int F, int elem) {
  const int R = kThreads / group_lanes(F, elem);
  const int want = (528 + B - 1) / B;
  return std::max(1, std::min(want, (HW + R - 1) / R));
}

template <typename T>
int launch_fwd(const void* y, const void* tgt, const void* aff, const void* w, const void* hb,
               float* work, float* sums, int B, int HW, int F, cudaStream_t stream) {
  const int L = group_lanes(F, (int)sizeof(T));
  const int bps = blocks_per_sample(B, HW, F, (int)sizeof(T));
  head_fwd_kernel<T><<<dim3(bps, B), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const uint8_t*>(tgt), static_cast<const float*>(aff),
      static_cast<const float*>(w), static_cast<const float*>(hb), work, B, HW, F, L);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  float* scratch = work + (long long)bps * B * kHeadSums;
  return reduce_rows(work, bps, B * kHeadSums, scratch, sums, stream);
}

template <typename T>
int launch_bwd(const void* y, const void* tgt, const void* aff4, const void* w, const void* hb,
               const void* gsc, void* dzt, float* work, float* out, int B, int HW, int F,
               cudaStream_t stream) {
  const int L = group_lanes(F, (int)sizeof(T));
  const int bps = blocks_per_sample(B, HW, F, (int)sizeof(T));
  head_bwd_kernel<T><<<dim3(bps, B), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const uint8_t*>(tgt), static_cast<const float*>(aff4),
      static_cast<const float*>(w), static_cast<const float*>(hb),
      static_cast<const float*>(gsc), static_cast<T*>(dzt), work, HW, F, L);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long long rows = (long long)bps * B;
  float* scratch = work + rows * (3 * F + 1);
  return reduce_rows(work, (int)rows, 3 * F + 1, scratch, out, stream);
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
// Design: K5's plan. The NC dot products, the softmax and the backward's
// class sums are computed with separately rounded products and sums (no FMA
// contraction) in the order the plain version uses: the thread's channels in
// sequence, then the xor butterfly over the pixel's group, then the classes
// in sequence. Logits, probabilities and the argmax therefore agree with the
// plain version bit for bit on the card, and the confusion-matrix counts come
// out equal. Per-sample partial rows and the fixed-order reduce_rows() sum
// them as in K5; the counts are exact in fp32 (under 2^24 pixels a sample).
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

// Floats of workspace unet_head_fwd (which = 0) or unet_head_bwd (which = 1)
// needs. F/(16/sizeof(T)) must be at most 32.
extern "C" long long unet_head_workspace(int B, int HW, int F, int dtype, int which) {
  const int elem = dtype == 0 ? 4 : 2;
  const long long rows = unet::blocks_per_sample(B, HW, F, elem) * (which ? (long long)B : 1LL);
  const long long cols = which ? 3LL * F + 1 : (long long)B * unet::kHeadSums;
  return rows * cols + unet::reduce_scratch_floats(rows, cols);
}

// y (B,H,W,F) in T, HW = H*W; tgt (B,H,W) uint8 0/1; aff (2,F) fp32 = a, b;
// w (F,) and hb (1,) fp32, rounded to T; sums (B,9) fp32 in the order
// i, p, t, it, pt, tt, ir, pr, tr. Returns cudaGetLastError().
extern "C" int unet_head_fwd(const void* y, const void* tgt, const void* aff, const void* w,
                             const void* hb, void* work, void* sums, int B, int HW, int F,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(sums);
  if (dtype == 0) return unet::launch_fwd<float>(y, tgt, aff, w, hb, wk, o, B, HW, F, s);
  if (dtype == 1)
    return unet::launch_fwd<__nv_bfloat16>(y, tgt, aff, w, hb, wk, o, B, HW, F, s);
  return (int)cudaErrorInvalidValue;
}

// As unet_head_fwd, plus aff4 (4,F) fp32 = a, b, mean, rstd; gsc (B,2) fp32
// = dI, dP; dzt (B,H,W,F) in T; out (3F+1) fp32 = S | T | dw | db.
// Returns cudaGetLastError().
extern "C" int unet_head_bwd(const void* y, const void* tgt, const void* aff4, const void* w,
                             const void* hb, const void* gsc, void* dzt, void* work, void* out,
                             int B, int HW, int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return unet::launch_bwd<float>(y, tgt, aff4, w, hb, gsc, dzt, wk, o, B, HW, F, s);
  if (dtype == 1)
    return unet::launch_bwd<__nv_bfloat16>(y, tgt, aff4, w, hb, gsc, dzt, wk, o, B, HW, F, s);
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
