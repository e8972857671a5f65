// K5: the segmentation head fused into the last decoder chain's exit.
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
