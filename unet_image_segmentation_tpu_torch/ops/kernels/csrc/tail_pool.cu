// K3 and K4: an encoder stage's chain boundary with the 2x2 max pool.
//
// K3 (tail_pool_kernel) replaces the TPU kernels unet_image_segmentation_tpu/
// ops/pallas/fused_train.py:_tail_pool_kernel, _tail_pool_kernel_stream and
// _tail_pool_kernel_p1, three layout variants of one computation:
//   z = relu(a*y + b) -> T (the skip), pooled = 2x2 max of the rounded z.
// K4 (tail_pool_bwd_kernel) replaces _tail_pool_bwd_kernel,
// _tail_pool_bwd_kernel_stream and _tail_pool_bwd_kernel_p1:
//   the pooled cotangent (in T) goes to the FIRST maximum of each window in
//   row-major order, compared on the rounded z (ties are common after the
//   ReLU); the skip cotangent is added; the result is masked by
//   a*y + b > 0 and written as dzt in T, with S = Σdzt and
//   T = Σdzt*(y - mean)*rstd taken from the fp32 dzt.
//
// What bounds them on the H100: device memory. Per element K3 reads y and
// writes z (plus a quarter for the pool), K4 reads y and the skip cotangent
// and writes dzt (plus a quarter for the pooled cotangent), with a handful
// of flops each. At the 256 px step's four boundaries in bf16 that is 1.63
// GB for K4, 0.49 ms at 3.35 TB/s.
//
// K3: one thread per (2x2 window, 16-byte channel group), so every load and
// store is one 16-byte vector along F (4 fp32 or 8 bf16 channels) and a
// warp's accesses to one pixel are contiguous; a grid-stride loop.
//
// K4 ran K3's shape with the S/T sums (a fixed 132 x 4 grid, each thread's
// gs loads issued only after its y loads and the first-max decision, a
// second launch for the row sums) and reached 45% of its bound in bf16,
// taking nearly fp32's time for half the bytes. It now runs on the
// streaming body of stream_sums.cuh: a CTA an SM
// (ops/fused_train.pool_bwd_plan) walks strips of n windows of one pooled
// row, whose y and gs row pairs and gp segment are five contiguous spans
// that one thread copies into a 3-stage ring with cp.async.bulk. Each
// thread takes one window x 4 channels of a strip from shared memory
// (n * F/4 <= 512 threads; 16 threads' reads of a cell are one contiguous
// span), writes its cells of dzt as vectors, and keeps its channels' S and
// T in registers. The CTA sums its threads in window order into a row; the
// last CTA to arrive sums the rows in row order.
#include <algorithm>

#include "stream_sums.cuh"
#include "train_common.cuh"

namespace unet {
namespace {

template <typename T>
__host__ __device__ constexpr int vec_len() { return 16 / (int)sizeof(T); }

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[V]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = from_f<T>(in[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ size_t cell_offset(int b, int py, int px, int cell, int H, int W,
                                              int F, int f0) {
  return (((size_t)b * H + 2 * py + (cell >> 1)) * W + 2 * px + (cell & 1)) * F + f0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tail_pool_kernel(const T* __restrict__ y, const float* __restrict__ aff, T* __restrict__ z,
                     T* __restrict__ pooled, int B, int H, int W, int F) {
  constexpr int V = vec_len<T>();
  const int G = F / V, H2 = H / 2, W2 = W / 2;
  const long long total = (long long)B * H2 * W2 * G;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int f0 = (int)(i % G) * V;
    const long long q = i / G;  // pooled pixel, ((b*H2 + py)*W2 + px)
    const int px = (int)(q % W2), py = (int)((q / W2) % H2), b = (int)(q / ((long long)W2 * H2));
    float a[V], sh[V], mx[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = aff[f0 + j];
      sh[j] = aff[F + f0 + j];
    }
#pragma unroll
    for (int cell = 0; cell < 4; ++cell) {
      const size_t off = cell_offset(b, py, px, cell, H, W, F, f0);
      float v[V];
      load_vec<T, V>(y + off, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[j] = round_to<T>(fmaxf(affine_rn(v[j], a[j], sh[j]), 0.f));
        mx[j] = cell ? fmaxf(mx[j], v[j]) : v[j];
      }
      store_vec<T, V>(z + off, v);
    }
    store_vec<T, V>(pooled + q * F + f0, mx);
  }
}

// A K4 thread's channels: 4 (16 bytes of fp32, 8 of bf16), so that in both
// dtypes a thread's registers fit the 128 of 512 threads an SM.
constexpr int kPoolCh = 4;

// kPoolCh channels of T, packed
template <typename T>
struct Pack4 {
  using type = uint2;
};
template <>
struct Pack4<float> {
  using type = uint4;
};

// K4's work unit, a strip: n windows of one pooled row (the last strip of
// a row may be shorter), so its inputs are five contiguous spans: the
// strip's two image rows of y and of gs (2n pixels each) and n pixels of
// gp. A stage holds them in that order at the full strip's offsets.
template <typename T>
struct PoolBwdOp {
  static constexpr int V = kPoolCh;
  using P = typename Pack4<T>::type;
  const T* y;
  const T* gs;
  const T* gp;
  T* dzt;
  int W, F, W2, n, strips;  // strips: per pooled row
  float a[V], sh[V], mean[V], rstd[V], s[V], t[V];
  int g, j;                 // this thread's channel group and window
  bool act;

  // the strip's first pixel in y's row 2py, its first window and windows
  __device__ size_t first_px(long long unit, int& px0, int& nw) const {
    const long long r = unit / strips;  // b * H2 + py
    px0 = (int)(unit % strips) * n;
    nw = min(n, W2 - px0);
    return (size_t)(2 * r) * W + 2 * px0;
  }

  __device__ void load(long long unit, char* stage, uint64_t* bar) const {
    int px0, nw;
    const size_t p0 = first_px(unit, px0, nw);
    const size_t q0 = (size_t)(unit / strips) * W2 + px0;
    const uint32_t row = (uint32_t)(2 * nw * F * sizeof(T));
    const uint32_t pool = (uint32_t)(nw * F * sizeof(T));
    mbar_expect_tx(bar, 4 * row + pool);
    T* st = reinterpret_cast<T*>(stage);
    const size_t span = (size_t)2 * n * F;
    bulk_load(st, y + p0 * F, row, bar);
    bulk_load(st + span, y + (p0 + W) * F, row, bar);
    bulk_load(st + 2 * span, gs + p0 * F, row, bar);
    bulk_load(st + 3 * span, gs + (p0 + W) * F, row, bar);
    bulk_load(st + 4 * span, gp + q0 * F, pool, bar);
  }

  // The window's four cells of y and gs stay packed and are unpacked one
  // channel at a time, so a thread holds no [4][V] arrays of floats.
  __device__ void consume(long long unit, const char* stage) {
    int px0, nw;
    const size_t p0 = first_px(unit, px0, nw);
    if (!act || j >= nw) return;
    const T* st = reinterpret_cast<const T*>(stage);
    const size_t span = (size_t)2 * n * F;
    const int f0 = g * V;
    P yr[4], gr[4], out[4];
#pragma unroll
    for (int cell = 0; cell < 4; ++cell) {
      const size_t at = (cell >> 1) * span + (size_t)(2 * j + (cell & 1)) * F + f0;
      yr[cell] = *reinterpret_cast<const P*>(st + at);
      gr[cell] = *reinterpret_cast<const P*>(st + 2 * span + at);
    }
    const P pr = *reinterpret_cast<const P*>(st + 4 * span + (size_t)j * F + f0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float yv[4], wl[4], zc[4];
#pragma unroll
      for (int cell = 0; cell < 4; ++cell) {
        yv[cell] = to_f(reinterpret_cast<const T*>(&yr[cell])[k]);
        wl[cell] = affine_rn(yv[cell], a[k], sh[k]);
        zc[cell] = round_to<T>(fmaxf(wl[cell], 0.f));
      }
      const bool first[4] = {zc[0] >= zc[1] && zc[0] >= zc[2] && zc[0] >= zc[3],
                             zc[1] > zc[0] && zc[1] >= zc[2] && zc[1] >= zc[3],
                             zc[2] > zc[0] && zc[2] > zc[1] && zc[2] >= zc[3],
                             zc[3] > zc[0] && zc[3] > zc[1] && zc[3] > zc[2]};
      const float gpk = to_f(reinterpret_cast<const T*>(&pr)[k]);
#pragma unroll
      for (int cell = 0; cell < 4; ++cell) {
        const float gsk = to_f(reinterpret_cast<const T*>(&gr[cell])[k]);
        const float gz = gsk + (first[cell] ? gpk : 0.f);
        const float d = wl[cell] > 0.f ? gz : 0.f;
        s[k] += d;
        t[k] += d * ((yv[cell] - mean[k]) * rstd[k]);
        reinterpret_cast<T*>(&out[cell])[k] = from_f<T>(d);
      }
    }
#pragma unroll
    for (int cell = 0; cell < 4; ++cell)
      *reinterpret_cast<P*>(dzt + (p0 + (size_t)(cell >> 1) * W + 2 * j + (cell & 1)) * F + f0) =
          out[cell];
  }
};

// Shared memory of K4 with strips of n windows: the ring, or after it the
// threads' S and T (2 kPoolCh floats each).
template <typename T>
__host__ __device__ constexpr long long pool_bwd_smem(int n, int F) {
  return stream_smem(9LL * n * F * (long long)sizeof(T),
                     (long long)kStreamThreads * 2 * kPoolCh * 4);
}

// partials[blockIdx.x]: the CTA's S (F) | T (F); the last CTA to arrive sums
// the rows into st (2F).
template <typename T>
__global__ void __launch_bounds__(kStreamThreads, 1)
    tail_pool_bwd_kernel(const T* __restrict__ y, const T* __restrict__ gs,
                         const T* __restrict__ gp, const float* __restrict__ aff4,
                         T* __restrict__ dzt, float* __restrict__ partials,
                         float* __restrict__ st, unsigned* counter, int B, int H, int W, int F,
                         int n) {
  extern __shared__ __align__(128) char smem[];
  constexpr int V = kPoolCh;
  const int G = F / V;
  PoolBwdOp<T> op;
  op.y = y;
  op.gs = gs;
  op.gp = gp;
  op.dzt = dzt;
  op.W = W;
  op.F = F;
  op.W2 = W / 2;
  op.n = n;
  op.strips = (W / 2 + n - 1) / n;
  op.g = threadIdx.x % G;
  op.j = threadIdx.x / G;
  op.act = op.j < n;
  const int f0 = op.g * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    op.a[k] = aff4[f0 + k];
    op.sh[k] = aff4[F + f0 + k];
    op.mean[k] = aff4[2 * F + f0 + k];
    op.rstd[k] = aff4[3 * F + f0 + k];
    op.s[k] = 0.f;
    op.t[k] = 0.f;
  }
  long long begin, end;
  unit_range((long long)B * (H / 2) * op.strips, gridDim.x, blockIdx.x, begin, end);
  stream_units(op, smem, 9LL * n * F * sizeof(T), begin, end);

  // the CTA's S and T: channel f sums its n windows' threads in window order
  float* red = reinterpret_cast<float*>(smem + kStreamBarBytes);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    red[threadIdx.x * 2 * V + k] = op.s[k];
    red[threadIdx.x * 2 * V + V + k] = op.t[k];
  }
  __syncthreads();
  float* row = partials + (size_t)blockIdx.x * 2 * F;
  for (int c = threadIdx.x; c < 2 * F; c += kStreamThreads) {
    const int f = c % F, part = c / F;
    const float* col = red + (f / V) * 2 * V + part * V + f % V;
    float acc = 0.f;
    for (int w = 0; w < n; ++w) acc += col[(size_t)w * G * 2 * V];
    row[c] = acc;
  }
  last_cta_sums(partials, 2 * F, 2 * F, st, counter,
                reinterpret_cast<float4*>(smem + kStreamBarBytes));
}

template <typename T>
int launch_fwd(const void* y, const void* aff, void* z, void* pooled, int B, int H, int W,
               int F, cudaStream_t stream) {
  const long long total = (long long)B * (H / 2) * (W / 2) * (F / vec_len<T>());
  const int blocks = (int)std::min(132LL * 16, (total + kThreads - 1) / kThreads);
  tail_pool_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(aff), static_cast<T*>(z),
      static_cast<T*>(pooled), B, H, W, F);
  return (int)cudaGetLastError();
}

// K4 with the plan (n windows a strip, ctas, smem): the C entry refuses a
// plan whose shared-memory bytes differ from pool_bwd_smem's.
template <typename T>
int launch_bwd(const void* y, const void* gs, const void* gp, const void* aff4, void* dzt,
               float* work, float* st, unsigned* counter, int B, int H, int W, int F, int n,
               int ctas, int smem, cudaStream_t stream) {
  const int G = F / kPoolCh;
  const long long units = (long long)B * (H / 2) * ((W / 2 + n - 1) / n);
  if (F % vec_len<T>() || n < 1 || n > W / 2 || (long long)n * G > kStreamThreads ||
      ctas < 1 || ctas > units || smem != pool_bwd_smem<T>(n, F))
    return (int)cudaErrorInvalidValue;
  const int err = (int)cudaFuncSetAttribute(tail_pool_bwd_kernel<T>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  tail_pool_bwd_kernel<T><<<ctas, kStreamThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(gs), static_cast<const T*>(gp),
      static_cast<const float*>(aff4), static_cast<T*>(dzt), work, st, counter, B, H, W, F, n);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace unet

// y, z (B,H,W,F), pooled (B,H/2,W/2,F) in T; aff (2,F) fp32 = a, b.
// H, W even; F a multiple of 16/sizeof(T). Returns cudaGetLastError().
extern "C" int unet_tail_pool(const void* y, const void* aff, void* z, void* pooled, int B,
                              int H, int W, int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return unet::launch_fwd<float>(y, aff, z, pooled, B, H, W, F, s);
  if (dtype == 1) return unet::launch_fwd<__nv_bfloat16>(y, aff, z, pooled, B, H, W, F, s);
  return (int)cudaErrorInvalidValue;
}

// y, gs, dzt (B,H,W,F) and gp (B,H/2,W/2,F) in T, 16-byte aligned; aff4
// (4,F) fp32 = a, b, mean, rstd; st (2,F) fp32 = S, T; work (ctas, 2F) fp32
// rows; counter an unsigned int that is 0 and is left 0; the plan of
// ops/fused_train.pool_bwd_plan: n windows a strip, ctas, smem bytes.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan the
// kernel does not lay out so.
extern "C" int unet_tail_pool_bwd(const void* y, const void* gs, const void* gp,
                                  const void* aff4, void* dzt, void* work, void* st,
                                  void* counter, int B, int H, int W, int F, int n, int ctas,
                                  int smem, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(st);
  unsigned* c = static_cast<unsigned*>(counter);
  if (dtype == 0)
    return unet::launch_bwd<float>(y, gs, gp, aff4, dzt, w, o, c, B, H, W, F, n, ctas, smem, s);
  if (dtype == 1)
    return unet::launch_bwd<__nv_bfloat16>(y, gs, gp, aff4, dzt, w, o, c, B, H, W, F, n, ctas,
                                           smem, s);
  return (int)cudaErrorInvalidValue;
}
