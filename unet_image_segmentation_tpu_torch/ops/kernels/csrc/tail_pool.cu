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
// of flops each.
//
// Design: one thread per (2x2 window, 16-byte channel group), so every load
// and store is one 16-byte vector along F (4 fp32 or 8 bf16 channels) and
// a warp's accesses to one pixel are contiguous. K3 is a grid-stride loop.
// In K4 each thread keeps its channels' S and T in registers over a fixed
// set of windows; a block sums its threads in a fixed order into a row of a
// [blocks][2F] matrix that reduce_rows() sums in a fixed order.
#include <algorithm>

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tail_pool_bwd_kernel(const T* __restrict__ y, const T* __restrict__ gs,
                         const T* __restrict__ gp, const float* __restrict__ aff4,
                         T* __restrict__ dzt, float* __restrict__ partials, int B, int H, int W,
                         int F) {
  constexpr int V = vec_len<T>();
  __shared__ float red[kThreads * 2 * V];
  const int G = F / V, R = kThreads / G;
  const int lane = threadIdx.x % G, r = threadIdx.x / G;
  const int f0 = lane * V;
  const int H2 = H / 2, W2 = W / 2;
  const long long P2 = (long long)B * H2 * W2;
  float s[V] = {}, t[V] = {};
  if (r < R) {
    float a[V], sh[V], mean[V], rstd[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = aff4[f0 + j];
      sh[j] = aff4[F + f0 + j];
      mean[j] = aff4[2 * F + f0 + j];
      rstd[j] = aff4[3 * F + f0 + j];
    }
    for (long long q = (long long)blockIdx.x * R + r; q < P2; q += (long long)gridDim.x * R) {
      const int px = (int)(q % W2), py = (int)((q / W2) % H2), b = (int)(q / ((long long)W2 * H2));
      float gpv[V], yv[4][V], wl[4][V], zc[4][V];
      load_vec<T, V>(gp + q * F + f0, gpv);
#pragma unroll
      for (int cell = 0; cell < 4; ++cell) {
        load_vec<T, V>(y + cell_offset(b, py, px, cell, H, W, F, f0), yv[cell]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          wl[cell][j] = affine_rn(yv[cell][j], a[j], sh[j]);
          zc[cell][j] = round_to<T>(fmaxf(wl[cell][j], 0.f));
        }
      }
#pragma unroll
      for (int cell = 0; cell < 4; ++cell) {
        const size_t off = cell_offset(b, py, px, cell, H, W, F, f0);
        float d[V];
        load_vec<T, V>(gs + off, d);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float a00 = zc[0][j], a01 = zc[1][j], a10 = zc[2][j], a11 = zc[3][j];
          bool first;
          if (cell == 0) first = a00 >= a01 && a00 >= a10 && a00 >= a11;
          else if (cell == 1) first = a01 > a00 && a01 >= a10 && a01 >= a11;
          else if (cell == 2) first = a10 > a00 && a10 > a01 && a10 >= a11;
          else first = a11 > a00 && a11 > a01 && a11 > a10;
          const float gz = d[j] + (first ? gpv[j] : 0.f);
          d[j] = wl[cell][j] > 0.f ? gz : 0.f;
          s[j] += d[j];
          t[j] += d[j] * ((yv[cell][j] - mean[j]) * rstd[j]);
        }
        store_vec<T, V>(dzt + off, d);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[threadIdx.x * 2 * V + j] = s[j];
    red[threadIdx.x * 2 * V + V + j] = t[j];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float* row = partials + (size_t)blockIdx.x * 2 * F;
    for (int j = 0; j < 2 * V; ++j) {
      float acc = 0.f;
      for (int rr = 0; rr < R; ++rr) acc += red[(rr * G + threadIdx.x) * 2 * V + j];
      row[j < V ? f0 + j : F + f0 + (j - V)] = acc;
    }
  }
}

constexpr long long kMaxBlocks = 132 * 4;  // K4: a fixed grid, fixed window assignment

long long bwd_blocks(int B, int H, int W, int F, int elem) {
  const int G = F / (16 / elem), R = kThreads / G;
  const long long p2 = (long long)B * (H / 2) * (W / 2);
  return std::min(kMaxBlocks, (p2 + R - 1) / R);
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

template <typename T>
int launch_bwd(const void* y, const void* gs, const void* gp, const void* aff4, void* dzt,
               float* work, float* st, int B, int H, int W, int F, cudaStream_t stream) {
  const long long blocks = bwd_blocks(B, H, W, F, (int)sizeof(T));
  float* scratch = work + blocks * 2 * F;
  tail_pool_bwd_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(gs), static_cast<const T*>(gp),
      static_cast<const float*>(aff4), static_cast<T*>(dzt), work, B, H, W, F);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_rows(work, (int)blocks, 2 * F, scratch, st, stream);
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

// Floats of workspace unet_tail_pool_bwd needs.
extern "C" long long unet_tail_pool_bwd_workspace(int B, int H, int W, int F, int dtype) {
  const long long blocks = unet::bwd_blocks(B, H, W, F, dtype == 0 ? 4 : 2);
  return blocks * 2 * F + unet::reduce_scratch_floats(blocks, 2LL * F);
}

// y, gs, dzt (B,H,W,F) and gp (B,H/2,W/2,F) in T; aff4 (4,F) fp32 = a, b,
// mean, rstd; st (2,F) fp32 = S, T. Returns cudaGetLastError().
extern "C" int unet_tail_pool_bwd(const void* y, const void* gs, const void* gp,
                                  const void* aff4, void* dzt, void* work, void* st, int B,
                                  int H, int W, int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(st);
  if (dtype == 0) return unet::launch_bwd<float>(y, gs, gp, aff4, dzt, w, o, B, H, W, F, s);
  if (dtype == 1)
    return unet::launch_bwd<__nv_bfloat16>(y, gs, gp, aff4, dzt, w, o, B, H, W, F, s);
  return (int)cudaErrorInvalidValue;
}
