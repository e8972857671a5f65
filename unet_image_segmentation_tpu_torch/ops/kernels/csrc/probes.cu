// K12: the card's two probes, the launch overhead and the FMA rate.
//
// Replaces the TPU kernels of unet_image_segmentation_tpu/troubleshoot/
// link_floors.py: the body of measure_dispatch_ms (:56, pallas_call at :61),
// o = x + 1 on an (8, 128) fp32 block, and the body of measure_vpu_rate
// (:87-93, pallas_call at :97), K dependent steps acc = acc * one_eps + x
// per element with acc resident, one_eps = 1.000001 rounded to the dtype.
//
// dispatch_probe_kernel (K12a) does nothing worth measuring: 4 KiB in, 4 KiB
// out, ~2.4 ns of device memory time on the H100. Timed back to back it
// gives the device time of one launch, and with a synchronise after each
// launch the host's cost of one launch-and-wait.
//
// fma_probe_*_kernel (K12b) is bound by operations: 2*K*N flops (one fused
// multiply-add per element per step) on N elements it reads and writes once.
// fp32 runs one fmaf per element per step (67 TFLOP/s on the CUDA cores);
// bf16 one __hfma2 per pair of elements per step (133.8 TFLOP/s), which
// rounds every step as the plain version's separate multiply and add do
// (in bf16 one_eps rounds to 1.0, so the product is exact and the two agree
// bit for bit). K is a runtime argument, so nothing folds the loop. Each
// element's chain is dependent, so a thread keeps kIlp independent chains in
// registers (4 elements in fp32, 4 pairs in bf16) and the k loop is unrolled
// by 8: with ~8 warps a scheduler that covers the FMA latency, and the loop
// counter costs ~1/16 of the issue slots. The bf16 loop runs whole bodies of
// 8 steps with no test of k inside, then the rest. Its SASS is one native
// HFMA2.BF16_V2 a pair a step and no conversion, but the H100 issues it at
// about half the rate the 133.8 TFLOP/s bound takes: over 4M elements and
// 16384 steps, where the launch's ramp and tail weigh nothing, it sustains
// 64.8 TFLOP/s (48.4% of its bound; the fp32 kernel 85.9% of its own;
// troubleshoot/probe_sass.py), so K12b bf16 stays just under half.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace unet {
namespace {

constexpr int kProbeThreads = 256;
constexpr int kIlp = 4;

__global__ void dispatch_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                                      int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.f;
}

__global__ void __launch_bounds__(kProbeThreads)
    fma_probe_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int k,
                         float one_eps) {
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x + threadIdx.x; base < n; base += stride * kIlp) {
    float xv[kIlp], acc[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + (long long)j * stride;
      xv[j] = i < n ? x[i] : 0.f;
      acc[j] = xv[j];
    }
#pragma unroll 8
    for (int s = 0; s < k; ++s)
#pragma unroll
      for (int j = 0; j < kIlp; ++j) acc[j] = fmaf(acc[j], one_eps, xv[j]);
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + (long long)j * stride;
      if (i < n) out[i] = acc[j];
    }
  }
}

// n2 pairs of bf16 elements
__global__ void __launch_bounds__(kProbeThreads)
    fma_probe_bf16_kernel(const __nv_bfloat162* __restrict__ x, __nv_bfloat162* __restrict__ out,
                          int n2, int k, float one_eps) {
  const __nv_bfloat162 e2 = __float2bfloat162_rn(one_eps);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x + threadIdx.x; base < n2; base += stride * kIlp) {
    __nv_bfloat162 xv[kIlp], acc[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + (long long)j * stride;
      xv[j] = i < n2 ? x[i] : zero;
      acc[j] = xv[j];
    }
    int s = 0;
    for (; s + 8 <= k; s += 8)
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < kIlp; ++j) acc[j] = __hfma2(acc[j], e2, xv[j]);
    for (; s < k; ++s)
#pragma unroll
      for (int j = 0; j < kIlp; ++j) acc[j] = __hfma2(acc[j], e2, xv[j]);
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + (long long)j * stride;
      if (i < n2) out[i] = acc[j];
    }
  }
}

int grid_for(long long n) {
  const long long per_block = (long long)kProbeThreads * kIlp;
  return (int)((n + per_block - 1) / per_block);
}

}  // namespace
}  // namespace unet

// K12a: out = x + 1 over n fp32 values. Returns cudaGetLastError().
extern "C" int unet_dispatch_probe(const void* x, void* out, int n, void* stream) {
  const int blocks = (n + unet::kProbeThreads - 1) / unet::kProbeThreads;
  unet::dispatch_probe_kernel<<<blocks, unet::kProbeThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

// K12b: k steps of acc = acc * one_eps + x from acc = x over n values in the
// dtype (0 fp32, 1 bf16; bf16 takes an even n). one_eps is the dtype's
// rounding of 1.000001, passed as a float. Returns cudaGetLastError().
extern "C" int unet_fma_probe(const void* x, void* out, int n, int k, float one_eps, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    unet::fma_probe_f32_kernel<<<unet::grid_for(n), unet::kProbeThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, k, one_eps);
  } else if (dtype == 1) {
    if (n % 2) return (int)cudaErrorInvalidValue;
    unet::fma_probe_bf16_kernel<<<unet::grid_for(n / 2), unet::kProbeThreads, 0, s>>>(
        static_cast<const __nv_bfloat162*>(x), static_cast<__nv_bfloat162*>(out), n / 2, k,
        one_eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
