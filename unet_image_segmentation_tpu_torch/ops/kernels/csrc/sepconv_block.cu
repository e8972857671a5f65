// K8: one inference sepconv block, y = relu?((dw3x3(x) -> T) . pw * scale + shift).
//
// Replaces the TPU kernel unet_image_segmentation_tpu/ops/pallas/fused_sepconv.py
// :_sepconv_kernel_db (launched by _fused_sepconv_fwd_impl, entered through
// fused_sepconv_bn_relu). Semantics kept: 'same' zero padding; the depthwise
// sum in fp32, rounded to the compute dtype T before the pointwise; the
// pointwise accumulated in fp32; scale/shift in fp32 (BatchNorm folded by the
// wrapper), the product and the sum each rounded as the plain version
// computes them; the output in T.
//
// What bounds it on the H100: per pixel 9C + C*F multiply-adds for C + F
// elements moved. With the products on the tensor cores the bytes bound
// every block of the U-Net in bf16 and its 256 px blocks in fp32
// (sepconv_fwd.cuh).
//
// Design: the forward body of sepconv_fwd.cuh (a thread-block cluster per
// 8x8 tile over slices of F, staged x, the depthwise once per tile through
// distributed shared memory, the products on mma.sync: bf16 m16n8k16, fp32
// 3xTF32) with this epilogue: each thread applies scale and shift to its
// accumulator fragments and the ReLU where asked, and store_tile writes its
// column pairs in T.
#include "sepconv_fwd.cuh"

namespace unet {
namespace {

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2)
    sepconv_block_kernel(const FwdArgs<T> a, const float* __restrict__ scale,
                         const float* __restrict__ shift, T* __restrict__ out, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = W / 32;
  const int wn = (threadIdx.x >> 5) & 3, tq = threadIdx.x & 3;
  auto epilogue = [&](float (&acc)[2][NT][4], const FwdTile& t) {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int col = wn * 8 * NT + ni * 8 + 2 * tq;
      float sc[2], sf[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const bool ok = col + jj < t.len;
        sc[jj] = ok ? scale[t.f0 + col + jj] : 0.f;
        sf[jj] = ok ? shift[t.f0 + col + jj] : 0.f;
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = __fadd_rn(__fmul_rn(acc[mi][ni][e], sc[e & 1]), sf[e & 1]);
          acc[mi][ni][e] = relu ? fmaxf(v, 0.f) : v;
        }
    }
    store_tile<T, W>(a, acc, t, out);
  };
  sepconv_fwd_tiles<T, W, false>(a, smem, [](T*, int, int, const FwdTile&) {}, epilogue);
}

template <typename T>
int launch(const void* x, const void* dw, const void* pw, const void* scale, const void* shift,
           void* out, int B, int H, int W, int C, int F, int relu, int n, int s, int width,
           int per, int smem, cudaStream_t stream) {
  if (!fwd_plan_ok<T>(B, H, W, C, F, n, s, width, per, smem)) return (int)cudaErrorInvalidValue;
  const FwdArgs<T> a = fwd_args<T>(x, dw, pw, B, H, W, C, F, n, s, per);
  const float* sc = static_cast<const float*>(scale);
  const float* sf = static_cast<const float*>(shift);
  T* o = static_cast<T*>(out);
  auto kernel = width == 64 ? sepconv_block_kernel<T, 64> : sepconv_block_kernel<T, 128>;
  return launch_fwd(kernel, a, smem, stream, sc, sf, o, relu);
}

}  // namespace
}  // namespace unet

// (n, s, width, per, smem) is the launch plan of fwd_plan
// (ops/fused_train.py): n CTAs a cluster, F slices of s channels, the GEMM
// width 64 or 128, per tiles a cluster, the dynamic shared memory in bytes
// (checked against sepconv_fwd.cuh's layout).
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch.
extern "C" int unet_sepconv_block(const void* x, const void* dw, const void* pw,
                                  const void* scale, const void* shift, void* out, int B, int H,
                                  int W, int C, int F, int relu, int n, int s, int width,
                                  int per, int smem, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return unet::launch<float>(x, dw, pw, scale, shift, out, B, H, W, C, F, relu, n, s, width,
                               per, smem, st);
  if (dtype == 1)
    return unet::launch<__nv_bfloat16>(x, dw, pw, scale, shift, out, B, H, W, C, F, relu, n, s,
                                       width, per, smem, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* unet_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
