// Plain C entry points of K1 / K4 (conv3d.cuh) and the error-string helper
// of the kernel library. Every .cu file of csrc/ is one translation unit,
// compiled on its own (in parallel) and linked into one shared library that
// ops/cuda_lib.py loads with ctypes. Each entry launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() right after the
// launch so a refused launch is reported to the caller.
#include "conv3d.cuh"

using namespace seedvr2;

namespace {

template <bool kGn>
int launch(const Conv3dArgs& a, int B, cudaStream_t stream) {
  using P = Conv3dPolicy<kGn>;
  const auto kernel = conv::conv_kernel<P>;
  // above 48 KB of dynamic shared memory needs an opt-in (per device, so per call)
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::L::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.H + conv::kPH - 1) / conv::kPH) * ((a.W + conv::kPW - 1) / conv::kPW) * B * a.T *
                  (a.cout / conv::kBN));
  kernel<<<grid, conv::kThreads, P::L::kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* seedvr2_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// scale == shift == nullptr: K1; both given: K4 (GroupNorm + SiLU prologue).
// cin % 32 == 0, cout % 128 == 0.
int seedvr2_conv3d_3x3x3(const void* x, const void* w, const void* bias, const void* scale,
                         const void* shift, void* y, int B, int T, int H, int W, int cin, int cout,
                         void* stream) {
  const Conv3dArgs a{(const bf16*)x, (const bf16*)w, (const float*)bias, (const float*)scale,
                     (const float*)shift, (bf16*)y, T, H, W, cin, cout};
  return scale != nullptr ? launch<true>(a, B, (cudaStream_t)stream)
                          : launch<false>(a, B, (cudaStream_t)stream);
}

}  // extern "C"
