// Plain C entry points of K1 / K4 (conv3d.cuh) and the error-string helper
// of the kernel library. Every .cu file of csrc/ is one translation unit,
// compiled on its own (in parallel) and linked into one shared library that
// ops/cuda_lib.py loads with ctypes. Each entry launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() right after the
// launch so a refused launch is reported to the caller.
#include "conv3d.cuh"

using namespace seedvr2;

extern "C" {

const char* seedvr2_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// scale == shift == nullptr: K1; both given: K4 (GroupNorm + SiLU prologue).
int seedvr2_conv3d_3x3x3(const void* x, const void* w, const void* bias, const void* scale,
                         const void* shift, void* y, int B, int T, int H, int W, int cin, int cout,
                         void* stream) {
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), cout / kBN, B * T);
  const auto kernel = scale != nullptr ? conv3d_3x3x3_kernel<true> : conv3d_3x3x3_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const bf16*)x, (const bf16*)w,
                                                      (const float*)bias, (const float*)scale,
                                                      (const float*)shift, (bf16*)y, T, H, W, cin,
                                                      cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
