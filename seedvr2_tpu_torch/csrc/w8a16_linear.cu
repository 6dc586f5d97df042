// Plain C entry point of K7 (w8a16_linear.cuh); see conv3d.cu for the
// conventions every entry follows.
#include "w8a16_linear.cuh"

using namespace seedvr2;

extern "C" {

// N % 64 == 0, K % 64 == 0, 0 < M <= 128 * 65535; bias may be null.
int seedvr2_w8a16_linear(const void* x, const void* w, const void* scale, const void* bias, void* y, int M, int N,
                         int K, void* stream) {
  const w8a16::Args a{(const bf16*)x, (const int8_t*)w, (const float*)scale, (const bf16*)bias, (bf16*)y, M, N, K};
  return w8a16::launch(a, (cudaStream_t)stream);
}

}  // extern "C"
