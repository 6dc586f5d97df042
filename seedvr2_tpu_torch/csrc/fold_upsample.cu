// Plain C entry point of K2 (fold_upsample.cuh); see conv3d.cu for the
// conventions every entry follows.
#include "fold_upsample.cuh"

using namespace seedvr2;

extern "C" {

int seedvr2_fold_upsample(const void* x, const void* K, const void* btab, const void* bc, void* y,
                          int B, int Tp, int kt, int A, int H, int W, int C, void* stream) {
  const dim3 grid((H * W + kBM - 1) / kBM, C / kBN, B * Tp * A * 4);
  fold_upsample_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)K, (const float*)btab, (const float*)bc, (bf16*)y, Tp, kt, A, H,
      W, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
