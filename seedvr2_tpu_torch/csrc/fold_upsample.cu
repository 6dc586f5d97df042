// Plain C entry point of K2 (fold_upsample.cuh); see conv3d.cu for the
// conventions every entry follows.
#include "fold_upsample.cuh"

using namespace seedvr2;

extern "C" {

// C % 64 == 0.
int seedvr2_fold_upsample(const void* x, const void* K, const void* btab, const void* bc, void* y,
                          int B, int Tp, int kt, int A, int H, int W, int C, void* stream) {
  using L = FoldPolicy::L;
  const auto kernel = conv::conv_kernel<FoldPolicy>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const FoldArgs a{(const bf16*)x, (const bf16*)K, (const float*)btab, (const float*)bc, (bf16*)y,
                   Tp, kt, A, H, W, C};
  const dim3 grid(((H + conv::kPH - 1) / conv::kPH) * ((W + conv::kPW - 1) / conv::kPW) * B * Tp * A * (C / 32));
  kernel<<<grid, conv::kThreads, L::kSmemBytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
