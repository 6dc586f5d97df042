// Plain C entry point of K6 (conv3d_im2col.cuh); see conv3d.cu for the
// conventions every entry follows.
#include "conv3d_im2col.cuh"

using namespace seedvr2;

extern "C" {

int seedvr2_conv3d_im2col(const void* x, const void* wf, const void* bias, void* y, int B, int T,
                          int H, int W, int cin, int cout, void* stream) {
  const dim3 grid((H * W + kBM - 1) / kBM, cout / kBN, B * T);
  conv3d_im2col_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)wf, (const float*)bias, (bf16*)y, T, H, W, cin, cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
