// Plain C entry points of K2 (fold_upsample.cuh on conv_pipeline.cuh); see
// conv3d.cu for the conventions every entry follows.
#include "fold_upsample.cuh"

using namespace seedvr2;

extern "C" {

// x [B, Tp+kt-1, H, W, C], K [kt, 2, 2, C, A*4*C] bf16, 16-byte aligned;
// btab [2, 2, A*4*C], bc [C] fp32. kt in 1..3, A in 1..2, C % 64 == 0.
int seedvr2_fold_upsample(const void* x, const void* K, const void* btab, const void* bc, void* y, int B, int Tp,
                          int kt, int A, int H, int W, int C, void* stream) {
  if (B < 1 || Tp < 1 || H < 1 || W < 1 || kt < 1 || kt > 3 || A < 1 || A > 2 || C < 1 || C % conv::kBK != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(K)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int err = 0;
  FoldPolicy p;
  p.tiles_n = (C + conv::kBN - 1) / conv::kBN;
  p.g = conv::geometry(H, W, C, (long)B * Tp, 4L * A * p.tiles_n, &err);
  if (err != 0) return err;
  p.Tp = Tp;
  p.kt = kt;
  p.A = A;
  p.P = A * 4 * C;
  p.btab = (const float*)btab;
  p.bc = (const float*)bc;
  p.y = (bf16*)y;
  return conv::launch(p, x, B, Tp + kt - 1, K, 4L * kt * C, p.P, (cudaStream_t)stream);
}

// What the runtime holds for K2's kernel: registers a thread, local memory
// (spills) a thread, and the dynamic shared memory it launches with.
int seedvr2_fold_upsample_attributes(int* regs, int* local_bytes, int* smem_bytes) {
  return conv::attributes<FoldPolicy>(regs, local_bytes, smem_bytes);
}

}  // extern "C"
