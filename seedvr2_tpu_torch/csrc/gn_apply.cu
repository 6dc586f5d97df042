// Plain C entry point of K9 (gn_apply.cuh); see conv3d.cu for the
// conventions every entry follows.
#include "gn_apply.cuh"

using namespace seedvr2;

extern "C" {

// x, y [frames, P, C] bf16, scale / shift [frames, C] fp32, all 16-byte
// aligned; C % 8 == 0, ppb * C / 8 <= 1024 threads a block. silu != 0 runs
// the SiLU after the normalisation.
int seedvr2_gn_apply(const void* x, const void* scale, const void* shift, void* y, int frames, int P, int C, int ppb,
                     int steps, int silu, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                          reinterpret_cast<uintptr_t>(shift) | reinterpret_cast<uintptr_t>(y);
  if (frames < 1 || frames > 65535 || P < 1 || C < 8 || C % 8 != 0 || ppb < 1 || steps < 1 ||
      (long)ppb * (C / 8) > gnapply::kMaxThreads || align % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long chunk_px = (long)ppb * steps;
  const long chunks = (P + chunk_px - 1) / chunk_px;
  const dim3 grid((unsigned)chunks, frames);
  const int threads = ppb * (C / 8);
  const cudaStream_t s = (cudaStream_t)stream;
  if (silu)
    gnapply::gn_apply_kernel<true><<<grid, threads, 0, s>>>((const bf16*)x, (const float*)scale, (const float*)shift,
                                                            (bf16*)y, P, C, ppb, steps);
  else
    gnapply::gn_apply_kernel<false><<<grid, threads, 0, s>>>((const bf16*)x, (const float*)scale,
                                                             (const float*)shift, (bf16*)y, P, C, ppb, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
