// Plain C entry point of K8 (gn_stats.cuh); see conv3d.cu for the
// conventions every entry follows.
#include "gn_stats.cuh"

using namespace seedvr2;

extern "C" {

// x [frames, P, C] bf16 (16-byte aligned), gw / gb [C] fp32 (w_bf16 == 0) or
// bf16, part [frames, chunks, G] float2 scratch (chunks = ceil(P / (ppb *
// steps))), scale / shift [frames, C] fp32. C % 8 == 0, (C / G) % 4 == 0,
// ppb * C / 8 <= 1024 threads a block.
int seedvr2_gn_stats(const void* x, const void* gw, const void* gb, void* part, void* scale, void* shift, int frames,
                     int P, int C, int G, int ppb, int steps, int w_bf16, float eps, void* stream) {
  if (frames < 1 || frames > 65535 || P < 1 || C < 8 || C % 8 != 0 || G < 1 || C % G != 0 || (C / G) % 4 != 0 ||
      ppb < 1 || steps < 1 || (long)ppb * (C / 8) > gnstats::kMaxThreads || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long chunk_px = (long)ppb * steps;
  const long chunks = (P + chunk_px - 1) / chunk_px;
  const cudaStream_t s = (cudaStream_t)stream;
  gnstats::gn_partials_kernel<<<dim3((unsigned)chunks, frames), ppb * (C / 8), 0, s>>>(
      (const bf16*)x, (float2*)part, P, C, G, ppb, steps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long warps = (long)frames * G;
  const unsigned blocks = (unsigned)((warps + 7) / 8);
  if (w_bf16)
    gnstats::gn_tables_kernel<bf16><<<blocks, 256, 0, s>>>((const float2*)part, (const bf16*)gw, (const bf16*)gb,
                                                          (float*)scale, (float*)shift, frames, P, C, G, (int)chunks,
                                                          chunk_px, eps);
  else
    gnstats::gn_tables_kernel<float><<<blocks, 256, 0, s>>>((const float2*)part, (const float*)gw, (const float*)gb,
                                                           (float*)scale, (float*)shift, frames, P, C, G, (int)chunks,
                                                           chunk_px, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
