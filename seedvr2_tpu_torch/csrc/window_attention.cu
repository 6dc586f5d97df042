// Plain C entry point of K3 / K3q (window_attention.cuh); see conv3d.cu for
// the conventions every entry follows.
#include "window_attention.cuh"

using namespace seedvr2;

extern "C" {

int seedvr2_window_attention(const void* vqkv, const void* tqkv, const void* vcos,
                             const void* vsin, const void* tcos, const void* tsin,
                             const void* valid, const void* norms, void* ovid, void* otxt, int B,
                             int H, int nW, int S, int Lt, int rope_txt, int qk_norm, int quant_qk,
                             float eps, float scale, void* stream) {
  // above 48 KB of dynamic shared memory needs an opt-in (per device, so per call)
  const auto kernel = quant_qk ? attn::attention_kernel<attn::WindowPolicy<true>>
                               : attn::attention_kernel<attn::WindowPolicy<false>>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, attn::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  AttnArgs a;
  a.vqkv = (const bf16*)vqkv;
  a.tqkv = (const bf16*)tqkv;
  a.vcos = (const float*)vcos;
  a.vsin = (const float*)vsin;
  a.tcos = (const float*)tcos;
  a.tsin = (const float*)tsin;
  a.valid = (const uint8_t*)valid;
  a.norms = (const float*)norms;
  a.ovid = (bf16*)ovid;
  a.otxt = (bf16*)otxt;
  a.H = H;
  a.nW = nW;
  a.S = S;
  a.Lt = Lt;
  a.rope_txt = rope_txt;
  a.qk_norm = qk_norm;
  a.eps = eps;
  a.scale = scale;
  const dim3 grid((S + Lt + attn::kBM - 1) / attn::kBM, nW * H, B);
  kernel<<<grid, attn::kThreads, attn::kSmemBytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
