// Plain C entry point of K5 (flash_attention.cuh); see conv3d.cu for the
// conventions every entry follows.
#include "flash_attention.cuh"

using namespace seedvr2;

extern "C" {

int seedvr2_flash_attention(const void* q, const void* k, const void* v, const void* kv_valid,
                            const void* q_valid, void* o, int B, int S, int H, int n_pad,
                            float scale, void* stream) {
  const auto kernel = attn::attention_kernel<attn::FlashPolicy>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, attn::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  FlashArgs a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.kv_valid = (const uint8_t*)kv_valid;
  a.q_valid = (const uint8_t*)q_valid;
  a.o = (bf16*)o;
  a.S = S;
  a.H = H;
  a.n_pad = n_pad;
  a.scale = scale;
  const dim3 grid((S + attn::kBM - 1) / attn::kBM, H, B);
  kernel<<<grid, attn::kThreads, attn::kSmemBytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
